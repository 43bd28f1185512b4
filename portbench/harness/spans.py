"""Spans from the benchmark's own files, for the traced run only.

Wraps module attributes of the port in profiler ranges (`span`): the
coarse spans (`install`: the FMG ramp, the check and the cycle as fmg.py
sees them, the names krylov.py imports, the coarse solve) and, apart,
each public function of ops.dispatch (`install_dispatch`, with the
call's argument shapes in the span name).  A
target that is gone is listed in `missing` and its metric reads nothing.
No file of the port is edited, and a run without --trace never calls
install().
"""
from __future__ import annotations

import functools
import importlib
import inspect

import torch

PACKAGE = "multigrid_dolfinx_tpu_torch"

# (module, attribute, span label): attribute may be Class.method
TARGETS = (
    ("solver.fmg", "fmg_ramp", "fmg.fmg_ramp"),
    ("solver.fmg", "check_norm", "fmg.check_norm"),
    ("solver.fmg", "vcycle", "fmg.vcycle"),
    ("solver.krylov", "check_norm", "krylov.check_norm"),
    ("solver.krylov", "fmg_ramp", "krylov.fmg_ramp"),
    ("solver.krylov", "compute_residual", "krylov.compute_residual"),
    ("solver.krylov", "vcycle", "krylov.vcycle"),
    ("ops.coarse", "CoarseSolver.solve", "coarse.solve"),
)
DISPATCH = "ops.dispatch"
DISPATCH_PREFIX = "dispatch."
REQUEST = "request"
#: names of the benchmark's spans start with one of these
SPAN_PREFIXES = (REQUEST, "fmg.", "krylov.", "coarse.", DISPATCH_PREFIX)


def span(name: str):
    """A profiler range named `name`: torch's low-overhead form where this
    torch has it (about 0.5 us against record_function's 9), since the
    ramp's small levels are bound by the host's launches."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is not None:
        return fast(name)
    return torch.profiler.record_function(name)


class Arg:
    """What a work count may read of one call argument."""

    __slots__ = ("shape", "itemsize", "value")

    def __init__(self, shape=None, itemsize=None, value=None):
        self.shape, self.itemsize, self.value = shape, itemsize, value

    @property
    def numel(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out

    def __repr__(self):
        if self.shape is not None:
            return f"t{self.itemsize}[{','.join(map(str, self.shape))}]"
        return repr(self.value)


def describe(a):
    """An Arg (or a list of them) for one argument: tensors by shape and
    item size, ints, strings and None by value; floats are left out, so
    that one shape gives one description."""
    if isinstance(a, torch.Tensor):
        return Arg(tuple(a.shape), a.element_size())
    if isinstance(a, (list, tuple)):
        return [describe(x) for x in a]
    if isinstance(a, (bool, int, str)) or a is None:
        return Arg(value=a)
    return Arg(value=None)


class Spans:
    """Installed wrappers; `calls` maps a dispatch span's name to the
    described arguments of that call shape."""

    def __init__(self):
        self.saved = []
        self.missing = []
        self.calls = {}

    def install(self):
        """The coarse spans: TARGETS."""
        for mod, attr, label in TARGETS:
            self._wrap(mod, attr, label)
        return self

    def install_dispatch(self):
        """A span around each public function of ops.dispatch, named by
        the call's argument shapes (a few us of host work a call)."""
        disp = importlib.import_module(f"{PACKAGE}.{DISPATCH}")
        for name, fn in sorted(vars(disp).items()):
            if (name.startswith("_") or not inspect.isfunction(fn)
                    or fn.__module__ != disp.__name__):
                continue
            self._set(disp, name, self._dispatch_wrapper(name, fn))
        return self

    def uninstall(self):
        for owner, attr, old in reversed(self.saved):
            setattr(owner, attr, old)
        self.saved.clear()

    def _set(self, owner, attr, new):
        self.saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def _wrap(self, mod, attr, label):
        try:
            owner = importlib.import_module(f"{PACKAGE}.{mod}")
            parts = attr.split(".")
            for p in parts[:-1]:
                owner = getattr(owner, p)
            fn = getattr(owner, parts[-1])
        except (ImportError, AttributeError):
            self.missing.append(f"{mod}.{attr}")
            return
        if label.endswith(".vcycle"):
            wrapper = _vcycle_wrapper(label, fn)
        else:
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                with span(label):
                    return fn(*args, **kwargs)
        self._set(owner, parts[-1], wrapper)

    def _dispatch_wrapper(self, entry, fn):
        calls, names = self.calls, {}

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not args or not isinstance(args[0], torch.Tensor):
                return fn(*args, **kwargs)
            key = tuple(_key(a) for a in args) + tuple(
                (k, _key(kwargs[k])) for k in sorted(kwargs))
            name = names.get(key)
            if name is None:
                desc = [describe(a) for a in args]
                desc += [describe(kwargs[k]) for k in sorted(kwargs)]
                name = f"{DISPATCH_PREFIX}{entry}|{desc!r}"
                names[key] = name
                calls[name] = desc
            with span(name):
                return fn(*args, **kwargs)
        return wrapper


def _key(a):
    """A cheap hashable stand-in for describe(a)."""
    if isinstance(a, torch.Tensor):
        return (a.shape, a.dtype)
    if isinstance(a, (list, tuple)):
        return tuple(_key(x) for x in a)
    if isinstance(a, (bool, int, str)) or a is None:
        return a
    return None


def _vcycle_wrapper(label, fn):
    """vcycle(hier, spec, lidx, ...): the span carries the root level and
    the finest index, label[lidx/L]."""
    @functools.wraps(fn)
    def wrapper(hier, spec, lidx, *args, **kwargs):
        name = f"{label}[{lidx}/{hier.num_levels - 1}]"
        with span(name):
            return fn(hier, spec, lidx, *args, **kwargs)
    return wrapper


def dispatch_entry(span_name: str):
    """(entry, call name) of a dispatch span, or None."""
    if not span_name.startswith(DISPATCH_PREFIX):
        return None
    return span_name[len(DISPATCH_PREFIX):].split("|", 1)[0]
