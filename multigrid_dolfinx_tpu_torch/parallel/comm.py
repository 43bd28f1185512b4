"""The process-group layer of the distributed z-slab solve, and a rank
launcher.

`SlabComm` stands in for the JAX package's `ppermute`, `all_gather`,
`psum` and `axis_index` over a 1D mesh, on a `torch.distributed` process
group whose ranks hold consecutive z-slabs:

  * `halos(u, depth)`: the (lo, hi) z-slab halos of a block, one
    `batch_isend_irecv` with the ranks -1 and +1, zeros at the edges
    (`halos2`: those of v and f in one exchange);
  * `shift_slabs(x, forward)`: x moved one rank up (forward) or down;
  * `gather_z(x)`: every rank's x, concatenated along z in rank order;
  * `sum_scalar(x)`: a float sum over the ranks, the same bits on every
    rank: each rank's f64 partial is all-gathered and the partials are
    added in rank order (a backend's reduction order is not fixed).

The backend is the caller's choice and is never switched.  Gloo's
send/recv take host memory, so under gloo every CUDA tensor is staged
through a pinned host buffer explicitly; under NCCL device tensors pass
as they are.

`run_ranks` spawns one process per rank (start method 'spawn', a
`file://` store in a temporary directory), runs `fn(rank, world_size,
device, *args)` in each after `init_process_group`, and returns the
ranks' results in rank order: the counterpart of the JAX package's
virtual 8-device CPU mesh for tests and the card check.
"""
from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class SlabComm:
    """z-slab communication on a process group (the default group if
    None); rank r holds slab r."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("the distributed solve needs "
                               "torch.distributed.init_process_group first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self.staged = self.backend == "gloo"

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """t as the backend takes it: a pinned host copy of a CUDA tensor
        under gloo, else t itself (contiguous)."""
        if self.staged and t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            return buf
        return t.contiguous()

    def _empty(self, like: torch.Tensor) -> torch.Tensor:
        if self.staged and like.is_cuda:
            return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return torch.empty_like(like)

    @staticmethod
    def _back(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(like.device)

    def exchange(self, up: Optional[torch.Tensor],
                 down: Optional[torch.Tensor]) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
        """Send `up` to rank + 1 and `down` to rank - 1 in one batch; return
        (from rank - 1, from rank + 1), zeros at the edges.  Either may be
        None when that direction is not needed (its result is then
        None)."""
        ops, recv = [], {}
        for t, peer, key in ((up, self.rank + 1, "from_below"),
                             (down, self.rank - 1, "from_above")):
            if t is None:
                continue
            src = self.rank - 1 if key == "from_below" else self.rank + 1
            if 0 <= peer < self.size:
                ops.append(dist.P2POp(dist.isend, self._host(t),
                                      self._peer(peer), self.group))
            if 0 <= src < self.size:
                buf = self._empty(t)
                ops.append(dist.P2POp(dist.irecv, buf, self._peer(src),
                                      self.group))
                recv[key] = (buf, t)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        out = []
        for t, key in ((up, "from_below"), (down, "from_above")):
            if t is None:
                out.append(None)
            elif key in recv:
                buf, like = recv[key]
                out.append(self._back(buf, like))
            else:
                out.append(torch.zeros_like(t))
        return out[0], out[1]

    def halos(self, u: torch.Tensor, depth: int):
        """(lo, hi): the -z neighbour's top `depth` slabs and the +z
        neighbour's bottom `depth` slabs of the block u, zeros at the
        domain edges (the zero extension the kernels' masks expect)."""
        return self.exchange(u[-depth:], u[:depth])

    def halos2(self, v: torch.Tensor, f: torch.Tensor, depth: int):
        """(vlo, vhi, flo, fhi): the halos of two blocks of one shape in
        one exchange."""
        lo, hi = self.exchange(torch.cat([v[-depth:], f[-depth:]]),
                               torch.cat([v[:depth], f[:depth]]))
        return lo[:depth], hi[:depth], lo[depth:], hi[depth:]

    def shift_slabs(self, x: torch.Tensor, forward: bool) -> torch.Tensor:
        """x from rank - 1 (forward) or rank + 1, zeros at the edge."""
        lo, hi = self.exchange(x if forward else None,
                               None if forward else x)
        return lo if forward else hi

    def gather_z(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block (all of one shape), concatenated along z in
        rank order, on every rank."""
        src = self._host(x)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return self._back(torch.cat(parts), x)

    def sum_scalar(self, x: torch.Tensor) -> float:
        """The sum over the ranks of a 0-d partial, formed in f64 and
        added in rank order: the same float on every rank."""
        part = x.detach().reshape(1).to(torch.float64)
        if self.staged:
            part = part.cpu()
        parts = [torch.empty_like(part) for _ in range(self.size)]
        dist.all_gather(parts, part, group=self.group)
        total = 0.0
        for p in parts:
            total = total + float(p)
        return total


def _rank_main(rank: int, world_size: int, backend: str, init_file: str,
               device: str, fn: Callable, args: Sequence, results) -> None:
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
            device = f"cuda:{rank}"
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world_size)
        try:
            out = fn(rank, world_size, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, backend: str = "gloo",
              device: str = "cuda", args: Sequence = (),
              timeout: float = 600.0) -> List[Any]:
    """Run fn(rank, world_size, device, *args) in `world_size` spawned
    processes joined by one process group (`backend`: 'gloo' for CPU
    tensors or several ranks on one card, 'nccl' for one card per rank,
    rank r on cuda:r); return the results (picklable) in rank order.  fn
    must be importable by name.  Raises if a rank fails or the run
    outlasts `timeout` seconds; every process is stopped either way."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, backend, init_file, device,
                                   fn, tuple(args), results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out, failure = {}, None
        try:
            deadline = time.monotonic() + timeout
            while len(out) < world_size and failure is None:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    if time.monotonic() > deadline:
                        failure = f"ranks outlasted {timeout} s"
                    elif any(p.exitcode not in (None, 0) for p in procs):
                        failure = "a rank exited: " + ", ".join(
                            f"{i}: {p.exitcode}" for i, p in enumerate(procs))
                    continue
                if ok:
                    out[rank] = value
                else:
                    failure = f"rank {rank} failed:\n{value}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.terminate()
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
        if failure is not None:
            raise RuntimeError(failure)
    return [out[r] for r in range(world_size)]
