"""Print what the compiler made of the port's CUDA kernels: for each
kernel of the library (build.library(), built from
multigrid_dolfinx_tpu_torch/csrc) whose symbol contains one of the given
names, its SASS instruction count by opcode, and its SASS written to
<out>/<kernel>.sass.  cuobjdump is taken from beside nvcc.  Imports
nothing of JAX.

Usage: python3 scripts/kernel_sass.py NAME [NAME ...] [--out DIR]
  e.g. restrict_zmarch prolong_zmarch (default DIR: build/kernel_sass)
"""
import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def functions(sass):
    """(symbol, SASS lines) of each function in cuobjdump -sass output."""
    name, lines = None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                yield name, lines
            name, lines = m.group(1), []
        elif name:
            lines.append(line)
    if name:
        yield name, lines


def opcodes(lines):
    """Opcode counts of SASS instruction lines (predicates and modifiers
    dropped: @P0 LDS.U.64 -> LDS)."""
    count = collections.Counter()
    for line in lines:
        m = re.match(
            r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
            line)
        if m:
            count[m.group(1)] += 1
    return count


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="+")
    ap.add_argument("--out", default=str(ROOT / "build" / "kernel_sass"))
    args = ap.parse_args(argv)
    from multigrid_dolfinx_tpu_torch.ops.cuda import build

    lib = build.library_path()
    build.library()
    cuobjdump = Path(build._find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    found = 0
    for name, lines in functions(sass):
        if not any(n in name for n in args.names):
            continue
        found += 1
        count = opcodes(lines)
        short = re.sub(r"[^A-Za-z0-9_]+", "_", name)[:120]
        (out / f"{short}.sass").write_text("\n".join(lines) + "\n")
        print(f"{name}: {sum(count.values())} instructions; " + ", ".join(
            f"{op} {n}" for op, n in count.most_common()))
    if not found:
        print(f"FAILED: no kernel matches {args.names}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
