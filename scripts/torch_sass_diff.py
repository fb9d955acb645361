"""Whether the port's kernels compile to the same machine code as another
tree's: for each csrc/*.cu that both trees have, the SASS of every kernel
function (cuobjdump -sass), compared function by function.

    python3 scripts/torch_sass_diff.py OTHER_ROOT
    (from the repo root, on a machine with nvcc, e.g. the parent commit
    unpacked with git archive into a directory .gitignore lists)

Builds both trees' kernels (each tree's own ops/hopper/build.py, in a
process of its own), then prints one JSON line per source: the kernel
functions whose SASS is identical (by count), those that differ and those
only one tree has. Exits 2 where a kernel of a shared source differs.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BUILD = ("import json, sys; sys.path.insert(0, '.'); "
         "from ampnet_tpu_torch.ops.hopper import build; "
         "print(json.dumps({k: str(v) for k, v in build.build_all().items()}))")


def libraries(root: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", BUILD], cwd=root, capture_output=True,
                         text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


# the anonymous namespace's mangled name carries a hash of the source's path
ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def sass(lib: str) -> dict:
    """{kernel function: its SASS}, addresses, the source's path and the
    column padding left out (cuobjdump pads every line to the widest address
    of the library, so a library that grows would differ everywhere)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in ANON.sub("ANON", text).splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            funcs[name].append(" ".join(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split()))
    return {k: "\n".join(v) for k, v in funcs.items()}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    other = Path(sys.argv[1]).resolve()
    ours, theirs = libraries(ROOT), libraries(other)
    differs = False
    for stem in sorted(set(ours) | set(theirs)):
        if stem not in ours or stem not in theirs:
            print(json.dumps({"source": stem,
                              "only_in": "this tree" if stem in ours else str(other)}))
            continue
        a, b = sass(ours[stem]), sass(theirs[stem])
        row = dict(source=stem,
                   identical=sum(a[k] == b[k] for k in a.keys() & b.keys()),
                   differ=sorted(k for k in a.keys() & b.keys() if a[k] != b[k]),
                   only_here=sorted(a.keys() - b.keys()), only_there=sorted(b.keys() - a.keys()))
        differs |= bool(row["differ"] or row["only_here"] or row["only_there"])
        print(json.dumps(row), flush=True)
    return 2 if differs else 0


if __name__ == "__main__":
    sys.exit(main())
