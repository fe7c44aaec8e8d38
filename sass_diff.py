"""Compare the SASS of two builds of the port's kernel library.

    python3 sass_diff.py OLD_CHECKOUT [NEW_CHECKOUT]

Builds ``chan_vese_tpu_torch``'s kernels in each checkout (the default new
one is this directory), disassembles both libraries with ``cuobjdump
-sass`` and checks that every kernel of the old library compiles to the
same instructions in the new one: each old function's body (its
instruction text, addresses and encodings dropped) must appear among the
new library's bodies, whatever the function's name (a kernel that became
a template keeps its body under a new mangled name). Prints the old
functions without a match and exits 1 if there is one. Needs the CUDA
toolkit (nvcc, cuobjdump).
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def build(checkout: Path) -> Path:
    """The kernel library of ``checkout``, built by its own _build.py."""
    out = subprocess.run(
        [sys.executable, "-c", "from chan_vese_tpu_torch import _build; "
         "print(_build.build())"], cwd=checkout, capture_output=True,
        text=True, check=True)
    return Path(out.stdout.strip().splitlines()[-1])


def bodies(lib: Path):
    """{function name: tuple of instruction texts} of a library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = _INSTR.search(line)
        if name is not None and m:
            funcs[name].append(m.group(1))
    return {n: tuple(b) for n, b in funcs.items()}


def main(argv) -> int:
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    old_dir = Path(argv[0]).resolve()
    new_dir = Path(argv[1] if len(argv) > 1 else ".").resolve()
    old, new = bodies(build(old_dir)), bodies(build(new_dir))
    have = collections.Counter(new.values())
    missing = [n for n, b in old.items() if have[b] == 0]
    same = len(old) - len(missing)
    print(f"sass_diff: {len(old)} functions in {old_dir.name}, {len(new)} "
          f"in {new_dir.name}; {same} old bodies found unchanged in the new "
          f"library, {len(missing)} not")
    for n in missing:
        print(f"  changed: {n}")
    return 1 if missing else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
