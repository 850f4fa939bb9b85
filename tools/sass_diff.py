"""Compare the compiled machine code (SASS) of the CUDA kernels of two trees
of this repository, kernel by kernel.

Each tree builds its own kernel library (``lsm_tpu_torch.ops._build``, in a
process of its own, from that tree's sources); ``cuobjdump -sass`` lists
each kernel's instructions; a kernel's name is taken without the hash of
its anonymous namespace (which changes with the file's contents), and its
instructions without their addresses. A kernel whose instructions are equal
in both trees was compiled to the same code, so a change elsewhere in its
source file or its headers left it alone.

A kernel that gained a template argument has another mangled name; ``OLD=NEW``
arguments after the trees replace ``NEW`` by ``OLD`` in the names of the
second tree's kernels that the first tree lacks, so each old instantiation is
compared with the one that replaced it (``E=Li0EE``: a trailing ``int``
template argument whose value 0 keeps the old code).

From the repository root, on a machine with the CUDA toolkit:
    git archive <parent> | tar -x -C _archive/parent
    python3 tools/sass_diff.py _archive/parent . [OLD=NEW ...]
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")
# the hash of an anonymous namespace: in the _GLOBAL__N__ form, or the 8 hex
# digits after the file's name (`refresh_ghosts_cu_89302f97`)
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_|(?<=_cu_)[0-9a-f]{8}")


def library(tree: str) -> str:
    """Build (or find) ``tree``'s kernel library; its path."""
    code = "from lsm_tpu_torch.ops import _build; print(_build.load_library().path)"
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                         text=True, check=True)
    return os.path.join(tree, out.stdout.strip().splitlines()[-1])


def kernels(lib: str) -> dict:
    """``{kernel name without its namespace hash: [instructions]}``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            name = _ANON.sub("", m.group(1))
            out[name] = []
            continue
        m = _INSTR.search(line)
        if name and m:
            out[name].append(m.group(1))
    return out


def main(first: str, second: str, *renames: str) -> int:
    a, b = kernels(library(first)), kernels(library(second))
    for rename in renames:
        old, new = rename.split("=")
        b = {name if name in a else name.replace(new, old): code for name, code in b.items()}
    for name in sorted(set(a) | set(b)):
        if name not in a or name not in b:
            state = f"only in {first if name in a else second}"
        elif a[name] == b[name]:
            state = f"identical ({len(a[name])} instructions)"
        else:
            diff = sum(x != y for x, y in zip(a[name], b[name])) + abs(len(a[name]) - len(b[name]))
            state = f"differs ({len(a[name])} vs {len(b[name])} instructions, {diff} differ)"
        print(f"SASS {name}: {state}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
