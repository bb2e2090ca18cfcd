"""The instruction mix of a built kernel library's loops, read from its SASS.

    python -m avenir_tpu_torch.kernels.sass threefry

builds ``csrc/<name>.cu`` as the port builds it (:mod:`.build`),
disassembles the library with the CUDA toolkit's ``cuobjdump -sass``, and
prints, for every loop of every kernel function (a backward branch and the
instructions from its target up to it), the count of each instruction and
the counts by the Hopper pipe that issues it: the integer ALU pipe
(``IADD3``, ``LOP3``, ``SHF``, ``ISETP``, ``LEA``, ...; 64 lanes a clock
an SM), the integer multiply-add on the FMA pipe (``IMAD`` and its forms,
which the compiler also uses for adds and moves; 64 lanes a clock an SM),
float arithmetic, and memory.  It needs the toolkit, so it runs on the
card's machine.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys
from typing import Dict, List, Tuple

from . import build

PIPES = {"alu": ("IADD3", "LOP3", "SHF", "ISETP", "LEA", "SEL", "PRMT",
                 "IMNMX", "IABS", "FLO", "BREV"),
         "imad": ("IMAD",),
         "float": ("FFMA", "FADD", "FMUL", "FMNMX", "FSETP", "MUFU"),
         "memory": ("LDG", "STG", "LDS", "STS", "LDC", "LD", "ST", "ATOM",
                    "RED")}
_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)"
                  r"((?:\.[A-Z0-9_]+)*)\s*([^;]*);")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")


def pipe_of(op: str) -> str:
    for pipe, ops in PIPES.items():
        if op in ops:
            return pipe
    return "other"


def parse(sass: str) -> Dict[str, List[Tuple[int, str, str, str]]]:
    """function name -> [(address, opcode, modifiers, operands)]."""
    funcs: Dict[str, List[Tuple[int, str, str, str]]] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INS.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3),
                        m.group(4).strip()))
    return funcs


def loops(instructions) -> List[Tuple[int, int]]:
    """(start, end) address of each backward branch's body."""
    out = []
    for addr, op, _, operands in instructions:
        if op == "BRA":
            target = int(operands.split()[-1].rstrip(","), 16)
            if target < addr:
                out.append((target, addr))
    return out


def mix(instructions, start: int, end: int) -> Dict[str, Dict[str, int]]:
    body = [(op, op + mods) for a, op, mods, _ in instructions
            if start <= a <= end]
    by_pipe = collections.Counter(pipe_of(op) for op, _ in body)
    return {"total": len(body), "pipes": dict(by_pipe),
            "instructions": dict(collections.Counter(full for _, full in
                                                     body).most_common())}


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or ["threefry"]
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()),
                             "cuobjdump")
    build.build_all(names)
    for name in names:
        sass = subprocess.run([cuobjdump, "-sass",
                               str(build.library_path(name))],
                              check=True, capture_output=True,
                              text=True).stdout
        for func, ins in parse(sass).items():
            for start, end in loops(ins):
                m = mix(ins, start, end)
                print(f"{name} {func} loop {start:#06x}-{end:#06x}: "
                      f"{m['total']} instructions, by pipe {m['pipes']}; "
                      f"{m['instructions']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
