"""Instruction counts of a built kernel's inner loop, from its SASS.

``cuobjdump -sass lib.so`` prints each kernel instance as a header line
``Function : <mangled name>`` followed by its instructions, one a line, as
``/*<hex address>*/ [@P] OPCODE operands ;``.  A loop is a conditional
backward branch: a predicated ``BRA`` whose target (a hex address, or a
``.L_x_<n>`` label that precedes an instruction) lies at or before the
branch.  (The compiler's out-of-line paths, such as a shuffle's fallback
for a divergent warp, jump back unconditionally into the code they left;
they are not loops.)  :func:`inner_loop`
finds the innermost such loop that holds a given instruction (the kernel's
store, say) and counts its instructions by opcode: with one store of k
cells an iteration, that count over k is the loop's instructions per cell.

:func:`clocks_per_item` turns a loop's counts into the least SM clocks each
item of its work takes on each pipe of a Hopper SM, from the throughputs of
the CUDA C++ Programming Guide's table of native arithmetic instructions for
compute capability 9.0, in lanes a clock per SM: every instruction is issued
by one of 4 schedulers of 32 lanes (128); the int32 ALU pipe adds,
compares, shifts, selects and does bitwise logic at 64; the FMA pipe does
float32 add, multiply and multiply-add at 128 and int32 multiply-add (IMAD,
also the compiler's moves) at 64, on its heavy half; the XU pipe does
population counts, bit scans, conversions and special functions at 16.
The pipes work side by side, so the loop's bound is the largest of these
times.  An opcode whose pipe is not listed counts only towards the issue
time, which keeps each time a lower bound.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

__all__ = ["Loop", "cuobjdump_sass", "functions", "inner_loop", "clocks_per_item"]

_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(r"/\*([0-9a-fA-F]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRANCH = re.compile(r"^@!?U?P\w+\s+BRA\b(?:\.\S+)?\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-fA-F]+))")


ISSUE_LANES = 128  # 4 schedulers x 32 lanes, a clock per SM
ALU = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "PRMT", "LEA", "IABS", "IMNMX", "PLOP3",
       "P2R", "R2P")  # the int32 ALU pipe, 64 lanes a clock per SM
FMA_FLOAT = ("FFMA", "FMUL", "FADD")  # the FMA pipe, both halves: 128
FMA_INT = ("IMAD",)  # the FMA pipe's heavy half: 64
XU = ("POPC", "FLO", "BREV", "MUFU", "I2F", "F2I", "F2F")  # 16


class Loop(NamedTuple):
    """A loop of a kernel instance: its first and last instruction's
    addresses, its instructions, how many of them contain the marker, and
    its instructions by opcode (the mnemonic before the first dot)."""
    start: int
    end: int
    instructions: int
    marked: int
    opcodes: Dict[str, int]


def _opcode(text: str) -> str:
    words = text.split()
    op = words[1] if words[0].startswith("@") and len(words) > 1 else words[0]
    return op.split(".")[0]


def cuobjdump_sass(library: Path) -> str:
    """``cuobjdump -sass`` of a built library; raises if the tool is missing
    or fails."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = (Path(CUDA_HOME) / "bin" / "cuobjdump") if CUDA_HOME else None
    if tool is None or not tool.is_file():
        found = shutil.which("cuobjdump")
        if found is None:
            raise RuntimeError("cuobjdump not found: counting a kernel's SASS needs the CUDA "
                               "toolkit")
        tool = Path(found)
    return subprocess.run([str(tool), "-sass", str(library)], check=True, capture_output=True,
                          text=True, timeout=300).stdout


def functions(sass: str) -> Dict[str, List[Tuple[int, str]]]:
    """Each kernel instance's instructions, ``(address, text)`` in address
    order, by mangled name; a label is resolved to the address of the
    instruction that follows it, and its branches name that address."""
    out: Dict[str, List[Tuple[int, str]]] = {}
    cur: Optional[List[Tuple[int, str]]] = None
    labels: Dict[str, int] = {}
    pending: List[str] = []
    raw: List[List[Tuple[int, str]]] = []
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            raw.append(cur)
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTRUCTION.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            cur.append((addr, m.group(2).strip()))
    for instrs in raw:  # labels name addresses from here on
        for i, (addr, text) in enumerate(instrs):
            for lab, at in labels.items():
                text = text.replace(f"`({lab})", hex(at))
            instrs[i] = (addr, text)
    return out


def inner_loop(instrs: List[Tuple[int, str]], marker: str) -> Optional[Loop]:
    """The innermost loop among ``instrs`` (one kernel instance) that holds
    an instruction containing ``marker``, or None when no loop does."""
    best: Optional[Loop] = None
    for addr, text in instrs:
        m = _BRANCH.search(text)
        if not m:
            continue
        target = int(m.group(2) or "0", 16)
        if target > addr:
            continue
        body = [t for a, t in instrs if target <= a <= addr]
        marked = sum(marker in t for t in body)
        if marked and (best is None or len(body) < best.instructions):
            opcodes: Dict[str, int] = {}
            for t in body:
                opcodes[_opcode(t)] = opcodes.get(_opcode(t), 0) + 1
            best = Loop(target, addr, len(body), marked, opcodes)
    return best


def clocks_per_item(loop: Loop, items: float) -> Dict[str, float]:
    """The least SM clocks per item of work on each pipe ("issue", "alu",
    "fma", "xu") for a loop that does ``items`` items an iteration in each
    lane (lanes x instructions over each pipe's lanes a clock)."""
    def count(names):
        return sum(n for op, n in loop.opcodes.items() if op in names)

    imad, flt = count(FMA_INT), count(FMA_FLOAT)
    per_iteration = {"issue": loop.instructions / ISSUE_LANES, "alu": count(ALU) / 64,
                     "fma": max(imad / 64, (imad + flt) / 128), "xu": count(XU) / 16}
    return {k: v / items for k, v in per_iteration.items()}
