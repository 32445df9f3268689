"""Instruction census of a built kernel: what the card's compiler made of its
loops, counted from ``cuobjdump -sass`` by instruction class.

``census(library, kernel)`` disassembles the shared library that
``ops/_build.py`` built and, for every function whose (mangled) name holds
``kernel``, finds each innermost loop (a backward branch and the
instructions from its target to it) that stores to device memory. For each
it counts one trip's instructions by class and the 4-byte elements the trip
stores (``STG.E`` 1, ``.64`` 2, ``.128`` 4), so instructions per element
follow.

``issue_bound_ms`` prices such a count at a measured integer instruction
rate: the ALU pipe (simple integer and logic) issues one instruction of a
warp per SM sub-partition every two cycles, which is the rate the alu chain
of ``probes/rates.py`` measures; the dispatcher issues one every cycle,
across pipes; the quarter-rate pipe (leading-zero count, conversions) a
quarter of the ALU's. The bound is the largest of the three times.

Run on the card's machine (it needs the CUDA toolkit's ``cuobjdump``):
``python -m multilingual_kws_tpu_torch.probes.sass <library.so> <kernel>
[<elements> <alu instructions/s>]`` prints the census as one JSON line,
each loop with its ``issue_bound_ms`` when the last two are given.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

# instruction classes by opcode (the first token; modifiers after the dot)
ALU_OPS = {"IADD3", "IADD", "VIADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA", "ISETP", "SEL", "IMNMX",
           "VIMNMX", "IABS", "PRMT", "BMSK", "SGXT", "PLOP3", "P2R", "R2P", "MOV", "I2FP", "F2IP",
           "FSETP", "FMNMX", "FSEL"}
QUARTER_OPS = {"FLO", "POPC", "BREV", "I2F", "F2I", "F2F", "MUFU"}
FMA_OPS = {"IMAD", "FFMA", "FADD", "FMUL", "HFMA2"}
BRANCH_OPS = {"BRA", "BSSY", "BSYNC", "EXIT", "BAR", "WARPSYNC", "JMP", "CALL", "RET", "BREAK", "NOP"}
CLASSES = ("int32", "int64_parts", "quarter_rate", "float", "global_load", "global_store", "shared",
           "branch", "uniform", "other")


def classify(op: str) -> str:
    """An opcode with its modifiers (``IMAD.WIDE.U32``) -> its class. The
    parts of 64-bit arithmetic: wide and high multiplies, carries (.X),
    64-bit shifts and extended compares."""
    base, *mods = op.split(".")
    if base == "LDG":
        return "global_load"
    if base == "STG":
        return "global_store"
    if base in ("LDS", "STS", "LDSM", "ATOMS"):
        return "shared"
    if base in BRANCH_OPS:
        return "branch"
    if base.startswith("U") or base in ("R2UR", "S2UR", "LDC"):
        return "uniform"
    if base in ("IMAD", "IADD3", "LEA", "SHF", "ISETP") and (
        {"WIDE", "X", "EX", "U64", "S64"} & set(mods) or (base == "IMAD" and "HI" in mods)
    ):
        return "int64_parts"
    if base in QUARTER_OPS:
        return "quarter_rate"
    if base in ALU_OPS or base == "IMAD":
        return "int32"
    if base in FMA_OPS:
        return "float"
    return "other"


def pipe(op: str) -> str:
    """The pipe an opcode issues to: the FMA pipe (multiplies, float
    arithmetic), the quarter-rate pipe, the ALU (the rest of integer, logic,
    compares, selects), or none of these (memory, control, uniform)."""
    base = op.split(".")[0]
    if base in FMA_OPS:
        return "fma"
    if base in QUARTER_OPS:
        return "quarter"
    if base in ALU_OPS:
        return "alu"
    return "other"


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"^\s*(0x[0-9a-f]+)\b")


def _functions(sass: str) -> Dict[str, List[str]]:
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def _loops(lines: List[str]):
    """Instructions as (predicate, opcode, operands), and the innermost
    loops as (first, last) indices: a branch back to an earlier address, and
    the instructions from that address to it, holding no other such loop."""
    insns, at = [], {}
    for line in lines:
        m = _INSN.search(line)
        if m:
            at[int(m.group(1), 16)] = len(insns)
            insns.append(((m.group(2) or "").strip(), m.group(3), m.group(4)))
    loops = []
    for i, (_, op, args) in enumerate(insns):
        t = _TARGET.match(args)
        if op.startswith("BRA") and t and at.get(int(t.group(1), 16), i + 1) <= i:
            loops.append((at[int(t.group(1), 16)], i))
    inner = [(a, b) for a, b in loops if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]
    return insns, inner, at


def fall_through(insns, at, first: int, last: int):
    """One trip of a loop along its fall-through path: every predicated
    forward branch not taken, every unconditional one taken. (A loop whose
    flags are runtime arguments holds each flag's code behind such a
    branch; the fall-through path is the one with every flag on.)
    Predicated instructions on the path issue whether or not they act."""
    path, i = [], first
    while i <= last:
        pred, op, args = insns[i]
        path.append(insns[i])
        t = _TARGET.match(args)
        if op.startswith("BRA") and not pred and t and i < last:
            i = at[int(t.group(1), 16)]
            continue
        i += 1
    return path


def _elements(path) -> int:
    """4-byte elements one trip stores: stores under complementary
    predicates (``@P2``, ``@!P2``) store one of them."""
    plain, guarded = 0, {}
    for pred, op, _ in path:
        if op.startswith("STG"):
            n = 4 if ".128" in op else 2 if ".64" in op else 1
            if pred:
                key = pred.lstrip("@!")
                guarded[key] = max(guarded.get(key, 0), n)
            else:
                plain += n
    return plain + sum(guarded.values())


def count(insns) -> Dict[str, int]:
    """Instructions by class."""
    by = dict.fromkeys(CLASSES, 0)
    for _, op, _ in insns:
        by[classify(op)] += 1
    return by


def census(library, kernel: str) -> List[dict]:
    """Each innermost storing loop of the functions named like ``kernel`` in
    ``library``: {function, instructions (the loop's, all paths),
    path_instructions (one trip's fall-through path), by_class and by_pipe
    (of the path), elements (stored by a trip), per_element (path
    instructions per element)}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return census_text(subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                                      check=True).stdout, kernel)


def census_text(sass: str, kernel: str) -> List[dict]:
    """``census`` of disassembled text."""
    out = []
    for name, lines in _functions(sass).items():
        if kernel not in name:
            continue
        insns, loops, at = _loops(lines)
        for a, b in loops:
            path = fall_through(insns, at, a, b)
            elems = _elements(path)
            if not elems:
                continue
            pipes: Dict[str, int] = {}
            for _, op, _ in path:
                pipes[pipe(op)] = pipes.get(pipe(op), 0) + 1
            out.append({
                "function": name, "instructions": b - a + 1, "path_instructions": len(path),
                "by_class": count(path), "by_pipe": pipes, "elements": elems,
                "per_element": len(path) / elems,
            })
    return out


def issue_bound_ms(loop: dict, elements: float, alu_instr_per_s: float) -> Dict[str, float]:
    """Least ms for ``elements`` elements at one loop's census, with the ALU
    pipe issuing ``alu_instr_per_s`` thread instructions a second (the alu
    chain's rate), the dispatcher twice that, the quarter-rate pipe a
    quarter of it."""
    per = {k: v / loop["elements"] for k, v in loop["by_pipe"].items()}
    t = {
        "dispatch": loop["per_element"] * elements / (2 * alu_instr_per_s) * 1e3,
        "alu": per.get("alu", 0.0) * elements / alu_instr_per_s * 1e3,
        "quarter": per.get("quarter", 0.0) * elements / (alu_instr_per_s / 4) * 1e3,
    }
    t["bound"] = max(t.values())
    return t


if __name__ == "__main__":
    if len(sys.argv) not in (3, 5):
        sys.exit("usage: python -m multilingual_kws_tpu_torch.probes.sass <library.so> <kernel> "
                 "[<elements> <alu instructions/s>]")
    loops = census(Path(sys.argv[1]), sys.argv[2])
    if len(sys.argv) == 5:
        for loop in loops:
            loop["issue_bound_ms"] = issue_bound_ms(loop, float(sys.argv[3]), float(sys.argv[4]))
    print(json.dumps(loops))
