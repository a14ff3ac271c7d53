"""What nvcc made of a kernel: ptxas reports and SASS listings.

`ptxas_report` reads the `-Xptxas -v` log that `utils.build` keeps
beside each library (registers, spills, stack and shared memory per
kernel); `sass_functions` splits `cuobjdump -sass` of a library into its
kernels, so that a probe can count the instructions it claims to
measure and a build can hash a kernel's code; `loop_bodies` finds the
loops of a listing (a branch back to an earlier instruction), so that a
chain probe can count the instructions of one trip.  The readers of
cuobjdump run only where the CUDA toolkit is (the card's machine).
"""

from __future__ import annotations

import collections
import hashlib
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PROPS = re.compile(r"Function properties for (\w+)")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_FUNC = re.compile(r"^\s*Function : (\w+)\s*$")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
_ADDR = re.compile(r"/\*([0-9a-f]{4,})\*/")
# a branch to an address (cuobjdump prints `BRA 0x9a0`)
_BRA = re.compile(r"\bBRA(?:\.\w+)*\s+(?:!?U?P\w+\s*,\s*)?(0x[0-9a-f]+)")


def ptxas_report(log: str) -> Dict[str, dict]:
    """Mangled kernel name -> {regs, smem, stack, spill_stores,
    spill_loads} from an nvcc -Xptxas -v log."""
    out: Dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = _ENTRY.search(line) or _PROPS.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _STACK.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            m2 = _SMEM.search(line)
            cur.update(regs=int(m.group(1)),
                       smem=int(m2.group(1)) if m2 else 0)
    return out


_NOISE = re.compile(r"<unnamed>::|\(anonymous namespace\)::|\((?:int|bool)\)")


def demangle(names: List[str]) -> Dict[str, str]:
    """Mangled -> readable C++ names (cu++filt or c++filt), without the
    anonymous namespace and the casts of template arguments, e.g.
    `void kt_raw_chain<0, 4>(void *, unsigned long, int)`; a name no tool
    reads stays as it is.  For display: match kernels by mangled name."""
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    r = subprocess.run([tool], input="\n".join(names), capture_output=True,
                       text=True, timeout=60, check=True)
    readable = [_NOISE.sub("", s) for s in r.stdout.splitlines()]
    return dict(zip(names, readable)) if len(readable) == len(names) else {
        n: n for n in names}


def cuobjdump() -> str:
    """Path of cuobjdump: on PATH, or beside nvcc (the CUDA toolkit's
    bin/)."""
    nvcc = shutil.which("nvcc")
    for cand in (shutil.which("cuobjdump"),
                 nvcc and str(Path(nvcc).with_name("cuobjdump"))):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("cuobjdump not found beside nvcc")


def sass_functions(lib: Path) -> Dict[str, List[str]]:
    """Mangled kernel name -> its SASS instruction lines (cuobjdump
    -sass of the library)."""
    r = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True,
                       text=True, timeout=300, check=True)
    return split_functions(r.stdout)


def split_functions(listing: str) -> Dict[str, List[str]]:
    """`sass_functions` on the text of a cuobjdump -sass listing."""
    out: Dict[str, List[str]] = {}
    cur = None
    for line in listing.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
        elif cur is not None and _INSN.search(line):
            cur.append(line.strip())
    return out


def loop_bodies(lines: List[str]) -> List[List[str]]:
    """The instruction lines of each loop in a kernel's listing: from the
    target of a branch back to an earlier address through the branch,
    inner loops included as they come; a branch to itself (the trap
    after EXIT) is no loop."""
    addr = [int(_ADDR.search(x).group(1), 16) for x in lines]
    out = []
    for i, line in enumerate(lines):
        m = _BRA.search(line)
        lo = int(m.group(1), 16) if m else addr[i]
        if lo < addr[i]:
            out.append([x for x, a in zip(lines, addr) if lo <= a <= addr[i]])
    return out


_GUARD = re.compile(r"^@!?(U?P\w+)\s+")
_PRED = re.compile(r"!?(P[0-6])")
_SETP = ("ISETP", "FSETP", "DSETP", "PLOP3")


def lost_carries(lines: List[str]) -> List[str]:
    """The instructions of a listing that overwrite a carry no
    instruction has read yet: the carry-out predicate of an IADD3 (an
    add chain's flag) written again before an instruction takes it as a
    source or a guard.  Empty where ptxas kept every carry of the
    chains until its reader, whatever it scheduled between them."""
    live, lost = set(), []
    for line in lines:
        m = _INSN.search(line)
        if not m:
            continue
        text = line[m.start(1):].split(";")[0]
        op, _, rest = text.partition(" ")
        args = [a.strip() for a in rest.split(",")]
        if op.startswith(_SETP):
            n_out = sum(1 for a in args[:2] if _PRED.fullmatch(a))
        else:  # a register, then any predicates it writes
            n_out = 1
            while n_out < len(args) and _PRED.fullmatch(args[n_out]):
                n_out += 1
            n_out -= 1
            args = args[1:]
        outs = {_PRED.fullmatch(a).group(1) for a in args[:n_out]}
        reads = {x.group(1) for a in args[n_out:]
                 for x in [_PRED.fullmatch(a)] if x}
        g = _GUARD.search(line[line.find("*/") + 2:].strip())
        if g:
            reads.add(g.group(1))
        live -= reads
        if outs & live:
            lost.append(line)
        live -= outs
        if op.startswith("IADD3"):
            live |= outs
    return lost


def sass_hash(lines: List[str]) -> str:
    """sha256 (first 16 hex digits) of a kernel's SASS listing."""
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]


def opcode_counts(lines: List[str]) -> Dict[str, int]:
    """Instruction mnemonic (with its modifiers, e.g. IMAD.WIDE.U32) ->
    static count in a SASS listing."""
    return collections.Counter(m.group(1) for m in map(_INSN.search, lines)
                               if m)


def count_class(counts: Dict[str, int], mnemonic: str) -> int:
    """Static count of an instruction class: the mnemonic and its
    modifiers (IMAD counts IMAD and IMAD.U32 but neither the IMAD.MOV
    moves nor IMAD.WIDE, which is its own class)."""
    total = 0
    for op, k in counts.items():
        if op == mnemonic or op.startswith(mnemonic + "."):
            if mnemonic == "IMAD" and op.split(".")[1:2] in (["MOV"],
                                                               ["WIDE"]):
                continue
            total += k
    return total
