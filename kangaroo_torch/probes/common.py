"""What the probe entry points share: the card, the report header, and
timing by CUDA events (a warm-up launch, then the mean of `reps`)."""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..ops import jump_cuda, probe_cuda
from ..profile_walk import cuda_ms
from ..utils import sass
from ..utils.build import BUILD_DIR

REPS = 3
# Shared memory an SM of compute capability 9.0 shares among its resident
# blocks (228 KB), and what the runtime keeps of it for each block (1 KB):
# a block with s bytes of shared memory leaves room for
# SMEM_PER_SM // (s + SMEM_RESERVED) blocks an SM.
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED = 1024


def occupancy_smem(blocks: int, static: int = 0) -> int:
    """Dynamic shared memory per block that holds a kernel with `static`
    bytes of static shared memory to `blocks` resident blocks an SM
    (where its registers and threads would allow more): `blocks` such
    blocks fill the SM's shared memory, one more would overflow it."""
    if blocks < 1:
        raise ValueError(f"{blocks} blocks per SM")
    return SMEM_PER_SM // blocks - SMEM_RESERVED - static


def walk_blocks() -> int:
    """Resident blocks per SM of the plain walk kernel on the card, read
    from its attributes (jump_cuda.occupancy: registers, shared memory
    and launch bounds); its launch bounds ask for jump_cuda.MIN_BLOCKS."""
    return jump_cuda.occupancy(jump_cuda.LANE_QUANTUM)["blocks_per_sm"]


def walk_label(blocks: int) -> str:
    """The label of a contrast held to the walk's occupancy."""
    return (f"@walk occupancy ({blocks} blocks/SM, "
            f"{blocks * probe_cuda.THREADS // 128} warps a scheduler)")


def hold_to(family: str, name: str, arg: int, blocks: int) -> int:
    """Dynamic shared memory that holds probe kernel (family, name, arg)
    to `blocks` resident blocks per SM, checked against the card's
    occupancy calculator; raises where it does not hold them there."""
    static = probe_cuda.attrs(family, name, arg)["smem"]
    smem = occupancy_smem(blocks, static)
    got = probe_cuda.attrs(family, name, arg, smem)["blocks_per_sm"]
    if got != blocks:
        raise RuntimeError(f"{family}/{name}@{arg} at {smem} B of shared "
                           f"memory holds {got} blocks per SM, not "
                           f"{blocks}")
    return smem


def require_card() -> torch.device:
    """The card the probes run on; raises where there is none (the
    probes have no CPU mode)."""
    if not torch.cuda.is_available():
        raise SystemExit("the probes need a CUDA card")
    return torch.device("cuda", 0)


def card_line() -> str:
    """nvidia-smi's name, power limit and maximum SM clock of card 0."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def ptxas_lines(keys=None) -> list:
    """One line per kernel of the probe library's ptxas report
    (registers, spills, stack, shared memory), for the kernels whose
    readable name contains one of `keys` (all when None)."""
    lib = probe_cuda.build()
    rep = sass.ptxas_report((BUILD_DIR / f"{lib.name}.log").read_text())
    names = sass.demangle(sorted(rep))
    out = []
    for mangled, r in sorted(rep.items(), key=lambda kv: names[kv[0]]):
        name = names[mangled]
        if keys is None or any(k in name for k in keys):
            out.append(f"{name}: {r.get('regs')} registers, spill "
                       f"{r.get('spill_stores')}/{r.get('spill_loads')} B, "
                       f"stack {r.get('stack')} B, smem {r.get('smem')} B")
    return out


def header(title: str, keys=None) -> torch.device:
    """Print the card and the probe kernels' build report; returns the
    card."""
    dev = require_card()
    print(f"{title}: {torch.cuda.get_device_name(0)} ({card_line()})",
          flush=True)
    for line in ptxas_lines(keys):
        print(f"  ptxas {line}", flush=True)
    return dev


def time_ms(fn, reps: int = REPS) -> float:
    """ms per call of fn() on the current stream: one warm-up call, then
    the mean of `reps` by CUDA events."""
    fn()
    return cuda_ms(fn, reps=reps)[1]


def limbs(rng: np.random.RandomState, rows: int, n: int, dev,
          low: int = 0) -> torch.Tensor:
    """(rows, n) int32 random 16-bit limbs on dev."""
    return torch.from_numpy(
        rng.randint(low, 1 << 16, (rows, n)).astype(np.int32)).to(dev)


def sass_counts() -> dict:
    """Mangled kernel name -> instruction counts of the probe library's
    SASS (cuobjdump)."""
    funcs = sass.sass_functions(probe_cuda.build())
    return {k: sass.opcode_counts(v) for k, v in funcs.items()}


# the instructions that only the ALU pipe issues (probe_cuda's "alu"
# class; IADD3 with its carry forms, LEA with LEA.HI)
ALU_SASS = ("IADD3", "LOP3", "SHF", "LEA")


def loop_trips() -> dict:
    """Mangled kernel name -> instruction counts of one trip of its
    longest loop (empty for a kernel without a loop)."""
    funcs = sass.sass_functions(probe_cuda.build())
    return {k: sass.opcode_counts(max(sass.loop_bodies(v), key=len,
                                      default=[]))
            for k, v in funcs.items()}


def alu_count(counts: dict) -> int:
    """The ALU-pipe instructions (ALU_SASS) among SASS counts."""
    return sum(sass.count_class(counts, m) for m in ALU_SASS)


def kernel_sass(counts: dict, tag: str) -> dict:
    """The counts of the kernel whose mangled name holds `tag`, e.g.
    kt_raw_chainILi0ELi4EE for kt_raw_chain<0, 4>."""
    for name, c in counts.items():
        if tag in name:
            return c
    raise RuntimeError(f"no kernel {tag} in the probe library's SASS")


def require_insn(counts: dict, tag: str, mnemonics) -> int:
    """Static count of the instruction a probe claims to measure (any of
    `mnemonics`, with modifiers) in its kernel's SASS; a kernel without
    it is a fault."""
    c = kernel_sass(counts, tag)
    n = sum(sass.count_class(c, m) for m in mnemonics)
    if n == 0:
        raise RuntimeError(f"{tag}: its SASS has none of {mnemonics}")
    return n


class ClockSampler:
    """nvidia-smi's SM clock and power draw every 100 ms while the block
    runs: `with ClockSampler() as clk: ...`, then clk.summary()."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.samples = [tuple(float(v) for v in ln.split(","))
                        for ln in out.splitlines() if ln.count(",") == 1]
        return False

    def median_mhz(self) -> float:
        """The median SM clock of the samples, MHz (nan without any)."""
        if not self.samples:
            return float("nan")
        mhz = sorted(c for c, _ in self.samples)
        return mhz[len(mhz) // 2]

    def summary(self) -> str:
        if not self.samples:
            return "no clock samples"
        mhz = sorted(c for c, _ in self.samples)
        watts = sorted(w for _, w in self.samples)
        return (f"SM clock {mhz[0]:.0f}/{mhz[len(mhz) // 2]:.0f}/"
                f"{mhz[-1]:.0f} MHz (min/median/max of {len(mhz)} samples), "
                f"power median {watts[len(watts) // 2]:.0f} W")


def occupancy(family: str, name: str, arg: int = 0, smem: int = 0) -> str:
    a = probe_cuda.attrs(family, name, arg, smem)
    return (f"{a['regs']} regs, {a['local_bytes']} B local, "
            f"{a['blocks_per_sm']} blocks/SM")
