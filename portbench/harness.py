"""What a driver gets and gives back: the run's settings and seeds, and
its outcome (end-to-end metrics, the program's spans and counters for
the per-layer readers, the numbers compared)."""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np

from .bench import Cell
from .compare import Check
from .trace import Tracer


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    device: str            # "cuda" (the benchmark) or "cpu" (its tests)
    t_start: float         # host clock at process start
    tracer: Tracer

    @property
    def cuda(self) -> bool:
        return self.device == "cuda"

    def rng(self, tag: str) -> np.random.Generator:
        """A generator of the run's seed for one purpose (`tag`)."""
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed & (2 ** 64 - 1), zlib.crc32(tag.encode())]))

    def seed32(self, tag: str) -> int:
        return int(self.rng(tag).integers(0, 2 ** 32))


@dataclass
class Outcome:
    end_to_end: Dict[str, float]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    program: Dict[str, Any] = field(default_factory=dict)
    info: Dict[str, Any] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(c.ok for c in self.checks)


def memory_peak(devices) -> int:
    import torch

    return max(int(torch.cuda.max_memory_allocated(d)) for d in devices)


def device_ids(run: Run) -> tuple:
    return tuple(range(run.cell.chips)) if run.cuda else ()


def solver_options(run: Run, lanes: int, symmetry: bool, seed: int):
    """The solver's options for a cell: the configuration's window and
    DP, on the run's cards (one shard a card) or, for the tests, in as
    many CPU shards."""
    from kangaroo_torch.core.solver import SolverOptions

    cfg = run.cell.config
    return SolverOptions(
        nb_kangaroo=lanes, dp_size=int(cfg["dp_size"]),
        nb_run=int(cfg["nb_run"]),
        windows_per_tick=int(cfg["windows_per_tick"]), seed=seed,
        quiet=True, device=run.device, n_devices=run.cell.chips,
        symmetry=symmetry)


def record_resets(solver) -> List[int]:
    """Wrap the solver's dead-lane reset so that the lanes it redraws
    are recorded; returns the list it appends to.  The solver keeps no
    public record of them yet, so this leans on its private
    `_reset_lanes`: once `SolveStats` records the reset lanes, read
    them there and drop this wrapper."""
    lanes: List[int] = []
    inner = solver._reset_lanes

    def reset(states, reset_lanes, rng):
        lanes.extend(int(v) for v in reset_lanes)
        return inner(states, reset_lanes, rng)

    solver._reset_lanes = reset
    return lanes
