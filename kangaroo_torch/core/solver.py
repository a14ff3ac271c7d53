"""Solver orchestrator (plain and symmetry walks, one or more devices).

Counterpart of Kangaroo::Run + SolveKeyGPU (Kangaroo.cpp:334-506,
510-644, 913-1083) and of kangaroo_tpu/core/solver.py: the herd lives
on the devices in lane shards (parallel/sharding.py: -devices, one
shard and stream per device, or two on one card); each tick is
windows_per_tick launches of the walk kernel over a window of nb_run
jumps on every shard (-nwin).  Each shard's DP slots are compacted on
its device behind its last window of the tick and copied to pinned host
memory, read once by the host, bounded by the device watchdog
(device_timeout); the DPs go into the native hash table in
walk order with global lane indices, and collisions are resolved
exactly like the reference.  The symmetry walk (`-sym`) carries each
lane's class beside the herd, signed device distances and a key
recentred on the middle of the range.  For the same seed and options
the walk, the table and the counts do not depend on the shard count.

Work files (-w/-wi/-ws/-wsplit/-wt, -i): a solve checkpoints its table,
count, time and optionally its herd in the background (`_save_work`),
and resumes from a loaded file (`from_work`) or, on a repeated solve()
of the same key, from where the last one stopped, keeping the table and
the count (reference: SaveWork / LoadWork, Backup.cpp:149-207,449-572).

Client mode (`solve(dp_sink=...)`, net/client.py): the DPs go to a
server as wire records instead of into the local table, and a save
writes the herd alone, to a local HEADK file or through `save_hook`
(-wss) (reference: the clientMode branches of SolveKeyGPU and SaveWork).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..constants import HASH_SIZE, N_ORDER, TAME
from ..io import backup
from ..parallel import sharding
from ..utils import rng as rng_mod, spans
from . import curve, herd as herd_mod
from .collision import collision_check
from .config import ProblemConfig
from .hashtable import calc_dist_and_type, encode_records, make_hash_table
from .jumptable import create_jump_table


@dataclass
class SolverOptions:
    nb_kangaroo: int = 1 << 14     # herd lanes on the device
    dp_size: int = -1              # -1: auto (balanced_dp)
    dp_cost: float = -1.0          # host cost per drained DP (-1: default)
    nb_run: int = 16               # jumps per tick (0 = auto)
    max_step: float = 0.0          # abort after max_step*expected ops (0: never)
    seed: Optional[int] = None     # herd RNG seed (None: time seed)
    out_file: str = ""             # append solved keys
    quiet: bool = False
    # "cuda", "cuda:k" or "cpu", or a sequence of devices, one per shard
    # (it may repeat a card: two shards on one H100)
    device: Union[str, Sequence[str]] = "cuda"
    symmetry: bool = False         # -sym: walk classes {P, -P}
    # -devices: devices to shard the herd over (0 = all; on the CPU,
    # that many CPU shards).  The shard count follows the JAX solver's
    # rule (sharding.shard_count).
    n_devices: int = 0
    # -nwin: launch windows per tick, drained together (0 = auto: the
    # JAX solver's rule, engaged only when nb_run is auto too)
    windows_per_tick: int = 0
    # device watchdog: a device->host read of a tick that blocks longer
    # than this many seconds raises DeviceHangError; the solve then
    # saves its table alone to the work file and returns (0: off)
    device_timeout: float = 600.0
    # checkpointing (reference -w / -wi / -ws / -wsplit / -wt)
    work_file: str = ""
    save_period: int = 60          # seconds between saves
    save_kangaroo: bool = False    # -ws: the herd goes into the file too
    split_work_file: bool = False  # -wsplit: each save writes a new file
    # -wt: seconds to wait for a still-running background save before
    # skipping this interval (reference wtimeout, default 3000 ms)
    save_timeout: float = 3.0


@dataclass
class SolveStats:
    count: int = 0             # jumps, a loaded file's count included
    dead: int = 0
    # of the dead, DPs already in the table with the same distance: a
    # lane walking a trail that one of its own type (or itself) walked
    dup: int = 0
    # walk wall time (s), a loaded file's included: the loop's start to
    # the end of its final drain and synchronise (span `sync`)
    time: float = 0.0
    herd_time: float = 0.0     # herd creation (or restore): span `herd`
    ticks: int = 0
    expected_ops: float = 0.0
    # DP hits beyond the per-lane capture slots of a launch window
    # (reference warns on its bounded output ring, GPUEngine.cu:641-648)
    lost: int = 0
    saves: int = 0             # background saves started
    # solver-thread seconds spent starting them (spans `save`) ...
    save_stall: float = 0.0
    # ... and waiting for a save still running (spans `save.wait`)
    save_wait: float = 0.0
    # per drained tick, each shard's seconds in its compaction and copy,
    # the wait for its window's end included, in shard order (spans
    # `compact.wait` and `compact`, tagged with the shard's index)
    compact_s: List[Tuple[float, ...]] = field(default_factory=list)


# Per-lane DP capture slots are bounded; beyond this many the launch
# window is split instead.
MAX_SLOTS = 8
# Target probability of losing ANY DP in one launch window (summed over
# all lanes): sizing the slots from the Poisson tail makes loss a
# ~never event instead of a tuning accident.
DP_LOSS_TARGET = 1e-4

# Records per hash-table insert call in the drain.
DRAIN_CHUNK = 32768

# Walk-rate priors (jumps/s) for the auto-DP model, by device type.
# cuda: the walk kernel's rate measured on an NVIDIA H100 80GB HBM3 at a
# 700 W power limit by chip_smoke.py and kangaroo_torch/profile_walk.py
# (2^22 lanes x 1024 steps per launch: 3.50e9 jumps/s).
RATE_PRIOR = {"cuda": 3.5e9, "cpu": 3.5e6}


def poisson_tail(lam: float, k: int) -> float:
    """P(Pois(lam) >= k), direct pmf sum (accurate for tiny tails)."""
    if lam <= 0.0:
        return 0.0
    if k <= 0:
        return 1.0
    if k <= lam:
        # at or below the mode the tail is >= ~0.5; the series' leading
        # term would underflow for lam >= ~745
        return 1.0
    logp = -lam + k * math.log(lam) - math.lgamma(k + 1)
    term = math.exp(logp)
    total = 0.0
    for j in range(400):
        total += term
        term *= lam / (k + j + 1)
        if term < total * 1e-12 + 1e-300:
            break
    return total


def slots_for_window(nb_run: int, dp_size: int, n_lanes: int,
                     target: float = DP_LOSS_TARGET) -> int:
    """Smallest even slot count s >= 2 with
    n_lanes * P(Pois(lam) > s) <= target, lam = nb_run / 2^dp."""
    lam = nb_run / float(1 << dp_size)
    s = 2
    while n_lanes * poisson_tail(lam, s + 1) > target and s < 64:
        s += 1
    return s + (s & 1)


class SymmetryMismatch(ValueError):
    """A work file resumed with the other -sym setting."""


class DeviceHangError(RuntimeError):
    """A device->host read exceeded the watchdog's bound."""


def windows_per_tick(opts, n_slots: int, auto_window: bool,
                     nb_run: Optional[int] = None) -> int:
    """Launch windows per tick: opts.windows_per_tick, or with 0 the JAX
    solver's auto rule (kangaroo_tpu/core/solver.py:390-411): only when
    the window is auto too, whole windows of nb_run steps (default
    opts.nb_run) until a tick carries ~4096 steps, at most 16, and at
    most ~2 GB of one tick's DP slots (x 10, d 8 and step rows per slot
    over the whole herd)."""
    from ..ops import jump_ref

    kw = opts.windows_per_tick
    if kw:
        return kw
    if not auto_window:
        return 1
    kw = max(1, min(16, 4096 // (nb_run or opts.nb_run)))
    slot_bytes = n_slots * (jump_ref.DPX_ROWS + 8 + 1) * 4 * opts.nb_kangaroo
    return max(1, min(kw, int(2e9 / max(1, slot_bytes))))


Plan = collections.namedtuple("Plan", "dp_size suggested nb_run n_slots "
                              "windows_per_tick capped_loss")


def plan(solver: "KangarooSolver") -> Plan:
    """solve()'s DP size and tick shape, opts left as they are: dp -1 is
    balanced_dp at dp_cost (-1: DP_HOST_COST) over the `suggested` DP;
    nb_run 0 the longest window that helps (64-1024 steps), halved while
    its slots exceed MAX_SLOTS; an explicit window caps the slots
    instead, `capped_loss` DPs expected lost a window."""
    opts = solver.opts
    nk = opts.nb_kangaroo
    dp, suggested = opts.dp_size, None
    if dp < 0:
        suggested = solver.suggest_dp(nk)
        dp = solver.balanced_dp(
            nk, suggested=suggested,
            dp_cost=(opts.dp_cost if opts.dp_cost >= 0.0
                     else solver.DP_HOST_COST))
    auto_window = opts.nb_run == 0
    nb_run = (max(64, min(1024, 1 << max(0, dp - 3))) if auto_window
              else opts.nb_run)
    n_slots = slots_for_window(nb_run, dp, nk)
    while n_slots > MAX_SLOTS and auto_window and nb_run > 8:
        nb_run //= 2
        n_slots = slots_for_window(nb_run, dp, nk)
    loss = None
    if n_slots > MAX_SLOTS:
        n_slots = MAX_SLOTS
        loss = nk * poisson_tail(nb_run / float(1 << dp), MAX_SLOTS + 1)
    return Plan(dp, suggested, nb_run, n_slots,
                windows_per_tick(opts, n_slots, auto_window, nb_run), loss)


@dataclass
class _Walk:
    """The state one solve() call's steps share."""
    states: list           # one [px, py, d, symclass] a shard
    rng: rng_mod.MT19937
    tables: list           # one (jx, jy, jd, dp masks) a shard
    tick_fn: Callable      # sharding.make_sharded_jump_steps
    dp_sink: Optional[Callable]
    pending: Optional[list] = None  # the last tick's pulls, one a shard
    ticks: int = 0
    result: object = None
    sink_end: bool = False  # the sink reported the search's end


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on; cuda without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but no CUDA device is "
                           "available (pass device='cpu' / -device cpu)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


class KangarooSolver:
    """Holds range/key state and drives the device herd."""

    def __init__(self, cfg: ProblemConfig, opts: SolverOptions):
        from ..ops import jump_cuda

        self.cfg = cfg
        self.opts = opts
        self.devices = sharding.resolve_devices(opts.n_devices, opts.device)
        self.device = self.devices[0]
        cuda = self.device.type == "cuda"
        if any((d.type == "cuda") != cuda for d in self.devices):
            raise ValueError("a herd shards over cards or over the CPU, "
                             "not both")
        # Herd lanes snap to the walk kernel's lane quantum (blocks tile
        # the herd), as the reference snaps its census to the GPU grid
        # (Kangaroo.cpp:946-961); the quantum is even, so lane parity
        # still picks tame or wild.  The plain CPU walk only needs even.
        q = jump_cuda.LANE_QUANTUM if cuda else 2
        nk = opts.nb_kangaroo
        if nk % q:
            opts.nb_kangaroo = nk + (q - nk % q)
            if not opts.quiet:
                print(f"Warning: -nk {nk} rounded up to {opts.nb_kangaroo} "
                      f"(herd lanes snap to multiples of {q})")
        # lane shards: on a card each a whole number of kernel blocks
        self.shards = sharding.make_shards(self.devices, opts.nb_kangaroo,
                                           q if cuda else 1)
        self.hash_table = make_hash_table()
        self.stats = SolveStats()
        self.key_idx = 0
        self._lost_warned = False
        # resume state: a loaded file's count and time, its herd, and
        # `resumed`, which keeps the loaded table through the next
        # solve() (reference: LoadWork then Run keeps the table)
        self.offset_count = 0
        self.offset_time = 0.0
        self.loaded_kangaroos = None
        self.resumed = False
        # (px, py, d) where the last solve() stopped, and its key
        self.last_state = None
        self._active_key_idx = None
        self._save_thread = None
        self._save_error = None
        self._snap = None  # host buffers of the herd snapshot, reused
        self.range_start = cfg.range_start
        self.range_end = cfg.range_end
        self.range_width = self.range_end - self.range_start
        self.range_power = self.range_width.bit_length()
        self.width_div2 = self.range_width >> 1

    def init_search_key(self, key_idx: int):
        """Translate the key by rangeStart (Kangaroo.cpp:892-909); the
        symmetry walk recentres on the middle of the range (+width/2),
        so that wild distances straddle zero."""
        self.key_idx = key_idx
        key = self.cfg.keys[key_idx]
        sp = self.range_start % N_ORDER
        if self.opts.symmetry:
            sp = (sp + self.width_div2) % N_ORDER
        if sp != 0:
            self.key_to_search = curve.add(key, curve.mul(sp).neg())
        else:
            self.key_to_search = key
        self.key_to_search_neg = self.key_to_search.neg()

    # -- expected work model (reference: ComputeExpected, :836-873) -----
    def compute_expected(self, dp: float, nb_kangaroo: Optional[int] = None):
        k = float(nb_kangaroo or self.opts.nb_kangaroo)
        n = 2.0 ** self.range_power
        theta = 2.0 ** dp
        gain_s = 1.0 / math.sqrt(2.0) if self.opts.symmetry else 1.0
        z0 = (2.0 * (2.0 - math.sqrt(2.0)) * gain_s) * math.sqrt(math.pi)
        avg_dp0 = z0 * math.sqrt(n)
        op = z0 * (n * (k * theta + math.sqrt(n))) ** (1.0 / 3.0)
        # RAM model with the reference's C struct sizes (bytes):
        # HASH_ENTRY=16, ENTRY*=8, ENTRY=32 (Kangaroo.cpp:864-868)
        ram = 16.0 * HASH_SIZE + 8.0 * (HASH_SIZE * 4) + 40.0 * (op / theta)
        ram /= 1024.0 * 1024.0
        return op, ram, op / avg_dp0

    def suggest_dp(self, nb_kangaroo: int) -> int:
        """Reference auto-DP heuristic (Kangaroo.cpp:980-996)."""
        s = max(0, int(self.range_power / 2.0 - math.log2(float(nb_kangaroo))))
        _, _, overhead = self.compute_expected(float(s), nb_kangaroo)
        while overhead > 1.05 and s > 0:
            s -= 1
            _, _, overhead = self.compute_expected(float(s), nb_kangaroo)
        return s

    # Host-side cost of one DP (compaction share, copy, encode, insert).
    DP_HOST_COST = 2e-6

    def balanced_dp(self, nb_kangaroo: int, rate: Optional[float] = None,
                    suggested: Optional[int] = None,
                    dp_cost: float = DP_HOST_COST) -> int:
        """Auto-DP with the host drain in the cost model: minimize
            T(dp) = expected_ops(dp) * (1/rate + dp_cost / 2^dp)
        over dp >= the reference suggestion."""
        if rate is None:
            rate = RATE_PRIOR[self.device.type]
        s = self.suggest_dp(nb_kangaroo) if suggested is None else suggested
        best, best_t = s, None
        for dp in range(s, min(s + 24, 65)):
            op, _, _ = self.compute_expected(float(dp), nb_kangaroo)
            t = op * (1.0 / rate + dp_cost / float(1 << dp))
            if best_t is None or t < best_t:
                best, best_t = dp, t
        return best

    @classmethod
    def from_work(cls, lw: "backup.LoadedWork", opts: SolverOptions
                  ) -> "KangarooSolver":
        """A solver that resumes a loaded work file: its range and key,
        table, count, time and herd (the -i load path; reference:
        LoadWork before Run, Backup.cpp:149-207).  The file's DP size
        applies unless opts sets one.  Raises SymmetryMismatch when the
        file and opts disagree on -sym."""
        if lw.symmetry != opts.symmetry:
            w = "with" if lw.symmetry else "without"
            raise SymmetryMismatch(f"work file was saved {w} -sym; rerun "
                                   f"{w} -sym to resume it")
        if opts.dp_size < 0:
            opts.dp_size = lw.dp_size
        solver = cls(ProblemConfig(lw.range_start, lw.range_end, [lw.key]),
                     opts)
        solver.hash_table = lw.hash_table
        solver.offset_count = lw.count
        solver.offset_time = lw.time
        solver.resumed = True
        solver.loaded_kangaroos = lw.kangaroos
        return solver

    # -- main loop ------------------------------------------------------
    def solve(self, key_idx: int = 0, progress: Optional[Callable] = None,
              max_ticks: Optional[int] = None,
              dp_sink: Optional[Callable] = None,
              save_hook: Optional[Callable] = None):
        """Solve one key.  Returns a SolveResult, or None when stopped
        by max_ticks, max_step, the sink or the device watchdog.

        A repeated solve() of the same key keeps the table, the count
        and the time and continues the walk from last_state; so does
        the first solve() after from_work, from the loaded herd.  A new
        key starts afresh (reference: hashTable.Reset between keys,
        Kangaroo.cpp:1054-1056).

        Client mode: with dp_sink, each tick's DPs go to dp_sink(raw, m)
        as m 40-byte wire records {u32 origin lane, 36-byte table
        record}, in walk order, and not into the table; no lane is
        reset, and the loop stops when the sink returns True (the
        server reported the end of the search).  A periodic save then
        writes a kangaroo-only HEADK file to opts.work_file in the
        background, or, with save_hook, calls save_hook(solver, px, py,
        d, elapsed) on this thread with the host buffers of the herd's
        snapshot once its copy is done (-wss: the hook shares the
        server connection with the sink).  The next save reuses those
        buffers: a hook that keeps them copies them.

        Watchdog: a tick's device->host read that outlasts
        opts.device_timeout raises DeviceHangError inside the loop; the
        solve then writes its table alone to opts.work_file (the -wsplit
        name with -wsplit; not in client mode, whose table is empty) and
        returns None (kangaroo_tpu/core/solver.py:1222-1245).

        Spans (utils/spans.py, one serial a call): `solve` holds
        `jump_table`, `herd` (`herd.draws`, `herd.kG` inside, one a
        shard), one `tick` a loop iteration with each shard's
        `compact.wait` and `compact`, `launch`, `drain` (`reset` inside)
        and `save` (`save.wait`), and `finish` (the final `drain`,
        `sync`, the herd's gather and the last save's join).
        `herd.kG`, `compact.wait` and `compact` carry their shard's
        index (`shard`), every other span None.  SolveStats's timers are
        read from them.  The call's counter `dps` counts the records
        each drain hands to the table or the sink, `compact.spill` the
        pulls whose records outran their pinned block on a card."""
        with spans.span("solve"):
            self.init_search_key(key_idx)
            self._enter_key(key_idx)
            w = self._start(dp_sink)
            result = self._run(w, progress, max_ticks, save_hook)
            if result is not None and self.opts.out_file:
                self._output(result)
            return result

    def _enter_key(self, key_idx):
        """plan(), opts.nb_run resolved in place as the JAX solver does,
        then the table and stats policy of solve()."""
        (self.dp_size, _, self.opts.nb_run, self.n_slots,
         self.windows_per_tick, loss) = plan(self)
        if loss is not None and not self.opts.quiet:
            print(f"Warning: DP capture slots capped at {MAX_SLOTS} "
                  f"(expected ~{loss:.2g} lost DPs per launch "
                  f"window); lower -nbrun or raise -d to eliminate loss")
        same_key = self._active_key_idx == key_idx
        if not self.resumed and not same_key:
            self.hash_table.reset()
            self.offset_count = 0
            self.offset_time = 0.0
            self.stats = SolveStats()
        self.resumed = False
        self._active_key_idx = key_idx
        if same_key and self.loaded_kangaroos is None:
            self.loaded_kangaroos = self.last_state
        self.stats.expected_ops, _, _ = self.compute_expected(
            float(self.dp_size), self.opts.nb_kangaroo)

    def _start(self, dp_sink) -> _Walk:
        """Jump table (span `jump_table`), RNG, new or restored herd (span
        `herd`), the sharded window and the compaction buffers."""
        from ..ops import jump_cuda, jump_ref

        opts, shards, sym = self.opts, self.shards, self.opts.symmetry
        with spans.span("jump_table"):
            jt = [torch.from_numpy(a.astype(np.int32)) for a in
                  create_jump_table(self.range_power, sym).as_arrays()]
            tables = sharding.replicate(shards, *jt,
                                        jump_ref.dp_limb_masks(self.dp_size))
        rng = rng_mod.MT19937(opts.seed if opts.seed is not None
                              else (time.time_ns() & 0xFFFFFFFF))
        if self.device.type == "cuda":
            jump_cuda.load()  # an nvcc build belongs to set-up, not the walk

        with spans.span("herd") as herd_span:
            if self.loaded_kangaroos is not None:
                herds = sharding.shard_herd(
                    shards, *self._restore_herd(self.loaded_kangaroos, rng))
                self.loaded_kangaroos = None
            else:
                herds = herd_mod.create_herd_shards(
                    opts.nb_kangaroo, self.range_power, self.width_div2,
                    self.key_to_search, shards, TAME, rng, symmetry=sym)
            # a new or restored herd starts normalized, in class 0 (the
            # reference's restore reallocates symClass zeroed)
            states = []
            for sh, h in zip(shards, herds):
                with sh.walk():
                    states.append(list(h) + [
                        torch.zeros((sh.hi - sh.lo,), dtype=torch.int32,
                                    device=sh.device) if sym else None])
            del herds
            sharding.synchronize(shards)
        self.stats.herd_time = herd_span.seconds

        tick_fn = sharding.make_sharded_jump_steps(
            shards, opts.nb_run, self.n_slots, sym)
        for sh in shards:
            sharding.compact_blocks(sh, self.n_slots, self.windows_per_tick,
                                    opts.nb_run, self.dp_size)
        return _Walk(states, rng, tables, tick_fn, dp_sink)

    def _run(self, w: _Walk, progress, max_ticks, save_hook):
        """The loop, then span `finish` (the last drain, `sync`, the herd's
        gather, the last save's join), or the watchdog's save."""
        self.stats.count = self.offset_count
        t0 = spans.now()
        hung = False
        with contextlib.ExitStack() as finishing:
            try:
                self._loop(w, t0, progress, max_ticks, save_hook)
                finishing.enter_context(spans.span("finish"))
                if (w.result is None and not w.sink_end
                        and w.pending is not None):
                    self._drain(w, self._pull_all(w))
                with spans.span("sync") as sync:
                    if self.device.type == "cuda":
                        # the last dispatched tick is in stats.count:
                        # finish it, so that count / time is the rate of
                        # work actually done
                        self._host_read(functools.partial(
                            sharding.synchronize, self.shards))
                loop_end = sync.end
            except DeviceHangError as e:
                hung = True
                self._on_hang(e, w.dp_sink, (spans.now() - t0) * 1e-9)
                loop_end = spans.now()
            self.stats.ticks = w.ticks
            self.stats.time = self.offset_time + (loop_end - t0) * 1e-9
            self.last_state = None if hung else sharding.gather_herd(
                self.shards, [st[:3] for st in w.states])
            # a repeated solve() on this key continues from here
            self.offset_count = self.stats.count
            self.offset_time = self.stats.time
            if not hung:
                self.finish_save()
        return w.result

    def _loop(self, w: _Walk, t0: int, progress, max_ticks, save_hook):
        """Ticks (span `tick` each) until a stop, with the progress
        callback every 2 s and the periodic saves."""
        opts = self.opts
        last_status = last_save = t0
        stop = False
        while w.result is None and not stop:
            if max_ticks is not None and w.ticks >= max_ticks:
                break
            if (opts.max_step > 0 and self.stats.count
                    > opts.max_step * self.stats.expected_ops):
                break
            with spans.span("tick"):
                stop = self._tick(w)
                now = spans.now()
                if progress is not None and now - last_status > 2e9:
                    progress(self, (now - t0) * 1e-9)
                    last_status = now
                if ((opts.work_file or save_hook is not None)
                        and w.result is None and not w.sink_end
                        and now - last_save > opts.save_period * 1e9):
                    # tick T's herd (after T-1's resets), the DPs up to
                    # T-1 and tick T in the count, as the JAX solver saves
                    elapsed = (now - t0) * 1e-9
                    if save_hook is not None:
                        self._run_save_hook(save_hook, w.states, elapsed)
                    else:
                        self._save_work(w.states, elapsed,
                                        kangaroo_only=w.dp_sink is not None)
                    last_save = now

    def _tick(self, w: _Walk) -> bool:
        """Tick T: pull every shard's T-1 DPs in turn (each waits only for
        its own shard's T-1 windows, compaction and copy), launch T on
        every shard at once, then drain T-1 on the host while T runs.
        (Launching each shard right after its own pull lets the shards
        drift apart, so that one runs alone on a shared card.)  Resets
        thus land one tick late, as in the JAX solver's loop and the
        reference's asynchronous readback (GPUEngine.cu:607-677).
        Returns True when the drain stops the loop."""
        opts = self.opts
        # tick T counts from its start, as the JAX solver counts a tick
        # at its dispatch (a hang's file holds its count)
        self.stats.count += (opts.nb_kangaroo * opts.nb_run
                             * self.windows_per_tick)
        w.ticks += 1
        pulled = None if w.pending is None else self._pull_all(w)
        with spans.span("launch"):
            w.pending = self._launch(w)
        return pulled is not None and self._drain(w, pulled)

    def _launch(self, w: _Walk) -> list:
        """A tick's windows on every shard, then each shard's compaction
        queued behind its last; returns the shards' pulls."""
        sym = self.opts.symmetry
        wins = [[] for _ in self.shards]
        for _ in range(self.windows_per_tick):
            for st, win, out in zip(w.states, wins,
                                    w.tick_fn(w.states, w.tables)):
                st[:3] = out[0:3]
                if sym:
                    st[3] = out[7]
                win.append(out[3:7])
        return [sharding.queue_compact(sh, win, self.n_slots,
                                       self.opts.nb_run)
                for sh, win in zip(self.shards, wins)]

    def _pull_all(self, w: _Walk) -> list:
        return [self._pull(i, sh, q)
                for i, (sh, q) in enumerate(zip(self.shards, w.pending))]

    def _pull(self, i: int, sh, q):
        """Shard i's DPs of a tick, read once under the watchdog; returns
        ((lost, block), seconds)."""
        t = spans.now()
        waited, out = self._host_read(functools.partial(self._read, sh, q))
        end = spans.now()
        spans.add("compact.wait", t, waited, shard=i)
        spans.add("compact", waited, end, shard=i)
        if q.spilled:
            spans.count("compact.spill", 1)
        return out, (end - t) * 1e-9

    def _read(self, sh, q):
        q.wait()
        waited = spans.now()
        return waited, sharding.compact(sh, q, self.n_slots, self.opts.nb_run)

    def _drain(self, w: _Walk, pulled) -> bool:
        """One tick's pulls merged, to the sink or the table; True when
        the key is solved or the sink ends the search."""
        with spans.span("drain"):
            self.stats.compact_s.append(tuple(sec for _, sec in pulled))
            lost = sum(lost for (lost, _), _ in pulled)
            blks = [blk for (_, blk), _ in pulled]
            blk = blks[0] if len(blks) == 1 else np.concatenate(blks)
            if lost:
                self.stats.lost += lost
                if not self._lost_warned and not self.opts.quiet:
                    self._lost_warned = True
                    print(f"\nWarning, {lost} items lost\nHint: "
                          f"increase dp bit number or decrease -nbrun "
                          f"to lower the DP rate per launch window")
            if not len(blk):
                return False
            rec, lanes = encode_records(blk, self.width_div2,
                                        self.opts.symmetry)
            if w.dp_sink is None:
                return self._insert(w, rec, lanes)
            m = rec.shape[0]
            spans.count("dps", m)
            # the wire's kIdx column carries the (global) origin lane
            wire = np.empty((m, 40), dtype=np.uint8)
            wire[:, 0:4] = lanes.astype("<u4").view(np.uint8).reshape(m, 4)
            wire[:, 4:] = rec
            w.sink_end = bool(w.dp_sink(wire.tobytes(), m))
            return w.sink_end

    def _insert(self, w: _Walk, rec, lanes) -> bool:
        """Insert in the JAX solver's chunks, so that resets (and their
        RNG draws) come in its order; True once a chunk solves the key."""
        wd2_sym = self.width_div2 if self.opts.symmetry else None
        resets = []
        m = rec.shape[0]
        for off in range(0, m, DRAIN_CHUNK):
            part = min(DRAIN_CHUNK, m - off)
            spans.count("dps", part)
            _, dup_idx, dup_total, colls = self.hash_table.add_batch_raw(
                rec[off:off + part].tobytes(), part)
            self.stats.dead += dup_total
            self.stats.dup += dup_total
            resets += [int(lanes[off + i]) for i in dup_idx]
            for _, d_new, d_old, idx in colls:
                d1, t1 = calc_dist_and_type(d_old)
                d2, t2 = calc_dist_and_type(d_new)
                dead, res = collision_check(
                    d1, t1, d2, t2, self.key_to_search,
                    self.key_to_search_neg, self.range_start,
                    width_div2_sym=wd2_sym)
                if res is not None:
                    w.result = res
                    return True
                if dead:
                    self.stats.dead += 1
                    resets.append(int(lanes[off + idx]))
        if resets:
            with spans.span("reset"):
                self._reset_lanes(w.states, resets, w.rng)
        return False

    def _on_hang(self, err, dp_sink, elapsed):
        """The watchdog fired: save what the host holds -- the table and
        the count, not the herd, whose arrays may be unreadable -- to the
        work file, as the JAX solver does (solver.py:1222-1245); a save
        still running gets -wt to end first."""
        opts = self.opts
        if not opts.quiet:
            print(f"\nDevice watchdog: {err}")
        prev = self._save_thread
        if prev is not None:
            prev.join(timeout=opts.save_timeout)
        if not opts.work_file or dp_sink is not None:
            return
        if prev is not None and prev.is_alive():
            if not opts.quiet:
                print("\nSaveWork timeout !")
            return
        name = opts.work_file
        if opts.split_work_file:
            name = backup.split_file_name(name)
        backup.save_work(name, self, None, None, None, self.stats.count,
                         self.offset_time + elapsed, save_kangaroo=False)
        if not opts.quiet:
            print(f"Saved work to {name} (table only); resume with -i "
                  f"(DP-overhead cost only)")

    def _host_read(self, fn):
        """fn() -- a blocking device->host read -- under the watchdog: it
        runs on a daemon thread and raises DeviceHangError when it
        outlasts opts.device_timeout (0: fn() on this thread).  A hung
        read leaves its thread blocked; being a daemon, it does not hold
        the interpreter's exit (the JAX solver's _host_read).  fn makes
        current whatever device and stream it reads from: a new thread
        starts on each device's default stream."""
        to = self.opts.device_timeout
        if not to:
            return fn()
        box = []
        done = threading.Event()

        def run():
            try:
                box.append((True, fn()))
            except BaseException as e:  # raised on the solver thread
                box.append((False, e))
            done.set()

        threading.Thread(target=run, daemon=True,
                         name="kangaroo-devread").start()
        if not done.wait(to):
            raise DeviceHangError(f"device read exceeded {to:.0f}s "
                                  f"watchdog")
        ok, val = box[0]
        if not ok:
            raise val
        return val

    def _restore_herd(self, state, rng):
        """A loaded or continued herd (px, py, d), numpy or tensors, as
        tensors on the first shard's device, reconciled with -nk
        (reference: FectchKangaroos fills a shortfall with fresh
        kangaroos and warns about a surplus, Backup.cpp:283-287): a
        surplus is cut at the tail, a shortfall filled at the tail by
        create_herd with first_type = the restored count's parity, so
        lane parity stays the kangaroo type."""
        opts = self.opts
        px, py, d = (torch.as_tensor(np.asarray(a, dtype=np.int32))
                     if not isinstance(a, torch.Tensor) else a
                     for a in state)
        px, py, d = (t.to(self.device, torch.int32) for t in (px, py, d))
        nl, n = px.shape[1], opts.nb_kangaroo
        if nl > n:
            if not opts.quiet:
                print(f"Warning: {nl - n} unhandled kangaroos! "
                      f"(-nk {n} < {nl} restored)")
            px, py, d = px[:, :n], py[:, :n], d[:, :n]
        elif nl < n:
            fx, fy, fd = herd_mod.create_herd(
                n - nl, self.range_power, self.width_div2,
                self.key_to_search, nl % 2, rng, device=self.device,
                symmetry=opts.symmetry,
            )
            px, py, d = (torch.cat(p, dim=1)
                         for p in ((px, fx), (py, fy), (d, fd)))
        return px, py, d

    def _snapshot(self, states):
        """Copy the herd, shard by shard, into host buffers of the whole
        herd allocated once (pinned on a card), each shard's on its walk
        stream, right after this tick's launch and its resets and before
        the next launch, which walks the herd in place.  Returns the
        buffers and the events a reader waits on (none on the CPU, where
        the copies are synchronous)."""
        cuda = self.device.type == "cuda"
        n = self.opts.nb_kangaroo
        if self._snap is None or self._snap[0].shape[1] != n:
            self._snap = tuple(
                torch.empty((t.shape[0], n), dtype=t.dtype, pin_memory=cuda)
                for t in states[0][:3])
        evs = []
        for sh, st in zip(self.shards, states):
            with sh.walk():
                for buf, t in zip(self._snap, st[:3]):
                    dst = buf[:, sh.lo:sh.hi]
                    if dst.is_contiguous():
                        dst.copy_(t, non_blocking=cuda)
                    else:  # row by row: each row's lane range is
                        for r in range(t.shape[0]):  # contiguous
                            dst[r].copy_(t[r], non_blocking=cuda)
                if cuda:
                    evs.append(sh.stream.record_event())
        return self._snap, evs

    def _run_save_hook(self, hook, states, elapsed):
        """Client mode's -wss save: the hook gets the snapshot's host
        buffers on the solver thread, once the copies are done (span
        `save`)."""
        with spans.span("save") as sp:
            snap, evs = self._snapshot(states)
            if evs:
                self._host_read(lambda: [ev.synchronize() for ev in evs])
            hook(self, *(b.numpy() for b in snap), elapsed)
        self.stats.saves += 1
        self.stats.save_stall += sp.seconds

    def _save_work(self, states, elapsed, kangaroo_only=False):
        """Checkpoint without stalling the walk.

        The solver thread copies the herd into host buffers on the
        shards' walk streams (only with -ws, or for a client's
        kangaroo-only file), swaps in a fresh table for -wsplit, and
        starts a writer thread; the writer waits for the copies (under
        the watchdog), packs the herd and writes the table span by span
        (a drain meanwhile waits for one span at most: a fuzzy snapshot,
        exact with -wsplit, whose table is frozen), or for a client
        (kangaroo_only) a HEADK file of the herd alone.  The reference
        instead pauses all workers for the whole write
        (Backup.cpp:449-472); -wt bounds the wait for a save that is
        still running, after which this interval's save is skipped.
        Spans `save.wait` (the wait) and `save` (the rest).
        """
        prev = self._save_thread
        if prev is not None and prev.is_alive():
            with spans.span("save.wait") as sp:
                prev.join(timeout=self.opts.save_timeout)
            self.stats.save_wait += sp.seconds
            if prev.is_alive():
                if not self.opts.quiet:
                    print("\nSaveWork timeout !")
                return
        self._raise_save_error()
        with spans.span("save") as sp:
            self._start_save(states, elapsed, kangaroo_only)
        self.stats.saves += 1
        self.stats.save_stall += sp.seconds

    def _start_save(self, states, elapsed, kangaroo_only):
        """_save_work's snapshot, table swap and writer thread."""
        snap, evs = (self._snapshot(states)
                     if self.opts.save_kangaroo or kangaroo_only
                     else (None, []))
        count = self.stats.count
        total_time = self.offset_time + elapsed
        table = self.hash_table
        name = self.opts.work_file
        if self.opts.split_work_file and not kangaroo_only:
            # -wsplit: swap in a fresh table now (solver thread) and
            # write the frozen one; offline merge recovers cross-file
            # collisions.  Files are timestamped like the reference's.
            self.hash_table = make_hash_table()
            name = backup.split_file_name(name)

        def write():
            try:
                if evs:
                    self._host_read(lambda: [ev.synchronize() for ev in evs])
                herd = ((None,) * 3 if snap is None
                        else tuple(b.numpy() for b in snap))
                if kangaroo_only:
                    backup.save_kangaroo_file(name, self, *herd, count,
                                              total_time)
                else:
                    backup.save_work(name, self, *herd, count, total_time,
                                     save_kangaroo=snap is not None,
                                     table=table)
            except BaseException as e:  # raised by the solver thread
                self._save_error = e

        self._save_thread = threading.Thread(target=write, daemon=True)
        self._save_thread.start()

    def _raise_save_error(self):
        err, self._save_error = self._save_error, None
        if err is not None:
            raise RuntimeError("background work-file save failed") from err

    def finish_save(self):
        """Join an in-flight background save (end of solve, tests) and
        raise its error, if it failed."""
        t = self._save_thread
        if t is not None:
            t.join()
        self._raise_save_error()

    def _reset_lanes(self, states, lanes, rng):
        """Dead kangaroos draw fresh ones (Kangaroo.cpp:467-471).

        Distances are drawn per reset in order (RNG-stream-identical to
        the reference's per-lane CreateHerd(1) calls); the positions are
        rebuilt in one batch per shard, on its device and walk stream,
        and scattered in one write per array.  `lanes` are global, and
        so is each lane's type (its parity).  A lane reset twice in one
        batch keeps its last draw.  In symmetry mode a fresh lane starts
        normalized, in class 0.
        """
        sym = self.opts.symmetry
        r = herd_mod.draw_start_words(len(lanes), self.range_power, rng, sym)
        last = {lane: i for i, lane in enumerate(lanes)}
        keep = np.array(sorted(last.values()), dtype=np.int64)
        glob = np.array(lanes, dtype=np.int64)[keep]
        for sh, st in zip(self.shards, states):
            sel = (glob >= sh.lo) & (glob < sh.hi)
            if not sel.any():
                continue
            with sh.walk():
                npx, npy, nd = herd_mod.herd_from_draws(
                    r[keep[sel]], glob[sel] % 2, self.width_div2,
                    self.key_to_search, device=sh.device, symmetry=sym,
                )
                idx = torch.from_numpy(glob[sel] - sh.lo).to(sh.device)
                st[0][:, idx] = npx
                st[1][:, idx] = npy
                st[2][:, idx] = nd
                if sym:
                    st[3][idx] = 0

    def _output(self, res):
        """Append the solved key (reference: Output, Kangaroo.cpp:176-213)."""
        pub = curve.get_public_key_hex(self.cfg.keys[self.key_idx], True)
        with open(self.opts.out_file, "a") as f:
            f.write(f"Key#{self.key_idx:2d} [{res.variant}{res.sign_info}]"
                    f"Pub:  0x{pub} \n")
            f.write(f"       Priv: 0x{res.private_key:X} \n")
