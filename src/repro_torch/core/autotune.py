"""Adaptive commit tuner: the paper's §5.3–§5.4 loop.

The paper's performance analysis is about *choosing* HTM parameters:
the mechanism tier (atomics or transactions), the transaction size M,
the coarsening.  ``CommitSpec`` exposes them as static knobs; this module
chooses them at run time, in two stages:

1. **Calibration** (once per knob set, cached).  Timed micro-commits of
   a synthetic workload run through every mechanism tier on the state's
   device, the §5.3 affine model ``T(N) = B + A·N`` is fit per tier
   (:func:`repro_torch.core.perf_model.fit`), the tier with the lowest
   predicted time at the workload's batch size wins (two close or
   extrapolated tiers race at the workload's size), and
   :func:`~repro_torch.core.perf_model.select_m` picks M* from the
   fine/coarse crossing point.

2. **Conflict feedback** (per commit or round).  M* seeds a position on a
   power-of-two ladder of transaction sizes; every commit's conflict
   density moves it: abort storms shrink M, quiet rounds grow it.

Entry points: ``CommitSpec(backend="auto")`` through
:func:`repro_torch.core.commit.commit` (:func:`resolve_spec`, stage 1
only); :func:`make_commit_step`, the handle the single-shard loops carry
(stages 1 and 2); :func:`policy_for`, :func:`ladder_commit`,
:func:`ladder_fused_site` and :func:`next_level`, the pieces
``run_distributed`` threads through its round loop.

``REPRO_AUTOTUNE=off`` skips the timed calibration (a deterministic
policy; conflict feedback stays on).  ``REPRO_AUTOTUNE_CACHE`` names the
persistent cache file (``aam-autotune/v1``; default
``.repro_torch_autotune_cache.json`` in the working directory) or
``off``.

This module mirrors :mod:`repro.core.autotune`, with these differences:

* Timing: ``torch.cuda.Event`` pairs on a card, ``time.perf_counter`` on
  the CPU; min of the repeats, as the reference.
* The ladder level is a Python ``int`` the host loops carry, and
  :func:`ladder_commit` indexes the policy's per-level specs where the
  reference switches over traced branches.  :func:`next_level` reads a
  commit's (conflicts, messages) pair in one host read: one wait for the
  card per commit on an adaptive policy, none on a static spec.
* Cache keys name the device kind (``torch.cuda.get_device_name`` or
  ``"cpu"``) where the reference names ``jax.default_backend()``, and
  the default file is not the reference's.
* The kernel tiers (``pallas``/``fused``) join the candidates only for
  state on a CUDA device (or with ``REPRO_AUTOTUNE_ALLOW_INTERP=1``): on
  the CPU they run their plain versions, which must not be timed as if
  they were the kernels.  On a card a kernel that fails to build raises;
  the tuner does not leave the tiers out quietly.
* :class:`TunerPolicy` has no ``interpret`` field (the port's specs have
  none).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import perf_model
from repro_torch.core.commit import (AUTO, BACKENDS, CommitResult, CommitSpec,
                                     _pallas_supported, commit)
from repro_torch.core.messages import Messages, make_messages

# Power-of-two transaction-size ladder (None = whole batch, the M -> inf
# column of the paper's Fig 4).
M_LADDER: tuple = (16, 64, 256, 1024, 4096, None)

# Conflict-density waterlines (conflicts / routed messages per commit).
# Above HIGH the serialization analogue dominates -> shrink M; below LOW
# transactions are conflict-free -> grow M.  Between them the level holds.
HIGH_WATER = 0.30
LOW_WATER = 0.05


@dataclasses.dataclass(frozen=True)
class TunerPolicy:
    """Resolved calibration output, frozen and hashable.

    ``adaptive=False`` (atomic tier, or a pinned M) makes
    :func:`ladder_commit`/:func:`next_level` a plain commit."""
    backend: str
    ladder: tuple = M_LADDER
    init_level: int = len(M_LADDER) - 1
    adaptive: bool = True
    high_water: float = HIGH_WATER
    low_water: float = LOW_WATER
    sort: bool = True
    stats: bool = True
    tile_m: int = 256
    block_v: int = 512
    sanitize: bool = False

    def spec_at(self, level: int) -> CommitSpec:
        """Concrete CommitSpec for one ladder level."""
        return CommitSpec(backend=self.backend, m=self.ladder[level],
                          sort=self.sort, stats=self.stats,
                          tile_m=self.tile_m, block_v=self.block_v,
                          sanitize=self.sanitize)

    def clip(self, level: int) -> int:
        return min(max(int(level), 0), len(self.ladder) - 1)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Per-tier affine fits from one timed micro-benchmark run."""
    fine: perf_model.LinearFit          # per-message activity model
    tiers: tuple                        # ((backend, LinearFit), ...)

    def tier(self, backend: str) -> perf_model.LinearFit | None:
        for b, f in self.tiers:
            if b == backend:
                return f
        return None


def _autotune_enabled() -> bool:
    return os.environ.get("REPRO_AUTOTUNE", "on").lower() not in (
        "off", "0", "false")


# ---------------------------------------------------------------------------
# Persistent calibration cache (survives processes)
# ---------------------------------------------------------------------------
#
# Calibration is timed micro-benchmarking; short-lived runs would re-pay
# it per process.  The JSON file persists the fitted tiers and race
# verdicts, keyed by knob set + device kind (fits hold only within one
# device class).  A corrupt or alien file is ignored, never fatal.

CACHE_SCHEMA = "aam-autotune/v1"
_CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
_CACHE_DEFAULT = ".repro_torch_autotune_cache.json"


def _cache_path() -> str | None:
    v = os.environ.get(_CACHE_ENV, "")
    if v.lower() in ("off", "0", "false"):
        return None
    return v or _CACHE_DEFAULT


def _fit_to_json(f: perf_model.LinearFit) -> dict:
    return {"intercept": f.intercept, "slope": f.slope, "r2": f.r2}


def _fit_from_json(d) -> perf_model.LinearFit:
    return perf_model.LinearFit(intercept=float(d["intercept"]),
                                slope=float(d["slope"]), r2=float(d["r2"]))


def _sanitize(f: perf_model.LinearFit) -> perf_model.LinearFit:
    """Clamp a measured fit to the physical region (B, A >= 0): a slightly
    negative slope from noisy small-N timings would predict a negative
    time at a large N and hand the win to the slowest tier."""
    return perf_model.LinearFit(intercept=max(f.intercept, 0.0),
                                slope=max(f.slope, 0.0), r2=f.r2)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def device_kind(device) -> str:
    """The cache's device key: the card's name, or ``"cpu"``."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class AutoTuner:
    """Calibration cache and policy factory.

    Measurements use a fixed synthetic workload (``v_cal`` vertices) per
    (op, payload dtype, payload width); the knobs that change the
    executed code (``sort``/``stats``/kernel tiles) and the device key
    the cache.
    """

    def __init__(self, *, ns=(8, 64, 512), v_cal: int = 1 << 12,
                 warmup: int = 1, repeats: int = 3):
        self.ns = tuple(ns)
        self.v_cal = v_cal
        self.warmup = warmup
        self.repeats = repeats
        self._cache: dict = {}
        self._disk: dict | None = None      # lazily loaded JSON entries
        # timed micro-benchmark invocations in this tuner: a warm cache
        # keeps it at 0
        self.timed_runs = 0
        # decision audit log: every calibration fit, race and policy with
        # the measurements behind it (bounded FIFO; ladder moves stream
        # through repro_torch.obs.wavetap)
        self.audit: list[dict] = []

    def _audit(self, event: dict) -> None:
        self.audit.append(event)
        if len(self.audit) > 512:
            del self.audit[:len(self.audit) - 512]

    # -- persistent cache -------------------------------------------------

    def _disk_entries(self) -> dict:
        if self._disk is None:
            self._disk = {}
            p = _cache_path()
            if p and os.path.exists(p):
                try:
                    with open(p) as f:
                        doc = json.load(f)
                    if doc.get("schema") == CACHE_SCHEMA:
                        self._disk = dict(doc.get("entries", {}))
                except (OSError, ValueError, AttributeError):
                    pass                     # corrupt cache = no cache
        return self._disk

    def _disk_put(self, key: str, value) -> None:
        # the in-memory entries are always updated (export_entries reads
        # them); only the file write depends on a configured path
        entries = self._disk_entries()
        entries[key] = value
        p = _cache_path()
        if p is None:
            return
        try:
            tmp = f"{p}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"schema": CACHE_SCHEMA, "entries": entries}, f,
                          indent=1)
                f.write("\n")
            os.replace(tmp, p)               # atomic for concurrent readers
        except OSError:
            pass                             # read-only directory = no cache

    def export_entries(self) -> dict:
        """Every fit and race verdict this tuner knows, in the cache's
        JSON entry format."""
        return dict(self._disk_entries())

    def import_entries(self, entries: dict) -> None:
        """Warm this tuner from exported entries; entries measured here
        win (imports only fill gaps)."""
        mine = self._disk_entries()
        for k, v in dict(entries).items():
            mine.setdefault(k, v)

    def _knob_key(self, *, sort, stats, tile_m, block_v, device,
                  op="min", dtype=torch.int32, width=1) -> str:
        return (f"{device_kind(device)}|sort={sort}|stats={stats}"
                f"|tile_m={tile_m}|block_v={block_v}"
                f"|ns={list(self.ns)}|v={self.v_cal}"
                f"|op={op}|dtype={_dtype_name(dtype)}|w={width}")

    # -- measurement ------------------------------------------------------

    def _time(self, fn, state, msgs) -> float:
        """Seconds of one ``fn(state, msgs)``: the min over ``repeats``
        after ``warmup`` calls (noise only ever adds time)."""
        self.timed_runs += 1
        cuda = state.device.type == "cuda"
        for _ in range(self.warmup):
            fn(state, msgs)
        ts = []
        for _ in range(self.repeats):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(state.device)
                start.record()
                fn(state, msgs)
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                fn(state, msgs)
                ts.append(time.perf_counter() - t0)
        return min(ts)

    def _workload(self, n: int, v: int | None = None, *, op: str = "min",
                  dtype=torch.int32, width: int = 1, axis_width: int = 1,
                  device="cuda"):
        """Synthetic commit batch: n ``op``-messages into a [v] state on
        ``device`` (default ``v_cal``), drawn as the reference draws them.
        ``v`` reproduces the caller's duplicate-target factor n/v;
        ``axis_width`` > 1 a fused batch's composite-key layout (each
        message targets its own item's contiguous key range)."""
        device = resolve_device(device)
        v = min(v or self.v_cal, 1 << 20)
        rng = np.random.default_rng(0)
        shape = (v,) if width == 1 else (v, width)
        integer = not dtype.is_floating_point and dtype != torch.bool
        if op == "min":
            fill = torch.iinfo(dtype).max if integer else float("inf")
        elif op == "max":
            fill = torch.iinfo(dtype).min if integer else float("-inf")
        elif op == "first":
            fill = -1
        else:                                # add / or accumulate from 0
            fill = 0
        state = torch.full(shape, fill, dtype=dtype, device=device)
        if axis_width > 1:
            stride = max(v // axis_width, 1)
            item = rng.integers(0, axis_width, n)
            tgt = item * stride + rng.integers(0, stride, n)
        else:
            tgt = rng.integers(0, v, n)
        vshape = (n,) if width == 1 else (n, width)
        if op == "or":
            val = rng.integers(0, 2, vshape)
        elif integer:
            val = rng.integers(0, 100, vshape)
        else:
            val = rng.random(vshape)
        tgt = torch.as_tensor(tgt, device=device).to(torch.int32)
        val = torch.as_tensor(val, device=device).to(dtype)
        return state, make_messages(tgt, val)

    def calibrate(self, *, sort: bool, stats: bool, tile_m: int,
                  block_v: int, with_pallas: bool, op: str = "min",
                  dtype=torch.int32, width: int = 1,
                  device="cuda") -> Calibration:
        """Timed micro-commits -> per-tier affine fits (cached per knob
        set, device and (op, payload dtype, payload width))."""
        device = resolve_device(device)
        kind = device_kind(device)
        key = ("cal", kind, sort, stats, tile_m, block_v, with_pallas, op,
               _dtype_name(dtype), width)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        dkey = "cal|" + self._knob_key(sort=sort, stats=stats,
                                       tile_m=tile_m, block_v=block_v,
                                       device=device, op=op, dtype=dtype,
                                       width=width) \
            + f"|pallas={with_pallas}"
        disk = self._disk_entries().get(dkey)
        if disk is not None:
            try:
                cal = Calibration(
                    fine=_fit_from_json(disk["fine"]),
                    tiers=tuple((b, _fit_from_json(f))
                                for b, f in disk["tiers"]))
                self._cache[key] = cal
                return cal                   # no timed micro-commits
            except (KeyError, TypeError, ValueError):
                pass
        wl = dict(op=op, dtype=dtype, width=width, device=device)
        # fine tier: one message per activity => T_fine(N) = N * t_unit
        spec_f = CommitSpec(backend="atomic", stats=stats)
        t_unit = self._time(lambda s, m: commit(s, m, op, spec_f).state,
                            *self._workload(1, **wl))
        fine = perf_model.LinearFit(intercept=0.0, slope=t_unit, r2=1.0)
        tiers = []
        backends = [b for b in BACKENDS
                    if with_pallas or b not in KERNEL_BACKENDS]
        for b in backends:
            spec = CommitSpec(backend=b, m=None, sort=sort, stats=stats,
                              tile_m=tile_m, block_v=block_v)
            times = [self._time(lambda s, m, spec=spec:
                                commit(s, m, op, spec).state,
                                *self._workload(n, **wl))
                     for n in self.ns]
            tiers.append((b, _sanitize(perf_model.fit(self.ns, times))))
        cal = Calibration(fine=fine, tiers=tuple(tiers))
        self._cache[key] = cal
        self._disk_put(dkey, {
            "fine": _fit_to_json(fine),
            "tiers": [[b, _fit_to_json(f)] for b, f in cal.tiers]})
        self._audit({
            "event": "calibrate", "op": op, "dtype": _dtype_name(dtype),
            "width": width, "with_pallas": with_pallas, "device": kind,
            "t_unit_us": round(t_unit * 1e6, 3),
            "tiers": {b: {"intercept_us": round(f.intercept * 1e6, 3),
                          "slope_us": round(f.slope * 1e6, 4),
                          "r2": round(f.r2, 4)} for b, f in tiers}})
        return cal

    def race(self, finalists: dict, n: int, *, sort: bool, stats: bool,
             tile_m: int, block_v: int, v: int | None = None,
             op: str = "min", dtype=torch.int32, width: int = 1,
             axis_width: int = 1, device="cuda") -> str:
        """Head-to-head at (near) the workload's batch size.

        ``finalists`` maps backend -> the transaction size it would run
        with (its ladder seed M*; None = whole batch).  Tiers within
        about 20% of each other at the workload's N, or far outside the
        calibrated sizes, are timed directly (cached per power-of-two N
        bucket, clamped to 32,768 messages and 2^20 vertices) and the
        clock decides.  ``axis_width`` (lanes or graphs of a fused batch)
        keys the race and shapes its workload."""
        device = resolve_device(device)
        n = min(1 << (max(n, 2) - 1).bit_length(), 32768)
        v = min(v or self.v_cal, 1 << 20)   # the clamp of _workload, so
        #                                     the key matches what is timed
        axis_width = min(axis_width, n)
        key = ("race", device_kind(device),
               tuple(sorted(finalists.items(), key=lambda kv: kv[0])), n,
               v, sort, stats, tile_m, block_v, op, _dtype_name(dtype),
               width, axis_width)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        dkey = "race|" + "|".join(
            f"{b}:{m}" for b, m in sorted(finalists.items())) \
            + f"|n={n}|v={v}|aw={axis_width}|" \
            + self._knob_key(sort=sort, stats=stats, tile_m=tile_m,
                             block_v=block_v, device=device, op=op,
                             dtype=dtype, width=width)
        disk = self._disk_entries().get(dkey)
        if disk in finalists:                # the winner must still run
            self._cache[key] = disk
            return disk
        times = {}
        for b, m in finalists.items():
            spec = CommitSpec(backend=b, m=m, sort=sort, stats=stats,
                              tile_m=tile_m, block_v=block_v)
            times[b] = self._time(
                lambda s, msgs, spec=spec: commit(s, msgs, op, spec).state,
                *self._workload(n, v, op=op, dtype=dtype, width=width,
                                axis_width=axis_width, device=device))
        winner = min(times, key=times.get)
        self._cache[key] = winner
        self._disk_put(dkey, winner)
        self._audit({
            "event": "race", "op": op, "n": n, "v": v,
            "axis_width": axis_width,
            "finalists": {b: m for b, m in finalists.items()},
            "times_us": {b: round(t * 1e6, 2) for b, t in times.items()},
            "winner": winner})
        return winner

    # -- policy -----------------------------------------------------------

    def policy(self, spec: CommitSpec, *, n: int, pallas_ok: bool,
               v: int | None = None, op: str = "min", dtype=torch.int32,
               width: int = 1, axis_width: int = 1,
               device="cuda") -> TunerPolicy:
        pol = self._policy(spec, n=n, pallas_ok=pallas_ok, v=v, op=op,
                           dtype=dtype, width=width, axis_width=axis_width,
                           device=device)
        m0 = pol.ladder[pol.init_level] if pol.ladder else None
        self._audit({
            "event": "policy", "op": op, "n": int(n),
            "axis_width": axis_width, "backend": pol.backend,
            "m0": m0, "init_level": pol.init_level,
            "adaptive": pol.adaptive})
        return pol

    def _policy(self, spec: CommitSpec, *, n: int, pallas_ok: bool,
                v: int | None = None, op: str = "min", dtype=torch.int32,
                width: int = 1, axis_width: int = 1,
                device="cuda") -> TunerPolicy:
        """Backend + M* + ladder seed for an n-message workload against a
        [v] state (``v`` shapes the race's duplicate-target factor; None
        = the calibration default)."""
        device = resolve_device(device)
        n = max(int(n), 1)
        base = dict(sort=spec.sort, stats=spec.stats, tile_m=spec.tile_m,
                    block_v=spec.block_v)
        wl = dict(op=op, dtype=dtype, width=width, device=device)
        if not _autotune_enabled():
            # deterministic fallback: the paper's default tier (coarse
            # transactions), M* at the Fig-4 sweet spot bounded by n
            m_star = min(1024, 1 << max(n - 1, 1).bit_length())
            if spec.m is None and spec.seed_m is not None:
                m_star = spec.seed_m or n   # 0 = whole batch
            backend = "coarse"
        else:
            cal = self.calibrate(with_pallas=pallas_ok, **base, **wl)
            cap = max(min(4096, 1 << (n - 1).bit_length()), 2)

            def m_for(b):
                # the M this tier would seed its ladder with (atomic
                # ignores M -> whole batch); a pinned m wins
                if b == "atomic":
                    return None
                if spec.m is not None:
                    return spec.m
                if spec.seed_m is not None:
                    return spec.seed_m or None   # 0 = whole batch
                f = cal.tier(b) or cal.tiers[0][1]
                return perf_model.select_m(cal.fine, f, cap=cap)

            preds = {b: float(f.predict(n)) for b, f in cal.tiers}
            ranked = sorted(preds, key=preds.get)
            backend = ranked[0]
            # far beyond the calibration sizes the fits are extrapolation
            # (a noise-clamped slope of ~0 predicts constant time at any
            # n): race whenever n leaves the measured range, not only
            # when the predictions are close
            extrapolated = n > 4 * max(self.ns)
            if (len(ranked) > 1
                    and (extrapolated
                         or preds[ranked[0]] > 0.8 * preds[ranked[1]])):
                backend = self.race({b: m_for(b) for b in ranked[:2]}, n,
                                    v=v, axis_width=axis_width,
                                    **base, **wl)
            m_star = m_for(backend) or n
        if spec.m is not None:
            # a pinned transaction size: tune the backend only
            return TunerPolicy(backend=backend, ladder=(spec.m,),
                               init_level=0, adaptive=False,
                               sanitize=spec.sanitize, **base)
        if backend == "atomic":
            return TunerPolicy(backend=backend, adaptive=False,
                               sanitize=spec.sanitize, **base)
        # feedback needs conflict telemetry: stats=True, or the sorted
        # coarse path's O(N) counters; without either the density reads
        # 0 forever, so the policy stays at the calibrated static M*
        has_telemetry = spec.stats or (backend == "coarse" and spec.sort)
        level = next((i for i, m in enumerate(M_LADDER)
                      if m is not None and m >= m_star), len(M_LADDER) - 1)
        if m_star >= n:          # the whole batch fits one transaction
            level = len(M_LADDER) - 1
        return TunerPolicy(backend=backend, ladder=M_LADDER,
                           init_level=level, adaptive=has_telemetry,
                           sanitize=spec.sanitize, **base)


DEFAULT_TUNER = AutoTuner()

# The kernel tiers share one kernel-or-plain-version story (fused adds
# the route-side key computation to the same tile loop), so eligibility
# is decided for the pair.
KERNEL_BACKENDS = ("pallas", "fused")

_ALLOW_INTERP_ENV = "REPRO_AUTOTUNE_ALLOW_INTERP"


def _allow_interp() -> bool:
    """Escape hatch: let the kernel tiers' plain versions into the
    candidate set on the CPU (``REPRO_AUTOTUNE_ALLOW_INTERP=1``)."""
    return os.environ.get(_ALLOW_INTERP_ENV, "").lower() in (
        "1", "true", "on", "yes")


def _kernel_compiled(device) -> bool:
    """True when the kernel tiers launch their CUDA kernels for state on
    ``device``.  On the CPU they run the kernels' plain versions, whose
    timings would teach the cost model a lie, so both tiers stay out of
    the candidate set there (unless :data:`_ALLOW_INTERP_ENV` is set)."""
    return _allow_interp() or torch.device(device).type == "cuda"


def policy_for(spec: CommitSpec, state, msgs: Messages | None = None, *,
               n: int | None = None, op: str = "min",
               tuner: AutoTuner | None = None,
               axis_width: int = 1) -> TunerPolicy:
    """Resolve an ``"auto"`` spec against a workload's shape.

    ``state`` is a tensor, or anything with its ``shape``, ``dtype`` and
    ``device``; only those are read, and ``msgs`` is read for its
    capacity and payload dtype.  ``axis_width`` is the batch-axis width
    (query lanes or graphs) of a fused caller, kept in the race's key."""
    tuner = tuner or DEFAULT_TUNER
    width = 1
    dtype = getattr(state, "dtype", torch.int32)
    device = torch.device(getattr(state, "device", "cpu"))
    if msgs is not None:
        pallas_ok = _pallas_supported(state, msgs, op)
        n = msgs.capacity if n is None else n
        dtype = msgs.payload.dtype
        if msgs.payload.dim() > 1:
            width = int(msgs.payload.shape[1])
    else:
        pallas_ok = (len(state.shape) == 1
                     and state.dtype in (torch.int32, torch.float32))
        n = 1 if n is None else n
    if pallas_ok and not _kernel_compiled(device):
        tuner._audit({
            "event": "kernel_tiers_excluded",
            "backends": list(KERNEL_BACKENDS), "op": op,
            "reason": "no CUDA device: the kernel tiers would run their "
                      "plain versions; timings would not be the kernels'",
            "escape_hatch": _ALLOW_INTERP_ENV})
        pallas_ok = False
    v = state.shape[0] if len(state.shape) else None
    return tuner.policy(spec, n=n, pallas_ok=pallas_ok, v=v, op=op,
                        dtype=dtype, width=width, axis_width=axis_width,
                        device=device)


def resolve_spec(spec: CommitSpec, state, msgs: Messages,
                 op: str) -> CommitSpec:
    """``commit()``'s hook: an auto spec -> a concrete calibrated spec.
    A pinned ``m`` survives (the policy pins its ladder to it)."""
    pol = policy_for(spec, state, msgs, op=op)
    return pol.spec_at(pol.init_level)


# ---------------------------------------------------------------------------
# Stage 2: the conflict-feedback ladder
# ---------------------------------------------------------------------------


def ladder_commit(state, msgs: Messages, op: str, policy: TunerPolicy,
                  level: int) -> CommitResult:
    """Commit at the ladder level ``level`` (clipped to the ladder).  The
    final state does not depend on M, so the level can change from one
    commit to the next."""
    if not policy.adaptive or msgs.capacity == 0:
        return commit(state, msgs, op, policy.spec_at(policy.init_level))
    return commit(state, msgs, op, policy.spec_at(policy.clip(level)))


def ladder_fused_site(state, tgt, payload, op: str, policy: TunerPolicy,
                      level, *, lane=None, base=None, width: int = 1):
    """Fused-tier twin of :func:`ladder_commit` for the engine's owner
    side: :func:`repro_torch.core.commit.fused_commit_site` at the level
    ``level``."""
    from repro_torch.core.commit import fused_commit_site
    kw = dict(lane=lane, base=base, width=width)
    if not policy.adaptive or level is None:
        return fused_commit_site(state, tgt, payload, op,
                                 policy.spec_at(policy.init_level), **kw)
    return fused_commit_site(state, tgt, payload, op,
                             policy.spec_at(policy.clip(level)), **kw)


def next_level(policy: TunerPolicy, level: int, conflicts,
               messages) -> int:
    """One feedback step: conflict density -> ladder move.

    density > high_water (abort storm) => level - 1 (shrink M);
    density < low_water (quiet round)  => level + 1 (grow M);
    otherwise hold.  ``conflicts``/``messages`` are counts (tensors or
    ints); tensors are read in one host read.  The density is formed in
    float32, as the reference forms it, so the two packages step alike
    at the waterlines.  In a distributed run the inputs are psum'd, so
    every rank steps alike."""
    if not policy.adaptive:
        return level
    from repro_torch.obs.wavetap import host_ints
    conflicts, messages = host_ints(conflicts, messages)
    dens = np.float32(conflicts) / np.maximum(np.float32(messages),
                                              np.float32(1.0))
    step = (int(dens < np.float32(policy.low_water))
            - int(dens > np.float32(policy.high_water)))
    return policy.clip(int(level) + step)


def make_commit_step(spec: CommitSpec | None, op: str, state, msgs_like=None,
                     *, n: int | None = None, axis_width: int = 1,
                     label: str | None = None):
    """Per-round commit handle for the single-shard wave loops.

    Returns ``(step, level0)`` where ``step(state, msgs, level) ->
    (CommitResult, level')``.  For a concrete backend the level is a
    passthrough; for ``backend="auto"`` calibration seeds the ladder and
    ``step`` applies conflict feedback.  ``axis_width`` is the fused
    batch-axis width (query lanes / graphs) of the caller's wave (see
    :meth:`AutoTuner.race`).

    With tracing on (``spec.trace`` or ``REPRO_TRACE=1``, read here) the
    step carries the :mod:`repro_torch.obs.wavetap` commit tap, one
    record per commit under ``label`` (default: the op)."""
    from repro_torch.obs.trace import trace_enabled
    trace_on = trace_enabled() or (spec is not None and spec.trace)
    if spec is None or spec.backend != AUTO:
        def step(state, msgs, level, _spec=spec):
            return commit(state, msgs, op, _spec), level
        if trace_on:
            from repro_torch.obs import wavetap
            step = wavetap.tap_commit_step(
                step, label=label or op, op=op,
                backend=spec.backend if spec is not None else "default")
        return step, 0
    policy = policy_for(spec, state, msgs_like, n=n, op=op,
                        axis_width=axis_width)

    def step(state, msgs, level):
        res = ladder_commit(state, msgs, op, policy, level)
        if not policy.adaptive:
            return res, level
        return res, next_level(policy, level, res.conflicts,
                               msgs.valid.sum())

    if trace_on:
        from repro_torch.obs import wavetap
        step = wavetap.tap_commit_step(step, label=label or op, op=op,
                                       backend=policy.backend)
    return step, policy.init_level
