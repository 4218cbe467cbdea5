"""Live cost profiles: rolling per-(model x member x stage) latency/throughput.

Copied from ``dmlc_tpu/cluster/profile.py`` (the whole module): the
snapshot's wire form is the JAX package's, so a profile saved by either
package warm-starts the other's ``CostProfiler.load``.

ROADMAP item 4's gap was that the observability plane (tracing, metrics,
flight recorder) only *reported* — nothing acted on measured cost. This
module is the acting half's data plane: a ``CostProfiler`` folds the two
streams the plane already produces —

- **direct records** from the leader's dispatch path and the generation
  worker's decode loop (``record()``: one measured duration, optionally
  amortized over N queries), and
- **fleet scrapes** (``ingest_scrape()``: the cumulative per-span
  aggregates inside an ``obs.metrics`` reply, differenced against the last
  scrape so each pass contributes only its delta)

— into rolling time windows keyed by (model, member, stage). Stages follow
the pipeline the tracer already names: ``decode`` (host JPEG decode),
``stage`` (gang decode prefetch), ``dispatch`` (leader-measured shard RTT),
``compute`` (device forward), ``gen/step`` (one continuous-batching decode
step), ``predict`` (member-side RPC service time). Scrape-derived records
carry model ``"*"`` — span aggregates are not split per model, and a
wildcard lane must not pollute per-model SLO math.

Queries (decayed mean, weighted p50/p99, fraction-over-threshold,
throughput) weight each window by ``decay ** age`` so the profile tracks
the fleet's *current* shape while keeping enough history for burn-rate
math over multi-window horizons (scheduler/placement.py).

Sans-IO like the rest of cluster/: the clock is injected (virtual in
tests), the per-window sample reservoir draws from a seeded PRNG, and
persistence goes through ``diskio.atomic_write``. Snapshots store window
*ages* rather than absolute epochs, so a restarted node re-anchors the
warm-started profile at its own clock zero instead of resurrecting stale
epochs into the future.
"""

from __future__ import annotations

import json
import logging
import math
import random
import threading
from collections import deque
from pathlib import Path
from time import monotonic
from typing import Callable, Iterator

from dmlc_tpu_torch.cluster.diskio import atomic_write

log = logging.getLogger(__name__)

# Tracer span name -> pipeline stage (docs/OBSERVABILITY.md lists both).
SPAN_STAGES: dict[str, str] = {
    "host/decode": "decode",
    "rpc/job.decode": "decode",
    "rpc/job.decode_gang": "stage",
    "scheduler/dispatch": "dispatch",
    "scheduler/dispatch_gang": "dispatch",
    "device/forward": "compute",
    "device/forward_global": "compute",
    "gen/step": "gen/step",
    "rpc/job.predict": "predict",
}

# Model key for scrape-derived records: span aggregates are fleet totals,
# not per-model, and must never be mistaken for a model's own lane.
ANY_MODEL = "*"


class _Window:
    """One window's exact moments + a bounded sample reservoir (Algorithm R;
    ``offers`` is the denominator, so a full window stays a uniform sample
    of everything offered into it, not a recency slice)."""

    __slots__ = ("epoch", "count", "total", "samples", "offers")

    def __init__(self, epoch: int, count: int = 0, total: float = 0.0,
                 samples: list[float] | None = None, offers: int = 0):
        self.epoch = epoch
        self.count = count
        self.total = total
        self.samples: list[float] = samples if samples is not None else []
        self.offers = offers


class CostProfiler:
    """Rolling windowed cost profiles, thread-safe, leaf-locked (safe to
    call under the scheduler lock; never calls out under its own)."""

    WINDOW_SAMPLES = 256  # reservoir bound per (key, window)

    def __init__(
        self,
        window_s: float = 30.0,
        windows: int = 16,
        decay: float = 0.7,
        clock: Callable[[], float] = monotonic,
        seed: int = 0xF0F1,
    ):
        self.window_s = float(window_s)
        self.windows = int(windows)
        self.decay = float(decay)
        self.clock = clock
        self._rng = random.Random(seed)
        self._keys: dict[tuple[str, str, str], deque[_Window]] = {}
        # (member, span_name) -> (cumulative_count, cumulative_total_s) at
        # the last scrape, for delta ingestion with reset detection.
        self._scrape_cursor: dict[tuple[str, str], tuple[int, float]] = {}
        self._lock = threading.Lock()

    # ---- recording -----------------------------------------------------

    def _epoch(self) -> int:
        return int(self.clock() // self.window_s)

    def record(self, model: str, member: str, stage: str, seconds: float,
               count: int = 1) -> None:
        """Fold one measured duration in. ``count`` > 1 means the duration
        amortizes over that many queries (a shard, a scrape delta): the
        moments weight by count, the reservoir takes one offer."""
        if count <= 0:
            return
        seconds = float(seconds)
        with self._lock:
            epoch = self._epoch()
            dq = self._keys.setdefault(
                (model, member, stage), deque(maxlen=self.windows)
            )
            if not dq or dq[-1].epoch != epoch:
                dq.append(_Window(epoch))
            w = dq[-1]
            w.count += int(count)
            w.total += seconds * int(count)
            w.offers += 1
            if len(w.samples) < self.WINDOW_SAMPLES:
                w.samples.append(seconds)
            else:
                j = self._rng.randrange(w.offers)
                if j < self.WINDOW_SAMPLES:
                    w.samples[j] = seconds

    def ingest_scrape(self, member: str, reply: dict) -> int:
        """Fold one ``obs.metrics`` reply in: the per-span cumulative
        aggregates (``tracer.summary()`` shape: count/mean per name) are
        differenced against this member's previous scrape, and each span's
        delta lands as one amortized record under model ``"*"``. A
        cumulative count that *dropped* means the member restarted or its
        tracer was reset — the cursor re-anchors and the fresh cumulative
        counts as the first delta. Returns the number of records folded."""
        spans = reply.get("spans") or {}
        folded = 0
        for span_name, agg in spans.items():
            stage = SPAN_STAGES.get(span_name)
            if stage is None or not isinstance(agg, dict):
                continue
            try:
                cum_n = int(agg["count"])
                cum_total = float(agg["mean"]) * cum_n
            except (KeyError, TypeError, ValueError):
                continue
            cursor = (member, span_name)
            with self._lock:
                prev = self._scrape_cursor.get(cursor)
                self._scrape_cursor[cursor] = (cum_n, cum_total)
            if prev is not None and cum_n >= prev[0]:
                dn, dt = cum_n - prev[0], cum_total - prev[1]
            else:  # first sight, or reset: the whole cumulative is the delta
                dn, dt = cum_n, cum_total
            if dn > 0 and dt >= 0.0 and math.isfinite(dt):
                self.record(ANY_MODEL, member, stage, dt / dn, count=dn)
                folded += 1
        return folded

    # ---- queries -------------------------------------------------------

    def _iter_windows(
        self, model: str | None, member: str | None, stage: str | None,
        horizon_s: float | None,
    ) -> Iterator[tuple[tuple[str, str, str], _Window, float]]:
        """Matching (key, window, weight) triples; weight decays by window
        age and drops to zero past the horizon. Caller holds the lock."""
        now_epoch = self._epoch()
        max_age = self.windows if horizon_s is None else max(
            1, math.ceil(horizon_s / self.window_s)
        )
        for key, dq in self._keys.items():
            m, mem, st = key
            if model is not None and m != model:
                continue
            if member is not None and mem != member:
                continue
            if stage is not None and st != stage:
                continue
            for w in dq:
                age = now_epoch - w.epoch
                if 0 <= age < max_age and w.count:
                    yield key, w, self.decay ** age

    def mean_cost(
        self, member: str, stage: str = "dispatch", model: str | None = None,
        horizon_s: float | None = None,
    ) -> float | None:
        """Decay-weighted mean duration, or None with no data — the
        placement advisor's cost signal."""
        with self._lock:
            num = den = 0.0
            for _, w, wt in self._iter_windows(model, member, stage, horizon_s):
                num += w.total * wt
                den += w.count * wt
            return num / den if den else None

    def percentile(
        self, p: float, model: str | None = None, member: str | None = None,
        stage: str | None = None, horizon_s: float | None = None,
    ) -> float:
        """Weighted nearest-rank percentile over the matching reservoirs.
        Each sample stands in for ``count / len(samples)`` observations of
        its window (restoring multiplicity the reservoir bounded away),
        scaled by the window's decay weight. NaN with no data."""
        with self._lock:
            weighted: list[tuple[float, float]] = []
            for _, w, wt in self._iter_windows(model, member, stage, horizon_s):
                if not w.samples:
                    continue
                per = wt * w.count / len(w.samples)
                weighted.extend((s, per) for s in w.samples)
        if not weighted:
            return float("nan")
        weighted.sort()
        total = sum(wt for _, wt in weighted)
        target = max(0.0, min(100.0, p)) / 100.0 * total
        acc = 0.0
        for value, wt in weighted:
            acc += wt
            if acc >= target:
                return value
        return weighted[-1][0]

    def frac_over(
        self, threshold: float, model: str | None = None,
        member: str | None = None, stage: str | None = None,
        horizon_s: float | None = None,
    ) -> float:
        """Decay-weighted fraction of observations exceeding ``threshold``
        — the SLO evaluator's bad-event rate. 0.0 with no data (no
        evidence is not a violation)."""
        with self._lock:
            over = den = 0.0
            for _, w, wt in self._iter_windows(model, member, stage, horizon_s):
                if not w.samples:
                    continue
                frac = sum(1 for s in w.samples if s > threshold) / len(w.samples)
                over += wt * w.count * frac
                den += wt * w.count
            return over / den if den else 0.0

    def throughput(
        self, model: str | None = None, member: str | None = None,
        stage: str | None = None, horizon_s: float | None = None,
    ) -> float:
        """Observations/second over the (undecayed) horizon actually
        covered — a rate, so decay weighting would misstate it."""
        with self._lock:
            now_epoch = self._epoch()
            max_age = self.windows if horizon_s is None else max(
                1, math.ceil(horizon_s / self.window_s)
            )
            count = 0
            oldest = -1
            for _, w, _wt in self._iter_windows(model, member, stage, horizon_s):
                count += w.count
                oldest = max(oldest, now_epoch - w.epoch)
            if count == 0:
                return 0.0
            span = min(max_age, oldest + 1) * self.window_s
            return count / span if span > 0 else 0.0

    def members(self, model: str | None = None, stage: str | None = None) -> list[str]:
        with self._lock:
            out = {
                mem for (m, mem, st), dq in self._keys.items()
                if dq and (model is None or m == model)
                and (stage is None or st == stage)
            }
        return sorted(out)

    def snapshot(self) -> dict:
        """The ``obs.profile`` reply: every (model, member, stage) lane's
        decayed mean/p50/p99/count/throughput, JSON-wire-shaped."""
        with self._lock:
            keys = sorted(self._keys)
        profiles: dict = {}
        for model, member, stage in keys:
            mean = self.mean_cost(member, stage=stage, model=model)
            if mean is None:
                continue
            lane = profiles.setdefault(model, {}).setdefault(member, {})
            lane[stage] = {
                "n": self._lane_count(model, member, stage),
                "mean": mean,
                "p50": self.percentile(50, model=model, member=member, stage=stage),
                "p99": self.percentile(99, model=model, member=member, stage=stage),
                "qps": self.throughput(model=model, member=member, stage=stage),
            }
        return {
            "window_s": self.window_s,
            "windows": self.windows,
            "decay": self.decay,
            "profiles": profiles,
        }

    def _lane_count(self, model: str, member: str, stage: str) -> int:
        with self._lock:
            return sum(
                w.count for _, w, _wt in self._iter_windows(model, member, stage, None)
            )

    # ---- persistence (restart warm-start) ------------------------------

    def to_wire(self) -> dict:
        """Relative-age form: each window carries ``age`` (now_epoch -
        epoch), not the absolute epoch — absolute epochs are meaningless
        under a different clock zero after restart."""
        with self._lock:
            now_epoch = self._epoch()
            lanes = []
            for (model, member, stage), dq in sorted(self._keys.items()):
                ws = [
                    {"age": now_epoch - w.epoch, "count": w.count,
                     "total": w.total, "samples": list(w.samples),
                     "offers": w.offers}
                    for w in dq if w.count and now_epoch - w.epoch >= 0
                ]
                if ws:
                    lanes.append({"model": model, "member": member,
                                  "stage": stage, "windows": ws})
            return {"version": 1, "window_s": self.window_s, "lanes": lanes}

    def adopt_wire(self, wire: dict) -> int:
        """Warm-start from a persisted snapshot: ages re-anchor against
        THIS clock's current epoch. A snapshot from a different window size
        is discarded (its ages measure different spans). Returns lanes
        adopted."""
        if float(wire.get("window_s", -1.0)) != self.window_s:
            return 0
        adopted = 0
        with self._lock:
            now_epoch = self._epoch()
            for lane in wire.get("lanes", ()):
                key = (str(lane["model"]), str(lane["member"]), str(lane["stage"]))
                dq = self._keys.setdefault(key, deque(maxlen=self.windows))
                existing = {w.epoch for w in dq}
                restored = []
                for w in lane.get("windows", ()):
                    age = int(w["age"])
                    if not (0 <= age < self.windows):
                        continue
                    epoch = now_epoch - age
                    if epoch in existing:
                        continue
                    restored.append(_Window(
                        epoch, count=int(w["count"]), total=float(w["total"]),
                        samples=[float(s) for s in w.get("samples", [])],
                        offers=int(w.get("offers", len(w.get("samples", [])))),
                    ))
                if restored:
                    merged = sorted([*dq, *restored], key=lambda w: w.epoch)
                    dq.clear()
                    dq.extend(merged[-self.windows:])
                    adopted += 1
        return adopted

    def save(self, path: str | Path) -> bool:
        """Persist for restart warm-start (temp -> fsync -> rename).
        Best-effort by contract: a full disk must not break the scrape
        loop. Returns whether the write landed."""
        try:
            atomic_write(Path(path), json.dumps(self.to_wire()).encode())
            return True
        except OSError:
            log.warning("profile save to %s failed", path, exc_info=True)
            return False

    def load(self, path: str | Path) -> int:
        """Warm-start from ``save()`` output; 0 lanes on a missing or
        unreadable snapshot (a corrupt profile must not block boot)."""
        try:
            wire = json.loads(Path(path).read_text())
        except (OSError, ValueError):
            return 0
        try:
            return self.adopt_wire(wire)
        except (KeyError, TypeError, ValueError):
            log.warning("profile snapshot %s malformed; starting cold", path)
            return 0


__all__ = ["ANY_MODEL", "SPAN_STAGES", "CostProfiler"]
