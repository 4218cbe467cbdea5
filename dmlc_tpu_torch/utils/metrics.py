"""Latency/accuracy metrics with percentile reporting, bounded memory.

Capability parity with the reference's ``jobs`` report, which aggregates
per-query wall-clock durations into mean/std/median/p90/p95/p99 via the
``histogram`` crate (reference: src/main.rs:282-309) and tracks
correct/finished counts per job (src/services.rs:74-80).

Unlike the reference's grow-forever Vec of durations (services.rs:78), this
collector is O(1) memory at any query volume: count/mean/std come from exact
Welford moments, percentiles from a fixed-size reservoir (Algorithm R with a
deterministic PRNG so simulator runs reproduce). That also bounds the wire
payload standby leaders mirror every probe interval — at the >10k img/s
target an exact sample list would cross the RPC frame limit within hours.

Only ``LatencyStats`` is carried here; the counters, the registry and the
Prometheus rendering come with the node wiring.
"""

from __future__ import annotations

import bisect
import math
import random


class LatencyStats:
    """Streaming duration collector (seconds) with percentile summary."""

    RESERVOIR_SIZE = 4096
    # Fixed log-spaced histogram bounds (seconds). Exact per-bucket counts
    # complement the reservoir quantiles: buckets aggregate losslessly
    # across nodes and ship as a proper Prometheus histogram family, so
    # fleet-wide p99 can be computed server-side (histogram_quantile) even
    # where a merged reservoir would be an approximation of approximations.
    BUCKET_BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

    def __init__(self, samples: list[float] | None = None):
        self.n = 0
        self._mean = 0.0
        self._m2 = 0.0
        self.reservoir: list[float] = []
        self._offers = 0  # reservoir offers seen (Algorithm R denominator)
        self._rng = random.Random(0xD31C)
        # Per-bucket (non-cumulative) counts; the last slot is +Inf overflow.
        self.buckets = [0] * (len(self.BUCKET_BOUNDS) + 1)
        if samples:
            self.extend(samples)

    # ---- recording -----------------------------------------------------

    def record(self, seconds: float) -> None:
        self._moments_add(float(seconds), 1)
        self._reservoir_offer(float(seconds))

    def record_many(self, seconds: float, count: int) -> None:
        """Record ``count`` queries that shared one measured duration (a
        shard's amortized per-query latency). Moments are exact; the
        reservoir takes one representative offer per call, which keeps
        every shard equally weighted in the percentile sketch."""
        if count <= 0:
            return
        self._moments_add(float(seconds), int(count))
        self._reservoir_offer(float(seconds))

    def extend(self, seconds: list[float]) -> None:
        for s in seconds:
            self.record(float(s))

    def _moments_add(self, value: float, count: int) -> None:
        # Chan et al. parallel update: fold `count` copies of `value` in.
        n2 = self.n + count
        delta = value - self._mean
        self._mean += delta * count / n2
        self._m2 += delta * delta * count * self.n / n2
        self.n = n2
        # bisect_left puts value == bound in that bound's bucket (le=bound).
        self.buckets[bisect.bisect_left(self.BUCKET_BOUNDS, value)] += count

    def _reservoir_offer(self, value: float) -> None:
        # Algorithm R: the i-th offer is kept with probability K/i, so the
        # reservoir stays a uniform sample of ALL offers, not a recency
        # window. The denominator is offers-so-far, not reservoir size.
        self._offers += 1
        if len(self.reservoir) < self.RESERVOIR_SIZE:
            self.reservoir.append(value)
            return
        j = self._rng.randrange(self._offers)
        if j < self.RESERVOIR_SIZE:
            self.reservoir[j] = value

    # ---- queries -------------------------------------------------------

    def __len__(self) -> int:
        return self.n

    @property
    def mean(self) -> float:
        return self._mean if self.n else float("nan")

    @property
    def std(self) -> float:
        if self.n == 0:
            return float("nan")
        if self.n < 2:
            return 0.0
        return math.sqrt(self._m2 / (self.n - 1))

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the reservoir, p in [0, 100]."""
        if not self.reservoir:
            return float("nan")
        xs = sorted(self.reservoir)
        rank = max(1, math.ceil(p / 100.0 * len(xs)))
        return xs[min(rank, len(xs)) - 1]

    def summary(self) -> dict:
        """The reference's report shape (mean/std/median/p90/p95/p99) plus
        cumulative histogram bucket counts keyed by upper bound (``le``
        semantics; ``"+Inf"`` last) — the exact counterpart the Prometheus
        exposition renders as a histogram family."""
        cum, buckets = 0, {}
        for bound, count in zip(self.BUCKET_BOUNDS, self.buckets):
            cum += count
            buckets[repr(bound)] = cum
        buckets["+Inf"] = cum + self.buckets[-1]
        return {
            "count": float(self.n),
            "mean": self.mean,
            "std": self.std,
            "median": self.percentile(50),
            "p90": self.percentile(90),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "buckets": buckets,
        }

    def merge(self, other: "LatencyStats") -> None:
        if other.n == 0:
            return
        n2 = self.n + other.n
        delta = other._mean - self._mean
        self._mean += delta * other.n / n2
        self._m2 += other._m2 + delta * delta * self.n * other.n / n2
        self.n = n2
        self.buckets = [a + b for a, b in zip(self.buckets, other.buckets)]
        self._merge_reservoirs(other)

    def _merge_reservoirs(self, other: "LatencyStats") -> None:
        """WEIGHTED reservoir merge. Each side's reservoir is a uniform
        sample of ``_offers`` underlying observations. Offering ``other``'s
        elements one by one into Algorithm R (the old code) ignored that
        multiplicity and under-weighted any peer whose offer count exceeds
        its reservoir size — a member that served 100k queries merged like
        one that served 4k.

        Correct merge: a uniform sample of the UNION stream. When both
        reservoirs are exact (every offer kept) and fit, the union IS that
        sample. Otherwise each merged slot picks a side with probability
        proportional to its offer count and a uniform element from that
        side's reservoir — expected composition exactly matches the true
        mixture for any weights (with-replacement within a side is fine:
        each reservoir already stands in for its whole stream). Drawn from
        this instance's seeded PRNG so merges stay deterministic."""
        if not other.reservoir:
            return
        mine, theirs = self.reservoir, other.reservoir
        na, nb = self._offers, other._offers
        if na == len(mine) and nb == len(theirs) and na + nb <= self.RESERVOIR_SIZE:
            mine.extend(theirs)
            self._offers = na + nb
            return
        # One side inexact implies its offers exceed RESERVOIR_SIZE, so
        # na + nb > RESERVOIR_SIZE here and the merged sample is full-size.
        p_other = nb / (na + nb)
        self.reservoir = [
            theirs[self._rng.randrange(len(theirs))]
            if (not mine or self._rng.random() < p_other)
            else mine[self._rng.randrange(len(mine))]
            for _ in range(self.RESERVOIR_SIZE)
        ]
        self._offers = na + nb

    # ---- wire ----------------------------------------------------------

    def to_wire(self) -> dict:
        return {
            "n": self.n,
            "mean": self._mean,
            "m2": self._m2,
            "offers": self._offers,
            "reservoir": list(self.reservoir),
            "buckets": list(self.buckets),
        }

    @classmethod
    def from_wire(cls, w) -> "LatencyStats":
        if isinstance(w, list):  # legacy raw-sample form
            return cls(samples=w)
        out = cls()
        out.n = int(w["n"])
        out._mean = float(w["mean"])
        out._m2 = float(w["m2"])
        out.reservoir = [float(x) for x in w["reservoir"]][: cls.RESERVOIR_SIZE]
        out._offers = int(w.get("offers", len(out.reservoir)))
        # Pre-histogram peers omit buckets; their counts stay zero (the
        # renderer skips a histogram whose bucket total lags n).
        wb = w.get("buckets")
        if wb is not None and len(wb) == len(out.buckets):
            out.buckets = [int(x) for x in wb]
        return out
