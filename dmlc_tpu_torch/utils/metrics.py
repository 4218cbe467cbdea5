"""Latency/accuracy metrics with percentile reporting, bounded memory.

Copied from ``dmlc_tpu/utils/metrics.py`` (the whole module).

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
"""

from __future__ import annotations

import bisect
import math
import random
import re
import threading
from typing import Callable


class Counters:
    """Thread-safe named counters + high-water gauges for overload
    observability (docs/OVERLOAD.md): shed, deadline_exceeded,
    breaker_open, gray_demotions, queue-depth high-waters, ... One instance
    per node, shared by the admission gates, the retry policy, and the
    scheduler, surfaced through ``leader.status`` and the CLI ``status``
    verb. O(1) per update; the snapshot is a plain dict for the wire."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._high: dict[str, float] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def observe_high(self, name: str, value: float) -> None:
        """Record a high-water mark: keeps the max ever observed."""
        with self._lock:
            if value > self._high.get(name, float("-inf")):
                self._high[name] = value

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> dict:
        with self._lock:
            out: dict = dict(self._counts)
            out.update({f"{k}_high": v for k, v in self._high.items()})
            return out


class TenantLabelGuard:
    """Label-cardinality bound for per-tenant metric series.

    Every per-tenant gauge/counter/lane name passes its tenant through
    ``label()`` first: the first ``max_tenants`` distinct tenants keep
    their own label, everything after folds into ``tenant="other"`` and
    increments the ``metrics_label_overflow`` counter — so a caller
    flooding the fleet with fresh tenant ids can inflate ONE bucket, not
    the registry, the scrape-tree payloads, or the Prometheus exposition
    (docs/OBSERVABILITY.md). Admission *quota* accounting deliberately
    does NOT ride this guard (cluster/tenant.TenantLedger keys on the
    real name — quotas must bind to the actual tenant); only the metrics
    plane folds. ``max_tenants <= 0`` disables the bound."""

    OTHER = "other"

    def __init__(self, max_tenants: int = 16, counters: Counters | None = None):
        self.max_tenants = int(max_tenants)
        self.counters = counters
        self._lock = threading.Lock()
        self._seen: set[str] = set()
        self.overflows = 0

    def label(self, tenant: str) -> str:
        """The bounded metrics label for ``tenant`` (sticky: a tenant that
        ever passed keeps passing; one that ever folded keeps folding)."""
        with self._lock:
            if tenant in self._seen or self.max_tenants <= 0:
                self._seen.add(tenant)
                return tenant
            if len(self._seen) < self.max_tenants:
                self._seen.add(tenant)
                return tenant
            self.overflows += 1
            if self.counters is not None:
                self.counters.inc("metrics_label_overflow")
            return self.OTHER

    def tracked(self) -> list[str]:
        with self._lock:
            return sorted(self._seen)


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


# ---------------------------------------------------------------------------
# Fleet merging: fold many mergeable snapshots into one, exactly
# ---------------------------------------------------------------------------


def merge_counter_dicts(into: dict, part: dict) -> None:
    """Fold one counters dict into an accumulator: plain counters ADD;
    ``*_high`` watermarks take the MAX (a fleet high-water mark is the
    highest any node saw, not a sum)."""
    for name, value in (part or {}).items():
        if name.endswith("_high"):
            prev = into.get(name)
            into[name] = value if prev is None else max(prev, value)
        else:
            into[name] = into.get(name, 0) + value


def merge_mergeable_snapshots(parts) -> dict:
    """Fold ``Registry.snapshot(mergeable=True)``-shaped dicts into ONE
    mergeable snapshot. Associative — a scrape-tree delegate folds its
    span's members and the leader folds delegate partials with the same
    function, and the result is counter-exact either way: counters and
    histogram bucket counts are integer sums, latency moments merge via
    Chan's update, reservoirs offer-weighted (``LatencyStats.merge``).
    Gauges SUM numeric values (fleet totals: pages free, queue depths);
    ``nodes`` counts contributors so per-node means stay recoverable."""
    counters: dict = {}
    gauges: dict = {}
    latency: dict[str, LatencyStats] = {}
    nodes = 0
    for part in parts:
        if not part:
            continue
        nodes += int(part.get("nodes", 1))
        merge_counter_dicts(counters, part.get("counters") or {})
        for name, value in (part.get("gauges") or {}).items():
            if value is None:
                continue
            gauges[name] = gauges.get(name, 0.0) + float(value)
        for name, wire in (part.get("latency") or {}).items():
            stats = latency.get(name)
            if stats is None:
                latency[name] = LatencyStats.from_wire(wire)
            else:
                stats.merge(LatencyStats.from_wire(wire))
    return {
        "counters": counters,
        "gauges": gauges,
        "latency": {n: s.to_wire() for n, s in sorted(latency.items())},
        "nodes": nodes,
    }


def summarize_mergeable(snapshot: dict) -> dict:
    """Convert a mergeable snapshot to the standard render shape (latency
    wire records -> ``summary()`` dicts), so CLI / Prometheus /
    ``CostProfiler.ingest_scrape`` consumers see exactly what a direct
    ``Registry.snapshot()`` would have handed them."""
    out = dict(snapshot)
    out["latency"] = {
        n: LatencyStats.from_wire(w).summary()
        for n, w in sorted((snapshot.get("latency") or {}).items())
    }
    return out


# ---------------------------------------------------------------------------
# Registry: one node's whole metric surface behind one snapshot
# ---------------------------------------------------------------------------

_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(prefix: str, name: str) -> str:
    return f"{prefix}_{_PROM_NAME_RE.sub('_', name)}"


class Registry:
    """Unifies a node's ``Counters``, named ``LatencyStats``, and gauges
    behind ONE snapshot (docs/OBSERVABILITY.md) — the payload of the
    ``obs.metrics`` RPC the leader scrapes fleet-wide, and the source of
    the Prometheus text exposition.

    Naming conventions: counters and gauges are ``snake_case`` (gauges
    suffixed with the thing they measure, e.g. ``predict_gate_active``);
    latency collectors are ``component/verb`` like span names. Gauges are
    registered as zero-arg callables read at snapshot time — a gauge whose
    read raises reports ``None`` rather than failing the scrape.
    """

    def __init__(self, counters: Counters | None = None):
        self.counters = counters if counters is not None else Counters()
        self._latency: dict[str, LatencyStats] = {}
        self._gauges: dict[str, Callable[[], float]] = {}
        self._lock = threading.Lock()

    def latency(self, name: str) -> LatencyStats:
        """The named latency collector, created on first use."""
        with self._lock:
            stats = self._latency.get(name)
            if stats is None:
                stats = self._latency[name] = LatencyStats()
            return stats

    def gauge(self, name: str, read: Callable[[], float]) -> None:
        with self._lock:
            self._gauges[name] = read

    def snapshot(self, mergeable: bool = False) -> dict:
        """Wire-shaped view of everything: ``{"counters": {...},
        "gauges": {...}, "latency": {name: summary}}``. With ``mergeable``
        the latency section carries ``LatencyStats.to_wire()`` records
        instead of summaries — the exact-merge form scrape-tree delegates
        request so span partials fold counter-exactly into one fleet
        snapshot (docs/OBSERVABILITY.md §6)."""
        with self._lock:
            if mergeable:
                latency = {n: s.to_wire() for n, s in sorted(self._latency.items())}
            else:
                latency = {n: s.summary() for n, s in sorted(self._latency.items())}
            gauges: dict = {}
            for name, read in sorted(self._gauges.items()):
                try:
                    gauges[name] = float(read())
                except Exception:
                    gauges[name] = None  # a broken gauge must not fail the scrape
        return {"counters": self.counters.snapshot(), "gauges": gauges,
                "latency": latency}

    def prometheus_text(self, prefix: str = "dmlc", labels: str = "") -> str:
        """Prometheus text-format exposition of ``snapshot()``. ``labels``
        is a pre-rendered label body (e.g. ``node="10.0.0.1:8852"``) the
        fleet exposition uses to distinguish scraped nodes."""
        return render_prometheus(self.snapshot(), prefix=prefix, labels=labels)


def render_prometheus(snapshot: dict, prefix: str = "dmlc", labels: str = "") -> str:
    """Render one ``Registry.snapshot()``-shaped dict as Prometheus text.
    Module-level so the leader can render snapshots it scraped off other
    nodes (cluster/observe.py) identically to local ones."""
    body = f"{{{labels}}}" if labels else ""

    def qbody(extra: str) -> str:
        inner = ",".join(x for x in (labels, extra) if x)
        return f"{{{inner}}}"

    lines: list[str] = []
    for name, value in sorted((snapshot.get("counters") or {}).items()):
        metric = _prom_name(prefix, name)
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric}{body} {value}")
    for name, value in sorted((snapshot.get("gauges") or {}).items()):
        if value is None:
            continue
        metric = _prom_name(prefix, name)
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric}{body} {value}")
    for name, s in sorted((snapshot.get("latency") or {}).items()):
        metric = _prom_name(prefix, name) + "_seconds"
        lines.append(f"# TYPE {metric} summary")
        for q, key in (("0.5", "median"), ("0.9", "p90"), ("0.95", "p95"),
                       ("0.99", "p99")):
            v = s.get(key)
            if v is not None and not math.isnan(v):
                qlabel = f'quantile="{q}"'
                lines.append(f"{metric}{qbody(qlabel)} {v}")
        count = s.get("count", 0.0)
        mean = s.get("mean", float("nan"))
        lines.append(f"{metric}_count{body} {int(count)}")
        if count and not math.isnan(mean):
            lines.append(f"{metric}_sum{body} {mean * count}")
        # Sibling histogram family: exact cumulative bucket counts (lossless
        # under cross-node aggregation, unlike quantiles). Emitted only when
        # the buckets cover every observation — a legacy peer's snapshot
        # without buckets must not render a histogram that contradicts its
        # own _count.
        buckets = s.get("buckets") or {}
        total = buckets.get("+Inf", 0)
        if total and total == int(count):
            hist = _prom_name(prefix, name) + "_hist_seconds"
            lines.append(f"# TYPE {hist} histogram")
            for le, cum in buckets.items():
                lelabel = f'le="{le}"'
                lines.append(f"{hist}_bucket{qbody(lelabel)} {int(cum)}")
            lines.append(f"{hist}_count{body} {total}")
            if not math.isnan(mean):
                lines.append(f"{hist}_sum{body} {mean * count}")
    return "\n".join(lines) + ("\n" if lines else "")
