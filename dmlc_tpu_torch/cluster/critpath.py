"""Per-request critical-path attribution: spans -> named culprits.

Copied from ``dmlc_tpu/cluster/critpath.py`` (the whole module): the
snapshot and table forms are the JAX package's, so a leader of either
package folds the other's members. ``ingest_tracer`` drains the tracer it
is given; this package's ``ObsService`` gives it this package's tracer.

The trace plane (utils/tracing + cluster/observe) already records every
sampled request as a span DAG — trace/span/parent ids and the executing
``lane`` ride the wire on every hop. What it does NOT say is *where the
time went*: an ``slo_fast_burn`` names a model, a profile lane names a
mean, but neither says which stage on which member actually gated p99.

This module closes that gap (docs/OBSERVABILITY.md §9):

- **Extraction** — ``critical_path`` reconstructs one request's span tree
  and walks it BACKWARDS from the root's end, charging each instant to
  the span that was blocking completion then. Overlapped children
  (prefetch/dispatch pipelining, gang fan-out, decode-tier fan-out) are
  concurrent by construction: only the chain through the latest-ending
  child — the max lane — is charged, so per-request self-times partition
  the root's wall time exactly (sum of stage shares == 1.0, never more).
  Gang fan-out therefore charges the slowest rank; faster ranks that
  finished under its shadow charge nothing.
- **Aggregation** — ``CritPathAnalyzer`` folds charged traces into
  rolling per-(model, stage, member) *critical-path seconds* windows with
  decay-weighted totals and reservoir p50/p99 self-time, served as the
  ``critpath`` block of ``obs.metrics`` and the ``obs.critpath`` verb.
- **Fleet fold** — ``FleetCritPath`` merges member snapshots on the
  leader's scrape cycle into one fleet table, and ``culprit`` names the
  top (stage, member, critpath_share) per model — what the SloEvaluator
  attaches to every burn alert and the drift sentinel
  (cluster/sentinel.py) watches for quantile shift.

Ownership: a trace is charged ONCE fleet-wide, by the node whose lane
executed its root span (unlaned roots are claimed by the leader). A
member holding only an orphan subtree of a remotely-rooted trace never
charges it — the root owner's covering span (e.g. ``scheduler/dispatch``)
already accounts for that wall time, and charging both would double-count.
Orphan spans *inside* a rooted trace (their parent dropped by the
sampling budget or ring overflow) attach under a virtual root next to the
real one: the backwards walk charges whatever part of the orphan subtree
extends beyond the covered chain, degrading attribution gracefully
instead of crashing or skewing shares past 1.0.

Sans-IO like the rest of cluster/: injected clock, seeded reservoir PRNG,
no RPC — the leader and the loadgen sim harness drive the same code.
"""

from __future__ import annotations

import math
import random
import threading
from collections import deque
from dataclasses import dataclass
from time import monotonic
from typing import Any, Callable, Iterable, Iterator

from dmlc_tpu_torch.cluster.profile import ANY_MODEL, SPAN_STAGES

# Stage charged for uncovered hull time when a trace has several top-level
# spans (virtual-root gaps); member "?" marks a span with no lane.
GAP_STAGE = "(gap)"
UNKNOWN_MEMBER = "?"
# The merged fleet timeline's synthetic orphan adopter
# (observe.FleetTraceMerger) — its self-time is coverage gap, not work.
ORPHAN_ROOT_NAME = "trace/orphan_root"
# Span attrs that name the request's model (the dispatch path stamps
# ``job=``, the loadgen/CLI roots stamp ``model=``).
_MODEL_ATTRS = ("model", "job")


def stage_of(name: str) -> str:
    """Pipeline stage for a span name: the profiler's SPAN_STAGES mapping
    where it applies, else the raw span name — unmapped time must stay
    visible under its own label, never fold into a catch-all. The merged
    timeline's synthetic orphan roots are coverage gap, not work."""
    if name == ORPHAN_ROOT_NAME:
        return GAP_STAGE
    return SPAN_STAGES.get(name, name)


@dataclass
class Span:
    """One normalized span interval (seconds, any consistent timebase)."""

    __slots__ = ("name", "start", "end", "span_id", "parent_id", "trace_id",
                 "lane", "model")

    name: str
    start: float
    end: float
    span_id: str
    parent_id: str | None
    trace_id: str
    lane: str | None
    model: str | None


# ---------------------------------------------------------------------------
# Normalization: wire dumps and merged Perfetto docs -> per-trace span lists
# ---------------------------------------------------------------------------


def _span_model(attrs: dict[str, Any] | None) -> str | None:
    for key in _MODEL_ATTRS:
        value = (attrs or {}).get(key)
        if isinstance(value, str) and value:
            return value
    return None


def spans_from_wire(events: Iterable[dict[str, Any]]) -> dict[str, list[Span]]:
    """Group ``Tracer.events_wire`` / ``obs.trace_dump`` events by trace.
    Events without trace/span ids (tracing context absent) are skipped —
    they belong to no request."""
    out: dict[str, list[Span]] = {}
    for e in events:
        trace, span = e.get("trace"), e.get("span")
        if not trace or not span:
            continue
        start = float(e.get("start", 0.0))
        dur = max(0.0, float(e.get("dur", 0.0)))
        parent = e.get("parent") or None
        out.setdefault(str(trace), []).append(Span(
            name=str(e.get("name", "")), start=start, end=start + dur,
            span_id=str(span), parent_id=str(parent) if parent else None,
            trace_id=str(trace), lane=e.get("lane"),
            model=_span_model(e.get("attrs")),
        ))
    return out


def spans_from_perfetto(doc: dict[str, Any]) -> dict[str, list[Span]]:
    """Group a merged fleet trace document (cluster/observe.py export:
    phase-X events, microsecond timestamps, ids under ``args``) by trace."""
    out: dict[str, list[Span]] = {}
    for e in doc.get("traceEvents", ()):
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        trace, span = args.get("trace"), args.get("span")
        if not trace or not span:
            continue
        start = float(e.get("ts", 0.0)) / 1e6
        dur = max(0.0, float(e.get("dur", 0.0))) / 1e6
        parent = args.get("parent") or None
        out.setdefault(str(trace), []).append(Span(
            name=str(e.get("name", "")), start=start, end=start + dur,
            span_id=str(span), parent_id=str(parent) if parent else None,
            trace_id=str(trace), lane=args.get("lane"),
            model=_span_model(args),
        ))
    return out


# ---------------------------------------------------------------------------
# Extraction: the blocking critical path of one trace
# ---------------------------------------------------------------------------


@dataclass
class TracePath:
    """One trace's charged critical path: ``charges`` partition the root's
    wall time ([span, blocking seconds] pairs), ``model`` is the request's
    resolved model, ``orphans`` counts spans whose parent was missing."""

    __slots__ = ("charges", "total_s", "model", "orphans", "lanes")

    charges: list[tuple[Span, float]]
    total_s: float
    model: str
    orphans: int
    lanes: set[str]


def _charge(
    span: Span,
    floor: float,
    frontier_end: float,
    children: dict[str, list[Span]],
    out: list[tuple[Span, float]],
    visited: set[str],
) -> None:
    """Charge the interval [max(span.start, floor), frontier_end] walking
    backwards: the latest-ending child blocks the tail it covers,
    earlier-ending overlapped children are concurrent shadow (uncharged),
    gaps between children are the span's own self-time. ``floor`` clamps a
    child recorded before its parent's start (clock skew, late flush) so
    charges always partition the root's own wall interval exactly."""
    lo = max(span.start, floor)
    t = min(span.end, frontier_end)
    if t <= lo:
        return
    kids = sorted(
        children.get(span.span_id, ()),
        key=lambda c: (c.end, c.start, c.span_id), reverse=True,
    )
    for child in kids:
        if child.span_id in visited:
            continue  # malformed cycle guard: a span blocks at most once
        c_end = min(child.end, t)
        c_start = max(child.start, lo)
        if c_end <= c_start:
            continue  # fully shadowed by a later-ending sibling, or empty
        if c_end < t:
            out.append((span, t - c_end))  # self-time gap after the child
        visited.add(child.span_id)
        _charge(child, c_start, c_end, children, out, visited)
        t = c_start
        if t <= lo:
            return
    if t > lo:
        out.append((span, t - lo))


def critical_path(spans: list[Span]) -> TracePath | None:
    """Extract one trace's blocking critical path. Returns None for an
    empty or zero-width trace. Multiple top-level spans (several true
    roots, or orphans whose parent never arrived) are charged under a
    virtual root spanning their hull — overlap between them still charges
    only the latest-ending chain, so shares can never exceed 1.0."""
    by_id = {s.span_id: s for s in spans}
    children: dict[str, list[Span]] = {}
    tops: list[Span] = []
    orphans = 0
    for s in spans:
        if s.parent_id and s.parent_id != s.span_id and s.parent_id in by_id:
            children.setdefault(s.parent_id, []).append(s)
        else:
            if s.parent_id:
                orphans += 1
            tops.append(s)
    if not tops:
        return None
    # Resolve models top-down: a span inherits the nearest ancestor's.
    stack: list[tuple[Span, str | None]] = [(t, t.model) for t in tops]
    trace_model: str | None = None
    while stack:
        s, inherited = stack.pop()
        if s.model is None:
            s.model = inherited
        if trace_model is None and s.model is not None:
            trace_model = s.model
        for c in children.get(s.span_id, ()):
            stack.append((c, s.model))
    if len(tops) == 1:
        root = tops[0]
        visited = {root.span_id}
    else:
        hull_start = min(s.start for s in tops)
        hull_end = max(s.end for s in tops)
        root = Span(
            name=GAP_STAGE, start=hull_start, end=hull_end,
            span_id=f"(virtual:{tops[0].trace_id})", parent_id=None,
            trace_id=tops[0].trace_id, lane=None, model=trace_model,
        )
        children[root.span_id] = tops
        visited = {root.span_id}
    charges: list[tuple[Span, float]] = []
    _charge(root, root.start, root.end, children, charges, visited)
    total = sum(sec for _, sec in charges)
    if total <= 0.0:
        return None
    lanes = {s.lane for s, _ in charges if s.lane is not None}
    return TracePath(
        charges=charges, total_s=total, model=trace_model or ANY_MODEL,
        orphans=orphans, lanes=lanes,
    )


def breakdown(
    traces: dict[str, list[Span]],
) -> dict[str, dict[str, Any]]:
    """One-shot per-model critical-path breakdown over already-normalized
    traces (the trace_smoke / bench consumer — no windows, no decay):
    ``{model: {"requests", "total_s", "max_lanes", "lanes": [
    {"stage", "member", "crit_s", "share"}]}}`` with lanes sorted by
    descending share."""
    acc: dict[str, dict[tuple[str, str], float]] = {}
    totals: dict[str, float] = {}
    requests: dict[str, int] = {}
    max_lanes: dict[str, int] = {}
    for spans in traces.values():
        path = critical_path(spans)
        if path is None:
            continue
        model = path.model
        totals[model] = totals.get(model, 0.0) + path.total_s
        requests[model] = requests.get(model, 0) + 1
        max_lanes[model] = max(max_lanes.get(model, 0), len(path.lanes))
        lanes = acc.setdefault(model, {})
        for span, sec in path.charges:
            key = (stage_of(span.name), span.lane or UNKNOWN_MEMBER)
            lanes[key] = lanes.get(key, 0.0) + sec
    out: dict[str, dict[str, Any]] = {}
    for model, lanes in acc.items():
        total = totals[model]
        rows = [
            {"stage": stage, "member": member, "crit_s": sec,
             "share": sec / total if total > 0 else 0.0}
            for (stage, member), sec in lanes.items()
        ]
        rows.sort(key=lambda r: (-float(r["crit_s"]), str(r["stage"]),
                                 str(r["member"])))
        out[model] = {
            "requests": requests[model],
            "total_s": total,
            "max_lanes": max_lanes[model],
            "lanes": rows,
        }
    return out


# ---------------------------------------------------------------------------
# Rolling aggregation: the per-node analyzer behind obs.critpath
# ---------------------------------------------------------------------------


class _Win:
    """One window of one (model, stage, member) lane: request count, total
    critical-path seconds, and an Algorithm-R reservoir of per-request
    self-times (``offers`` is the denominator, so a full window stays a
    uniform sample)."""

    __slots__ = ("epoch", "count", "total", "samples", "offers")

    def __init__(self, epoch: int):
        self.epoch = epoch
        self.count = 0
        self.total = 0.0
        self.samples: list[float] = []
        self.offers = 0


class CritPathAnalyzer:
    """Per-node rolling critical-path aggregation. ``ingest`` accepts wire
    span events; completed traces (their root span has been recorded — the
    root ends last, so by then the local children are all present) are
    charged once and their ids remembered so late stragglers never
    double-count. Thread-safe, leaf-locked."""

    WINDOW_SAMPLES = 128   # reservoir bound per (lane, window)
    WIRE_SAMPLES = 32      # recent samples shipped per lane in snapshot()
    MAX_PENDING = 512      # unrooted traces buffered before eviction
    MAX_TRACE_SPANS = 2048  # spans buffered per pending trace
    DONE_TRACES = 4096     # charged trace ids remembered for dedup

    def __init__(
        self,
        window_s: float = 30.0,
        windows: int = 16,
        decay: float = 0.7,
        clock: Callable[[], float] = monotonic,
        seed: int = 0xC817,
    ):
        self.window_s = float(window_s)
        self.windows = int(windows)
        self.decay = float(decay)
        self.clock = clock
        self._rng = random.Random(seed)
        self._lanes: dict[tuple[str, str, str], deque[_Win]] = {}
        self._models: dict[str, deque[_Win]] = {}
        self._pending: dict[str, list[Span]] = {}
        self._done: deque[str] = deque(maxlen=self.DONE_TRACES)
        self._done_set: set[str] = set()
        self._wire_cursor = 0
        self._wire_resets = 0
        self._lock = threading.Lock()
        self.counters: dict[str, int] = {
            "spans": 0, "traces": 0, "orphan_spans": 0, "late_spans": 0,
            "unrooted_evicted": 0, "trace_overflow": 0,
        }

    # ---- ingestion -----------------------------------------------------

    def _epoch(self) -> int:
        return int(self.clock() // self.window_s)

    def ingest_tracer(
        self, tr: Any, own_lane: str | None = None,
        claim_unlaned: bool = False,
    ) -> int:
        """Drain the tracer's NEW raw spans (cursor-based, reset-aware) and
        ingest them. Returns spans consumed this call."""
        with self._lock:
            cursor, resets = self._wire_cursor, self._wire_resets
        tr_resets = int(getattr(tr, "resets", 0))
        if tr_resets != resets:
            cursor = 0
        events = tr.events_wire(offset=cursor)
        with self._lock:
            self._wire_cursor = cursor + len(events)
            self._wire_resets = tr_resets
        if events:
            self.ingest(events, own_lane=own_lane, claim_unlaned=claim_unlaned)
        return len(events)

    def ingest(
        self, events: Iterable[dict[str, Any]], own_lane: str | None = None,
        claim_unlaned: bool = False,
    ) -> int:
        """Fold wire-shaped span events in; charge every trace whose root
        this node owns. ``own_lane=None`` charges everything (the harness
        and bench consumers); otherwise a trace is charged only when its
        earliest true root ran under ``own_lane`` — or had no lane and
        ``claim_unlaned`` is set (the leader claims ambient roots) — so a
        co-hosted fleet charges each request exactly once."""
        charged = 0
        with self._lock:
            grouped = spans_from_wire(events)
            ready: list[list[Span]] = []
            for trace_id, spans in grouped.items():
                self.counters["spans"] += len(spans)
                if trace_id in self._done_set:
                    self.counters["late_spans"] += len(spans)
                    continue
                buf = self._pending.setdefault(trace_id, [])
                room = self.MAX_TRACE_SPANS - len(buf)
                if room < len(spans):
                    self.counters["trace_overflow"] += len(spans) - max(0, room)
                buf.extend(spans[:max(0, room)])
                if any(s.parent_id is None for s in buf):
                    ready.append(self._pending.pop(trace_id))
                    self._mark_done(trace_id)
            # Bound the unrooted backlog: oldest-first eviction (insertion
            # order). A trace with no root here is rooted on another node —
            # its owner charges it; we only count the eviction.
            while len(self._pending) > self.MAX_PENDING:
                evicted = next(iter(self._pending))
                del self._pending[evicted]
                self._mark_done(evicted)
                self.counters["unrooted_evicted"] += 1
            epoch = self._epoch()
            for spans in ready:
                roots = sorted(
                    (s for s in spans if s.parent_id is None),
                    key=lambda s: (s.start, s.span_id),
                )
                owner = roots[0].lane
                if own_lane is not None and not (
                    owner == own_lane or (owner is None and claim_unlaned)
                ):
                    continue
                path = critical_path(spans)
                if path is None:
                    continue
                self._fold_locked(path, epoch)
                charged += 1
        return charged

    def _mark_done(self, trace_id: str) -> None:
        if len(self._done) == self._done.maxlen and self._done:
            self._done_set.discard(self._done[0])
        self._done.append(trace_id)
        self._done_set.add(trace_id)

    def _fold_locked(self, path: TracePath, epoch: int) -> None:
        self.counters["traces"] += 1
        self.counters["orphan_spans"] += path.orphans
        per_lane: dict[tuple[str, str, str], float] = {}
        for span, sec in path.charges:
            key = (path.model, stage_of(span.name),
                   span.lane or UNKNOWN_MEMBER)
            per_lane[key] = per_lane.get(key, 0.0) + sec
        for key, sec in per_lane.items():
            dq = self._lanes.setdefault(key, deque(maxlen=self.windows))
            w = self._window(dq, epoch)
            w.count += 1
            w.total += sec
            w.offers += 1
            if len(w.samples) < self.WINDOW_SAMPLES:
                w.samples.append(sec)
            else:
                j = self._rng.randrange(w.offers)
                if j < self.WINDOW_SAMPLES:
                    w.samples[j] = sec
        mq = self._models.setdefault(path.model, deque(maxlen=self.windows))
        mw = self._window(mq, epoch)
        mw.count += 1
        mw.total += path.total_s

    @staticmethod
    def _window(dq: deque[_Win], epoch: int) -> _Win:
        if not dq or dq[-1].epoch != epoch:
            dq.append(_Win(epoch))
        return dq[-1]

    # ---- queries -------------------------------------------------------

    def _iter(
        self, dq: deque[_Win], now_epoch: int,
    ) -> Iterator[tuple[_Win, float]]:
        for w in dq:
            age = now_epoch - w.epoch
            if 0 <= age < self.windows and w.count:
                yield w, self.decay ** age

    @staticmethod
    def _percentile(weighted: list[tuple[float, float]], p: float) -> float:
        """Weighted nearest-rank percentile; NaN with no samples."""
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

    def snapshot(self) -> dict[str, Any]:
        """The ``obs.critpath`` / ``obs.metrics["critpath"]`` wire form:
        per model, decayed total critical-path seconds and per-(stage,
        member) lanes with share, p50/p99 self-time, counts, and a bounded
        window of RECENT samples (newest two windows) so the leader-side
        fold and the drift sentinel can re-derive current quantiles."""
        with self._lock:
            now_epoch = self._epoch()
            models: dict[str, Any] = {}
            for (model, stage, member), dq in sorted(self._lanes.items()):
                crit = 0.0
                n = 0
                recent_n = 0
                weighted: list[tuple[float, float]] = []
                samples: list[float] = []
                for w, wt in self._iter(dq, now_epoch):
                    crit += w.total * wt
                    n += w.count
                    if w.samples:
                        per = wt * w.count / len(w.samples)
                        weighted.extend((s, per) for s in w.samples)
                    if now_epoch - w.epoch <= 1:
                        recent_n += w.count
                        room = self.WIRE_SAMPLES - len(samples)
                        if room > 0:
                            samples.extend(w.samples[-room:])
                if crit <= 0.0 or n == 0:
                    continue
                body = models.setdefault(
                    model, {"requests": 0, "total_s": 0.0, "lanes": []}
                )
                body["lanes"].append({
                    "stage": stage, "member": member, "crit_s": crit,
                    "n": n, "recent_n": recent_n,
                    "p50": self._percentile(list(weighted), 50),
                    "p99": self._percentile(list(weighted), 99),
                    "samples": samples,
                })
            for model, body in models.items():
                mq = self._models.get(model)
                req = 0
                total = 0.0
                if mq is not None:
                    for w, wt in self._iter(mq, now_epoch):
                        req += w.count
                        total += w.total * wt
                body["requests"] = req
                body["total_s"] = total
                lane_sum = sum(ln["crit_s"] for ln in body["lanes"])
                for ln in body["lanes"]:
                    ln["share"] = (
                        ln["crit_s"] / lane_sum if lane_sum > 0 else 0.0
                    )
                body["lanes"].sort(
                    key=lambda ln: (-float(ln["crit_s"]), str(ln["stage"]),
                                    str(ln["member"])),
                )
            return {
                "window_s": self.window_s,
                "windows": self.windows,
                "decay": self.decay,
                "counters": dict(self.counters),
                "models": models,
            }


# ---------------------------------------------------------------------------
# Leader-side fleet fold
# ---------------------------------------------------------------------------


def _merge_snapshots(snaps: Iterable[dict[str, Any]]) -> dict[str, Any]:
    """Merge analyzer snapshots: lanes keyed (model, stage, member) sum
    critical-path seconds and counts; samples concatenate (bounded);
    shares are recomputed against the merged per-model totals."""
    lanes: dict[tuple[str, str, str], dict[str, Any]] = {}
    requests: dict[str, int] = {}
    totals: dict[str, float] = {}
    counters: dict[str, int] = {}
    cap = CritPathAnalyzer.WIRE_SAMPLES * 4
    for snap in snaps:
        for key, value in (snap.get("counters") or {}).items():
            counters[key] = counters.get(key, 0) + int(value)
        for model, body in (snap.get("models") or {}).items():
            requests[model] = requests.get(model, 0) + int(
                body.get("requests", 0)
            )
            totals[model] = totals.get(model, 0.0) + float(
                body.get("total_s", 0.0)
            )
            for ln in body.get("lanes", ()):
                k = (model, str(ln["stage"]), str(ln["member"]))
                agg = lanes.setdefault(k, {
                    "crit_s": 0.0, "n": 0, "recent_n": 0, "samples": [],
                    "p50": float("nan"), "p99": float("nan"),
                })
                agg["crit_s"] += float(ln.get("crit_s", 0.0))
                agg["n"] += int(ln.get("n", 0))
                agg["recent_n"] += int(ln.get("recent_n", 0))
                room = cap - len(agg["samples"])
                if room > 0:
                    agg["samples"].extend(
                        float(s) for s in (ln.get("samples") or ())[:room]
                    )
                for q in ("p50", "p99"):
                    prev = agg[q]
                    cur = float(ln.get(q) or float("nan"))
                    if math.isnan(prev) or (
                        not math.isnan(cur) and cur > prev
                    ):
                        # Fold-side pessimism: the worst member's quantile
                        # stands for the merged lane (lanes are per-member,
                        # so cross-snapshot merges of one lane are rare).
                        agg[q] = cur
    models: dict[str, Any] = {}
    for (model, stage, member), agg in sorted(lanes.items()):
        body = models.setdefault(
            model, {"requests": requests.get(model, 0),
                    "total_s": totals.get(model, 0.0), "lanes": []}
        )
        body["lanes"].append({"stage": stage, "member": member, **agg})
    for body in models.values():
        lane_sum = sum(float(ln["crit_s"]) for ln in body["lanes"])
        for ln in body["lanes"]:
            ln["share"] = float(ln["crit_s"]) / lane_sum if lane_sum > 0 else 0.0
        body["lanes"].sort(
            key=lambda ln: (-float(ln["crit_s"]), str(ln["stage"]),
                            str(ln["member"])),
        )
    return {"counters": counters, "models": models}


class FleetCritPath:
    """The leader's fleet-wide critical-path table: keeps the latest
    analyzer snapshot per member (snapshots are rolling-window STATE, not
    deltas, so latest-per-member folds exactly like ``fleet_metrics``)
    and merges on read. Thread-safe, leaf-locked."""

    def __init__(self) -> None:
        self._snaps: dict[str, dict[str, Any]] = {}
        self._lock = threading.Lock()

    def fold(self, member: str, snapshot: dict[str, Any]) -> None:
        if not isinstance(snapshot, dict):
            return
        with self._lock:
            self._snaps[member] = snapshot

    def forget(self, member: str) -> None:
        with self._lock:
            self._snaps.pop(member, None)

    def prune(self, keep: Iterable[str]) -> None:
        """Drop snapshots for members no longer in the fleet — a dead
        member must stop haunting the culprit table."""
        alive = set(keep)
        with self._lock:
            for member in [m for m in self._snaps if m not in alive]:
                del self._snaps[member]

    def table(self) -> dict[str, Any]:
        with self._lock:
            snaps = [self._snaps[a] for a in sorted(self._snaps)]
        merged = _merge_snapshots(snaps)
        merged["members_reporting"] = len(snaps)
        return merged

    def culprit(self, model: str) -> dict[str, Any] | None:
        """The top critical-path contributor for ``model``: the named
        (stage, member, critpath_share) every burn alert carries. None
        until the model has charged traces."""
        body = self.table().get("models", {}).get(model)
        if not body or not body.get("lanes"):
            return None
        top = body["lanes"][0]
        return {
            "stage": str(top["stage"]),
            "member": str(top["member"]),
            "critpath_share": round(float(top.get("share", 0.0)), 4),
            "p99_s": float(top.get("p99") or float("nan")),
        }


__all__ = [
    "ANY_MODEL",
    "GAP_STAGE",
    "ORPHAN_ROOT_NAME",
    "UNKNOWN_MEMBER",
    "CritPathAnalyzer",
    "FleetCritPath",
    "Span",
    "TracePath",
    "breakdown",
    "critical_path",
    "spans_from_perfetto",
    "spans_from_wire",
    "stage_of",
]
