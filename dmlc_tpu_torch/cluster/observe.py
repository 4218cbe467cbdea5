"""Observability plane: the ``obs.*`` RPC surface + the leader-side merge.

Copied from ``dmlc_tpu/cluster/observe.py`` (the whole module): the
``obs.*`` verbs and their replies are the JAX package's, so a collector of
either package scrapes and merges the other's nodes. ``ObsService`` reads
this package's process-global tracer: in one process, nodes of the two
packages keep their spans in two tracers, and each drains its own.

Three fleet-wide capabilities over the existing RPC fabrics
(docs/OBSERVABILITY.md):

- **Metrics scrape** — ``obs.metrics`` returns one node's whole metric
  surface (utils/metrics.Registry snapshot + tracer span aggregates); the
  leader scrapes every active member on the probe cadence and
  ``render_fleet_prometheus`` exposes the lot as Prometheus text with a
  ``node`` label per member.
- **Distributed trace collection** — ``obs.trace_dump`` returns a node's
  raw spans (trace/span/parent ids included) in its OWN tracer timebase;
  ``measure_clock_offset`` aligns that timebase to the collector's via an
  NTP-style midpoint over ``obs.clock`` (offset = remote_now - (t0+t1)/2,
  best-of-N by minimum RTT, so the error is bounded by the best RTT/2);
  ``merge_fleet_trace`` emits ONE Chrome/Perfetto trace with one pid lane
  per node and clock-aligned timestamps, with child spans clamped to start
  no earlier than their parent (residual sub-RTT skew must not render
  causality backwards).
- **Flight recorder fetch** — ``obs.flight`` returns the node's bounded
  event ring (cluster/flight.py) for live postmortems.

``obs.trace_ctl`` starts/stops/resets tracing remotely, so one CLI can arm
the whole fleet before reproducing an incident.
"""

from __future__ import annotations

import json
import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from dmlc_tpu_torch.cluster.rpc import Rpc, RpcError, RpcUnreachable
from dmlc_tpu_torch.utils.metrics import Registry, render_prometheus
from dmlc_tpu_torch.utils.tracing import traced_methods, tracer

log = logging.getLogger(__name__)

# Synthetic span adopting a trace's orphans in the merged fleet timeline;
# critpath.stage_of folds it into the GAP stage.
from dmlc_tpu_torch.cluster.critpath import ORPHAN_ROOT_NAME  # noqa: E402


class ObsService:
    """One node's observability RPC surface (registered on the member
    server next to the SDFS/worker verbs). ``lane`` is the node's member
    address — ``obs.trace_dump`` filters the process-global tracer to spans
    this node executed, so co-hosted nodes (the localcluster harness) each
    report their own timeline."""

    def __init__(self, registry: Registry, flight=None, lane: str | None = None,
                 profiler=None, critpath=None, claim_unlaned=None):
        self.registry = registry
        self.flight = flight
        self.lane = lane
        # Live cost profiles (cluster/profile.py): the leader's instance
        # holds fleet-wide lanes; a member's holds its own (gen/step etc.).
        self.profiler = profiler
        # Critical-path analyzer (cluster/critpath.py): drained from the
        # process tracer on every scrape so the snapshot rides obs.metrics
        # to the leader with zero extra RPCs. ``claim_unlaned`` is a
        # callable — "am I the leader right now" — deciding whether this
        # node charges traces whose root span carries no lane.
        self.critpath = critpath
        self.claim_unlaned = claim_unlaned

    def methods(self) -> dict:
        return traced_methods({
            "obs.metrics": self._metrics,
            "obs.clock": self._clock,
            "obs.trace_dump": self._trace_dump,
            "obs.trace_ctl": self._trace_ctl,
            "obs.flight": self._flight,
            "obs.profile": self._profile,
            "obs.critpath": self._critpath,
        })

    def _critpath_snapshot(self) -> dict | None:
        if self.critpath is None:
            return None
        claim = bool(self.claim_unlaned()) if self.claim_unlaned else False
        self.critpath.ingest_tracer(tracer, own_lane=self.lane,
                                    claim_unlaned=claim)
        return self.critpath.snapshot()

    def _metrics(self, p: dict) -> dict:
        # ``mergeable`` (scrape-tree delegates set it) swaps the latency
        # section to the exact-merge wire form so span partials fold
        # counter-exactly; the sampling block makes the adaptive trace
        # controller's behavior observable fleet-wide.
        mergeable = bool(p.get("mergeable"))
        out = {
            "metrics": self.registry.snapshot(mergeable=mergeable),
            "spans": tracer.summary(),
            "sampling": tracer.sampling_summary(),
        }
        crit = self._critpath_snapshot()
        if crit is not None:
            out["critpath"] = crit
        return out

    def _clock(self, p: dict) -> dict:
        # The tracer's own clock — the timebase every span timestamp lives
        # in — NOT wall time: host clocks are never compared directly.
        return {"now": tracer.now()}

    def _trace_dump(self, p: dict) -> dict:
        return {
            "events": tracer.events_wire(lane=self.lane),
            "now": tracer.now(),
            "dropped": tracer.dropped_events,
            "lane": self.lane,
        }

    def _trace_ctl(self, p: dict) -> dict:
        if p.get("reset"):
            tracer.reset()
        if "enable" in p:
            tracer.enabled = bool(p["enable"])
        if "sample_rate" in p or "spans_per_s" in p:
            tracer.set_sampling(
                rate=p.get("sample_rate"), spans_per_s=p.get("spans_per_s")
            )
        if p.get("force_sample_s"):
            tracer.force_sampling(float(p["force_sample_s"]))
        return {"enabled": tracer.enabled, "sampling": tracer.sampling_summary()}

    def _flight(self, p: dict) -> dict:
        if self.flight is None:
            return {"events": [], "recorded": 0, "dropped": 0, "capacity": 0}
        return self.flight.to_wire()

    def _profile(self, p: dict) -> dict:
        if self.profiler is None:
            return {"profiles": {}}
        return self.profiler.snapshot()

    def _critpath(self, p: dict) -> dict:
        crit = self._critpath_snapshot()
        return {"critpath": crit if crit is not None else {"models": {}}}


# ---------------------------------------------------------------------------
# Leader-side collection + merge
# ---------------------------------------------------------------------------


def measure_clock_offset(
    rpc: Rpc, addr: str, local_now, samples: int = 5, timeout: float = 2.0
) -> tuple[float, float]:
    """NTP-style offset of ``addr``'s tracer clock relative to ours:
    ``remote ≈ local + offset``. Each probe brackets the remote read with
    two local reads and assumes symmetric transit (the midpoint); the probe
    with the smallest round trip wins, bounding the error by best-RTT/2.
    Returns ``(offset_s, best_rtt_s)``."""
    best: tuple[float, float] | None = None  # (rtt, offset)
    for _ in range(max(1, samples)):
        t0 = local_now()
        remote = float(rpc.call(addr, "obs.clock", {}, timeout=timeout)["now"])
        t1 = local_now()
        rtt = t1 - t0
        offset = remote - (t0 + t1) / 2.0
        if best is None or rtt < best[0]:
            best = (rtt, offset)
    return best[1], best[0]


class FleetTraceMerger:
    """INCREMENTAL fleet-trace merge: ``add_node`` folds one node's dump
    into the document under construction and the dump is released before
    the next node is pulled — the collector holds one node's raw buffer at
    a time instead of the whole fleet's (the O(N x max_events) memory
    cliff at hundreds of members).

    Semantics match the one-shot merge exactly: one pid lane per node
    (process_name metadata = its address), every timestamp translated into
    the collector's timebase (``local = remote - offset``), and child
    spans clamped at ``finish()`` to start no earlier than their parent —
    clamping must wait until every node reported, because a parent span
    can arrive after its children (cross-node edges point backwards in
    collection order). Only (index, parent, start) stubs are buffered for
    that pass, never raw dumps.

    Clamping is corrective, so its MAGNITUDE is the health signal: each
    node's worst clamp distance lands in ``otherData.nodes[addr]
    .max_skew_s``, and any node past ``skew_alert_s`` (when > 0) records a
    ``trace_skew_clamp`` flight event — clock-alignment decay must be
    visible before it quietly corrupts every profile built on the spans."""

    def __init__(self, flight=None, skew_alert_s: float = 0.0):
        self.flight = flight
        self.skew_alert_s = skew_alert_s
        self._meta: list[dict] = []
        self._events: list[dict] = []
        self._span_start: dict[str, float] = {}  # span_id -> aligned start
        # (event index, addr, parent span id, aligned start) — the clamp
        # pass's working set, one small tuple per child span.
        self._deferred: list[tuple[int, str, str, float]] = []
        self._nodes: dict[str, dict] = {}
        self._unreachable: dict[str, str] = {}
        self._dropped = 0

    def add_node(self, addr: str, dump: dict, offset=None, rtt=None) -> None:
        """Fold one ``obs.trace_dump`` reply in (timebase offset from
        ``measure_clock_offset``). The reply is not retained."""
        pid = len(self._meta)
        self._meta.append({
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": addr},
        })
        self._nodes[addr] = {
            "offset_s": offset, "rtt_s": rtt, "max_skew_s": 0.0, "clamped": 0,
        }
        self._dropped += int(dump.get("dropped", 0))
        off = float(offset or 0.0)
        for e in dump.get("events", ()):
            start = float(e["start"]) - off
            if e.get("span"):
                # First writer wins: a span id is unique, but co-hosted
                # nodes can both report an unlaned span.
                self._span_start.setdefault(e["span"], start)
            args = dict(e.get("attrs") or {})
            for key in ("trace", "span", "parent", "lane"):
                if e.get(key) is not None:
                    args[key] = e[key]
            idx = len(self._events)
            self._events.append({
                "name": e["name"],
                "ph": "X",
                "ts": start * 1e6,
                "dur": float(e["dur"]) * 1e6,
                "pid": pid,
                "tid": int(e.get("tid", 0)),
                "args": args,
            })
            parent = e.get("parent")
            if parent is not None:
                self._deferred.append((idx, addr, parent, start))

    def add_unreachable(self, addr: str, error) -> None:
        self._unreachable[addr] = str(error)

    def finish(self) -> dict:
        """Run the deferred child-before-parent clamp pass, attach orphan
        spans (parent dropped by the sampling budget, ring overflow, or a
        dead member) under one synthetic per-trace root, and emit the
        trace-event document."""
        clamped = 0
        orphan_traces: set[str] = set()
        orphans = 0
        for idx, addr, parent, start in self._deferred:
            floor = self._span_start.get(parent)
            if floor is None:
                # Orphan: its parent never made it into the merge.
                orphans += 1
                trace = self._events[idx]["args"].get("trace")
                if trace:
                    orphan_traces.add(trace)
                continue
            if start < floor:
                node = self._nodes[addr]
                node["max_skew_s"] = max(node["max_skew_s"], floor - start)
                node["clamped"] += 1
                self._events[idx]["ts"] = floor * 1e6
                clamped += 1
        # Every trace holding an orphan gets ONE synthetic root spanning
        # the trace's hull, adopting ALL its top-level spans (orphans AND
        # true roots): downstream consumers — Perfetto nesting, critpath
        # extraction — see one rooted tree, and overlap between the orphan
        # subtree and the covered chain stays concurrent (never charged
        # twice, shares never exceed 1.0).
        if orphan_traces:
            by_trace: dict[str, list[int]] = {}
            for i, e in enumerate(self._events):
                trace = e["args"].get("trace")
                if trace in orphan_traces:
                    by_trace.setdefault(trace, []).append(i)
            for trace, idxs in sorted(by_trace.items()):
                lo = min(self._events[i]["ts"] for i in idxs)
                hi = max(self._events[i]["ts"] + self._events[i]["dur"]
                         for i in idxs)
                root_span = f"(orphan-root:{trace})"
                for i in idxs:
                    parent = self._events[i]["args"].get("parent")
                    if parent is None or parent not in self._span_start:
                        self._events[i]["args"]["parent"] = root_span
                self._events.append({
                    "name": ORPHAN_ROOT_NAME,
                    "ph": "X",
                    "ts": lo,
                    "dur": hi - lo,
                    "pid": self._events[idxs[0]]["pid"],
                    "tid": 0,
                    "args": {"trace": trace, "span": root_span,
                             "synthetic": True},
                })
                self._span_start[root_span] = lo / 1e6
        other: dict = {
            "nodes": {
                a: {"offset_s": info["offset_s"], "rtt_s": info["rtt_s"],
                    "max_skew_s": info["max_skew_s"]}
                for a, info in sorted(self._nodes.items())
            },
            "skew_clamped_children": clamped,
        }
        if orphans:
            other["orphan_spans"] = orphans
        if self.skew_alert_s > 0 and self.flight is not None:
            for addr in sorted(self._nodes):
                info = self._nodes[addr]
                if info["max_skew_s"] > self.skew_alert_s:
                    self.flight.note(
                        "trace_skew_clamp", node=addr,
                        max_skew_s=round(info["max_skew_s"], 6),
                        clamped=info["clamped"], threshold_s=self.skew_alert_s,
                    )
        if self._dropped:
            other["dropped_events"] = self._dropped
            other["note"] = "one or more nodes truncated their span buffer"
        if self._unreachable:
            other["unreachable"] = dict(self._unreachable)
        return {"traceEvents": self._meta + self._events, "otherData": other}


def collect_fleet_trace(
    rpc: Rpc, addrs: list[str], timeout: float = 10.0, clock_samples: int = 5,
    flight=None, skew_alert_s: float = 0.0,
) -> dict:
    """Pull every node's span dump + clock offset and merge them into one
    Chrome/Perfetto trace document, STREAMING node by node (each dump is
    folded and released before the next is fetched). Unreachable nodes are
    skipped (named in ``otherData.unreachable``) — a partial fleet trace
    beats none."""
    merger = FleetTraceMerger(flight=flight, skew_alert_s=skew_alert_s)
    for addr in sorted(set(addrs)):
        try:
            offset, rtt = measure_clock_offset(
                rpc, addr, local_now=tracer.now, samples=clock_samples,
                timeout=timeout,
            )
            dump = rpc.call(addr, "obs.trace_dump", {}, timeout=timeout)
            merger.add_node(addr, dump, offset=offset, rtt=rtt)
        except (RpcUnreachable, RpcError) as e:
            merger.add_unreachable(addr, e)
            log.warning("fleet trace: %s unreachable: %s", addr, e)
    return merger.finish()


def merge_fleet_trace(
    per_node: dict, unreachable: dict | None = None, flight=None,
    skew_alert_s: float = 0.0,
) -> dict:
    """One-shot form of the merge: per-node dumps already in hand
    (``{addr: {"dump": obs.trace_dump reply, "offset": s, "rtt": s}}``).
    Thin wrapper over ``FleetTraceMerger`` so both paths share one
    implementation; prefer ``collect_fleet_trace``/the merger directly at
    fleet scale — this form holds every dump at once."""
    merger = FleetTraceMerger(flight=flight, skew_alert_s=skew_alert_s)
    for addr, entry in sorted(per_node.items()):
        merger.add_node(
            addr, entry["dump"], offset=entry.get("offset"),
            rtt=entry.get("rtt"),
        )
    for addr, err in (unreachable or {}).items():
        merger.add_unreachable(addr, err)
    return merger.finish()


def export_fleet_trace(
    rpc: Rpc, addrs: list[str], path: str | Path, timeout: float = 10.0,
    flight=None, skew_alert_s: float = 0.0,
) -> dict:
    """Collect + write one merged fleet trace; returns the document."""
    from dmlc_tpu_torch.cluster.diskio import atomic_write

    doc = collect_fleet_trace(
        rpc, addrs, timeout=timeout, flight=flight, skew_alert_s=skew_alert_s
    )
    # Atomic even though this is an operator artifact: a half-written trace
    # looks exactly like a Perfetto parser bug to the person debugging.
    atomic_write(Path(path), json.dumps(doc).encode())
    return doc


def set_fleet_tracing(
    rpc: Rpc, addrs: list[str], enable: bool, reset: bool = False,
    timeout: float = 2.0, sample_rate: float | None = None,
    spans_per_s: float | None = None,
) -> dict[str, bool]:
    """Flip tracing on every reachable node, optionally pushing sampling
    knobs in the same control frame (best-effort; returns {addr: reached})."""
    payload: dict = {"enable": enable, "reset": reset}
    if sample_rate is not None:
        payload["sample_rate"] = float(sample_rate)
    if spans_per_s is not None:
        payload["spans_per_s"] = float(spans_per_s)
    out: dict[str, bool] = {}
    for addr in addrs:
        try:
            rpc.call(addr, "obs.trace_ctl", dict(payload), timeout=timeout)
            out[addr] = True
        except (RpcUnreachable, RpcError) as e:
            out[addr] = False
            log.warning("trace_ctl %s failed: %s", addr, e)
    return out


def force_fleet_sampling(
    rpc: Rpc, addrs: list[str], seconds: float, timeout: float = 2.0
) -> dict[str, bool]:
    """Push a forced-sampling window to every reachable node — the
    SLO-burn hook: while a model burns error budget the leader wants whole
    traces from everyone, not a head-sampling lottery (best-effort)."""
    out: dict[str, bool] = {}
    for addr in addrs:
        try:
            rpc.call(
                addr, "obs.trace_ctl", {"force_sample_s": float(seconds)},
                timeout=timeout,
            )
            out[addr] = True
        except (RpcUnreachable, RpcError) as e:
            out[addr] = False
            log.warning("force_sampling %s failed: %s", addr, e)
    return out


def scrape_metrics_with_misses(
    rpc: Rpc, addrs: list[str], timeout: float = 2.0, concurrency: int = 1,
    metrics=None, mergeable: bool = False,
) -> tuple[dict[str, dict], dict[str, str]]:
    """One scrape pass returning ``(replies, misses)``. Each member scrape
    carries its OWN deadline (``timeout``) and, with ``concurrency`` > 1,
    runs on a small pool — one wedged member costs one slot for one
    timeout instead of stalling everyone behind it serially. Failed
    scrapes land in ``misses`` and count ``scrape_timeouts`` in
    ``metrics``. ``mergeable`` requests the exact-merge latency form (what
    scrape-tree delegates feed ``merge_mergeable_snapshots``)."""
    payload = {"mergeable": True} if mergeable else {}

    def one(addr: str):
        try:
            return rpc.call(addr, "obs.metrics", dict(payload), timeout=timeout), None
        except (RpcUnreachable, RpcError) as e:
            return None, str(e)

    if concurrency > 1 and len(addrs) > 1:
        with ThreadPoolExecutor(
            max_workers=min(int(concurrency), len(addrs))
        ) as pool:
            results = list(pool.map(one, addrs))
    else:
        # Serial path: deterministic on the sim fabric (a thread pool over
        # the virtual clock would interleave nondeterministically).
        results = [one(a) for a in addrs]
    out: dict[str, dict] = {}
    misses: dict[str, str] = {}
    for addr, (reply, err) in zip(addrs, results):
        if reply is not None:
            out[addr] = reply
        else:
            misses[addr] = err or "unreachable"
            if metrics is not None:
                metrics.inc("scrape_timeouts")
            log.debug("metrics scrape %s failed: %s", addr, err)
    return out, misses


def scrape_fleet_metrics(
    rpc: Rpc, addrs: list[str], timeout: float = 2.0, concurrency: int = 1,
    metrics=None,
) -> dict[str, dict]:
    """One scrape pass: every reachable node's ``obs.metrics`` reply.
    The leader runs this on the probe cadence (cluster/node.py) for small
    fleets — past ``scrape_tree_min_members`` it delegates along the ring
    instead (cluster/scrapetree.py). Keeps the latest reply per member."""
    out, _ = scrape_metrics_with_misses(
        rpc, addrs, timeout=timeout, concurrency=concurrency, metrics=metrics
    )
    return out


def render_fleet_prometheus(fleet: dict[str, dict], prefix: str = "dmlc") -> str:
    """Prometheus text for a whole fleet's scraped snapshots, one ``node``
    label per member."""
    chunks = []
    for addr, reply in sorted(fleet.items()):
        snap = reply.get("metrics") or {}
        chunks.append(render_prometheus(
            snap, prefix=prefix, labels=f'node="{addr}"'
        ))
    return "".join(chunks)


__all__ = [
    "FleetTraceMerger",
    "ORPHAN_ROOT_NAME",
    "ObsService",
    "collect_fleet_trace",
    "export_fleet_trace",
    "force_fleet_sampling",
    "measure_clock_offset",
    "merge_fleet_trace",
    "render_fleet_prometheus",
    "scrape_fleet_metrics",
    "scrape_metrics_with_misses",
    "set_fleet_tracing",
]
