"""Delegated scrape trees: fleet metrics collection in O(sqrt(N)) leader RPCs.

Copied from ``dmlc_tpu/cluster/scrapetree.py`` (the whole module):
``obs.scrape_span`` and its partials are the JAX package's, so a delegate
of either package serves a leader of the other.

The flat scrape (cluster/observe.scrape_fleet_metrics) has the leader call
every member's ``obs.metrics`` each probe cycle — O(N) RPCs and O(N) merges
on the one node that is already the bottleneck, the exact super-linear cost
ROADMAP item 5 names. This module splits that work along the membership
ring (docs/OBSERVABILITY.md §6):

- ``partition_spans`` sorts the member ring and cuts it into contiguous
  spans of ~ceil(sqrt(N)) members — so there are ~sqrt(N) spans of
  ~sqrt(N) members, the classic two-level tree balance point.
- Each span's FIRST member is its delegate. The leader sends it one
  ``obs.scrape_span`` RPC; the delegate scrapes its span's members
  concurrently (each scrape under its own deadline), pre-merges their
  mergeable Registry snapshots plus per-span cost aggregates into one
  partial (utils/metrics.merge_mergeable_snapshots — associative, so the
  leader's fold of D partials is counter-exact vs a direct all-member
  scrape), and ships per-member replies for the profiler's cursors.
- If a delegate is dead or wedged the leader RE-DELEGATES to the next
  member of the same span; if the whole span stays dark the cycle still
  completes with that span marked STALE (flagged, never silently absent,
  never an exception) and its last-fresh stamp aging in the result.

Leader cost per cycle: D primary calls + at most D re-delegations, i.e.
<= 2·ceil(N/ceil(sqrt(N))) <= 4·sqrt(N) RPCs — the soak test pins this.
Staleness is per subtree: every span carries the leader-clock stamp of its
last successful fold, so a consumer can tell "fresh 2 s ago" from "dark
for three cycles" per slice of the fleet, not just globally.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Iterable

from dmlc_tpu_torch.cluster import observe
from dmlc_tpu_torch.cluster.rpc import Rpc, RpcError, RpcUnreachable
from dmlc_tpu_torch.utils import metrics as metrics_mod
from dmlc_tpu_torch.utils.tracing import traced_methods

if TYPE_CHECKING:
    from dmlc_tpu_torch.cluster.flight import FlightRecorder
    from dmlc_tpu_torch.utils.metrics import Metrics

log = logging.getLogger(__name__)


def partition_spans(addrs: Iterable[str], span_size: int = 0) -> list[list[str]]:
    """Cut the sorted member ring into contiguous spans. ``span_size`` 0
    picks ceil(sqrt(N)) — balancing delegate count against per-delegate
    fan-out. Every address lands in exactly one span."""
    ring = sorted(set(addrs))
    if not ring:
        return []
    n = len(ring)
    size = int(span_size) if span_size > 0 else math.isqrt(n - 1) + 1
    return [ring[i:i + size] for i in range(0, n, size)]


# ---------------------------------------------------------------------------
# Delegate side: one obs.scrape_span handler per member
# ---------------------------------------------------------------------------


class ScrapeDelegate:
    """Member-side span scraper. Any member can serve ``obs.scrape_span``
    (the leader picks delegates per cycle and re-picks on failure, so
    there is no delegate state to elect or repair): scrape the requested
    addresses concurrently, fold their mergeable snapshots into ONE
    partial, and report per-member replies + who was missed."""

    # Refuse absurd fan-out: a confused leader must not turn one member
    # into an O(N) scraper — that is the disease this module cures.
    MAX_SPAN = 256

    def __init__(self, rpc: Rpc, *, timeout_s: float = 2.0,
                 concurrency: int = 1, metrics: Metrics | None = None) -> None:
        self.rpc = rpc
        self.timeout_s = timeout_s
        self.concurrency = concurrency
        self.metrics = metrics

    def methods(self) -> dict:
        return traced_methods({"obs.scrape_span": self._scrape_span})

    def _scrape_span(self, p: dict) -> dict:
        addrs = [str(a) for a in (p.get("addrs") or [])][: self.MAX_SPAN]
        timeout = float(p.get("timeout_s") or self.timeout_s)
        replies, misses = observe.scrape_metrics_with_misses(
            self.rpc, addrs, timeout=timeout, concurrency=self.concurrency,
            metrics=self.metrics, mergeable=True,
        )
        members: dict[str, dict] = {}
        merged_parts: list[dict] = []
        span_costs: dict[str, dict] = {}
        for addr, reply in replies.items():
            snap = reply.get("metrics") or {}
            merged_parts.append(snap)
            # Per-member entries keep the standard summary-form reply shape
            # so the leader's fleet view (CLI, Prometheus, the profiler's
            # per-member scrape cursors) is byte-compatible with a direct
            # scrape — the delegate pays the conversion, not the leader.
            members[addr] = {
                "metrics": metrics_mod.summarize_mergeable(snap),
                "spans": reply.get("spans") or {},
                "sampling": reply.get("sampling") or {},
            }
            for name, agg in (reply.get("spans") or {}).items():
                if not isinstance(agg, dict):
                    continue  # reserved keys like dropped_events ride along
                count = int(agg.get("count") or 0)
                if count <= 0:
                    continue
                lane = span_costs.setdefault(name, {"count": 0, "total_s": 0.0})
                lane["count"] += count
                lane["total_s"] += float(agg.get("mean") or 0.0) * count
        return {
            "partial": {
                "merged": metrics_mod.merge_mergeable_snapshots(merged_parts),
                "members": members,
                "span_costs": span_costs,
                "missed": sorted(misses),
            }
        }


# ---------------------------------------------------------------------------
# Leader side: partition, delegate, fold
# ---------------------------------------------------------------------------


@dataclass
class ScrapeTreeResult:
    """One tree-scrape cycle, folded. ``members`` is shaped exactly like
    the flat ``scrape_fleet_metrics`` result ({addr: obs.metrics-style
    reply}) so CostProfiler.ingest_scrape / SloEvaluator / the CLI consume
    it unchanged; ``merged`` is the counter-exact fleet-wide mergeable
    snapshot and ``merged_summary`` its render-ready form."""

    members: dict[str, dict] = field(default_factory=dict)
    merged: dict = field(default_factory=dict)
    merged_summary: dict = field(default_factory=dict)
    # Spans whose every delegate candidate failed this cycle:
    # [{"addrs": [...], "reason": str, "stale_for_s": float | None}]
    stale_spans: list[dict] = field(default_factory=list)
    missed: list[str] = field(default_factory=list)
    delegates: list[str] = field(default_factory=list)
    redelegations: int = 0
    leader_rpcs: int = 0
    # span key (first ring address) -> leader clock at last successful fold
    stamps: dict[str, float] = field(default_factory=dict)


class ScrapeTreeCoordinator:
    """The leader's half: partition the ring, send one ``obs.scrape_span``
    per span, fold the partials. Pure sans-IO except through ``rpc`` —
    the injected ``clock`` stamps staleness, so the sim soak drives it on
    the virtual clock deterministically."""

    # Delegate candidates tried per span per cycle (primary + one
    # alternate). With span count D = ceil(N/ceil(sqrt N)) this bounds
    # the leader at 2D <= 4*sqrt(N) RPCs even on a bad cycle.
    ATTEMPTS = 2

    def __init__(self, rpc: Rpc, *, clock: Callable[[], float],
                 span_size: int = 0,
                 timeout_s: float = 2.0, concurrency: int = 1,
                 metrics: Metrics | None = None,
                 flight: FlightRecorder | None = None) -> None:
        self.rpc = rpc
        self.clock = clock
        self.span_size = span_size
        self.timeout_s = timeout_s
        self.concurrency = concurrency
        self.metrics = metrics
        self.flight = flight
        self._last_fresh: dict[str, float] = {}

    def scrape(self, addrs: Iterable[str]) -> ScrapeTreeResult:
        spans = partition_spans(addrs, self.span_size)
        result = ScrapeTreeResult()
        merged_parts: list[dict] = []
        live_keys: set[str] = set()
        for span in spans:
            key = span[0]
            live_keys.add(key)
            partial, delegate, attempts, reason = self._scrape_one_span(span)
            result.leader_rpcs += attempts
            result.redelegations += max(0, attempts - 1)
            if partial is None:
                last = self._last_fresh.get(key)
                stale_for = None if last is None else max(0.0, self.clock() - last)
                result.stale_spans.append({
                    "addrs": list(span), "reason": reason,
                    "stale_for_s": stale_for,
                })
                if self.metrics is not None:
                    self.metrics.inc("scrape_span_stale")
                if self.flight is not None:
                    self.flight.note(
                        "scrape_span_stale", span=key, members=len(span),
                        reason=reason[:120],
                    )
                continue
            now = self.clock()
            self._last_fresh[key] = now
            result.stamps[key] = now
            result.delegates.append(delegate)
            result.members.update(partial.get("members") or {})
            result.missed.extend(partial.get("missed") or [])
            merged = partial.get("merged")
            if merged:
                merged_parts.append(merged)
        # Drop stamps for spans that no longer exist (membership churn
        # re-cuts the ring every cycle).
        for key in list(self._last_fresh):
            if key not in live_keys:
                del self._last_fresh[key]
        result.merged = metrics_mod.merge_mergeable_snapshots(merged_parts)
        result.merged_summary = metrics_mod.summarize_mergeable(result.merged)
        if self.metrics is not None:
            self.metrics.observe_high("scrape_tree_rpcs", result.leader_rpcs)
        return result

    def _scrape_one_span(
        self, span: list[str]
    ) -> tuple[dict | None, str, int, str]:
        """Try the span's delegate candidates in ring order; first success
        wins. Returns (partial | None, delegate, attempts, last_reason)."""
        reason = "no delegate candidates"
        attempts = 0
        # The delegate fans out to its whole span under the call's budget,
        # so the span call gets more rope than one member scrape.
        span_budget = self.timeout_s * 2.0
        for delegate in span[: self.ATTEMPTS]:
            attempts += 1
            try:
                reply = self.rpc.call(
                    delegate, "obs.scrape_span",
                    {"addrs": list(span), "timeout_s": self.timeout_s},
                    timeout=span_budget,
                )
                return reply.get("partial") or {}, delegate, attempts, ""
            except (RpcUnreachable, RpcError) as e:
                reason = str(e)
                if self.metrics is not None:
                    self.metrics.inc("scrape_redelegations")
                log.debug("scrape_span via %s failed: %s", delegate, e)
        return None, "", attempts, reason


__all__ = [
    "ScrapeDelegate",
    "ScrapeTreeCoordinator",
    "ScrapeTreeResult",
    "partition_spans",
]
