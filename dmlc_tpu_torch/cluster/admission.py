"""Admission control: bounded work queues that shed instead of buffering.

Copied from ``dmlc_tpu/cluster/admission.py`` (the whole module).

The reference accepted every request unconditionally; under a burst that
exceeds capacity, an unbounded queue converts overload into unbounded
latency — every queued request eventually times out anyway, but only after
holding memory and a thread for its full deadline (the queueing-theory
death spiral). The production answer is to bound the queue and *shed
immediately* at the door: a rejected caller learns in microseconds, retries
elsewhere (or later, per the retry-after hint), and the work that IS
admitted completes inside its deadline (docs/OVERLOAD.md).

``AdmissionGate`` fronts a synchronous serving surface (PredictWorker's
``job.predict``, the SDFS member's bulk-transfer verbs): up to
``max_inflight`` requests execute while up to ``max_queue`` more wait
(blocked on the backend's serialization); past that, ``admit`` raises
``Overloaded`` with the retry-after hint. Counters (sheds, admitted,
queue-depth high-water) flow to utils/metrics.Counters and the tracer.

Multi-tenant quotas (docs/OVERLOAD.md §Priority classes): with a tenant
table configured (utils/config ``tenants``), each request's ambient
tenant (cluster/tenant.py — frame field ``n``) is charged against that
tenant's share of the gate's total capacity. A tenant at its quota sheds
*typed* (``Overloaded.quota == "over_quota"``) even while the gate has
room — so one workload's flash crowd exhausts only its own tokens and
never the whole door — and a gate-full shed names the tenant too. With
no tenants configured the gate is bit-identical to the single-tenant
fleet.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, Mapping

from dmlc_tpu_torch.cluster import tenant as tenant_mod
from dmlc_tpu_torch.cluster.rpc import Overloaded
from dmlc_tpu_torch.utils.metrics import Counters
from dmlc_tpu_torch.utils.tracing import tracer


class AdmissionGate:
    """Bounded-concurrency door for one class of work. Disabled (admits
    everything, counts nothing) when ``max_inflight <= 0``."""

    def __init__(
        self,
        max_inflight: int,
        max_queue: int,
        name: str = "work",
        metrics: Counters | None = None,
        retry_after_s: float = 0.25,
        flight=None,
        tenants: Mapping[str, tenant_mod.TenantSpec] | None = None,
    ):
        self.max_inflight = int(max_inflight)
        self.max_queue = max(0, int(max_queue))
        self.name = name
        self.metrics = metrics
        # Flight recorder (cluster/flight.py, optional): sheds are the
        # request-path transition worth a timestamped postmortem record.
        self.flight = flight
        self.retry_after_s = float(retry_after_s)
        self._lock = threading.Lock()
        self.active = 0
        self.admitted = 0
        self.sheds = 0
        self.queue_hw = 0  # high-water of requests waiting beyond max_inflight
        # Per-tenant occupancy vs share-derived quotas (cluster/tenant.py).
        # Accounting always runs (the status plane wants occupancy even on
        # a quota-less fleet); *enforcement* only when tenants are declared.
        self.ledger = tenant_mod.TenantLedger(tenants, self.capacity)

    @property
    def capacity(self) -> int:
        return self.max_inflight + self.max_queue

    def _shed(self, tenant: str, verdict: str) -> None:
        """Count + flight-record one refusal, then raise it typed. Called
        under the gate lock."""
        self.sheds += 1
        self.ledger.note_shed(tenant)
        if self.metrics is not None:
            self.metrics.inc("shed")
            self.metrics.inc(f"shed_{self.name}")
            if verdict == "over_quota":
                self.metrics.inc(f"shed_over_quota_{self.name}")
        tracer.record(f"overload/shed_{self.name}", 0.0)
        if self.flight is not None:
            self.flight.note(
                "shed", gate=self.name, active=self.active,
                tenant=tenant, quota=verdict,
            )
        if verdict == "over_quota":
            msg = (
                f"{self.name}: tenant {tenant!r} at quota "
                f"({self.ledger.active(tenant)}/{self.ledger.quota(tenant)} tokens)"
            )
        else:
            msg = (
                f"{self.name}: {self.active} in flight / queue full "
                f"(max_inflight={self.max_inflight}, max_queue={self.max_queue})"
            )
        raise Overloaded(
            msg, retry_after_s=self.retry_after_s, tenant=tenant, quota=verdict
        )

    @contextmanager
    def admit(self) -> Iterator[None]:
        """Hold one admission slot for the duration of the request; raise
        ``Overloaded`` (with the retry-after hint and the tenant + quota
        verdict) when the gate — or the calling tenant's quota — is full."""
        if self.max_inflight <= 0:
            yield
            return
        tenant = tenant_mod.current()
        with self._lock:
            # Quota first: "it's you" is the more actionable verdict, and
            # checking it before the global bound is what guarantees a
            # surging tenant sheds against its own share, not the door.
            if self.ledger.would_exceed(tenant):
                self._shed(tenant, "over_quota")
            if self.active >= self.capacity:
                self._shed(tenant, "gate_full")
            self.active += 1
            self.admitted += 1
            self.ledger.acquire(tenant)
            waiting = self.active - self.max_inflight
            if waiting > self.queue_hw:
                self.queue_hw = waiting
                if self.metrics is not None:
                    self.metrics.observe_high(f"queue_hw_{self.name}", waiting)
        try:
            yield
        finally:
            with self._lock:
                self.active -= 1
                self.ledger.release(tenant)

    def summary(self) -> dict:
        with self._lock:
            out: dict = {
                "max_inflight": self.max_inflight,
                "max_queue": self.max_queue,
                "active": self.active,
                "admitted": self.admitted,
                "sheds": self.sheds,
                "queue_hw": self.queue_hw,
            }
            tenants = self.ledger.summary()
            if tenants:
                out["tenants"] = tenants
            return out
