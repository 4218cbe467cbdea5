"""Tenant identity and per-tenant quotas, as the slot scheduler uses them.

Copied from ``dmlc_tpu/cluster/tenant.py``: the ambient binding
(``bind``/``current``), its wire form (``wire_context``, ``from_wire``:
frame field ``n`` of cluster/rpc.py, omitted for the default tenant), the
operator's declarations (``TenantSpec``, ``parse_tenants``), derived quotas
(``spec_for``, ``quota_of``) and the per-resource ``TenantLedger``.

With no tenants declared every surface behaves as with one implicit tenant:
the ledger accounts but never refuses. Shed and evict ordering is
low-priority-and-over-quota first.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator, Mapping

DEFAULT_TENANT = "default"
PRIORITY_HIGH = "high"
PRIORITY_LOW = "low"

_current: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "dmlc_tenant", default=None
)


def current() -> str:
    """The ambient tenant bound by the innermost serving scope, or the
    default tenant when none is bound (legacy callers)."""
    t = _current.get()
    return t if t else DEFAULT_TENANT


@contextmanager
def bind(tenant: str | None) -> Iterator[str]:
    """Make ``tenant`` ambient for the dynamic extent of the block (the
    RPC server's per-method scope). Binding ``None``/empty *clears* any
    inherited tenant back to the default — the server does exactly that
    for frames without an ``n`` field, so sim and TCP fabrics agree."""
    token = _current.set(tenant if tenant else None)
    try:
        yield current()
    finally:
        _current.reset(token)


def wire_context() -> str | None:
    """The ambient tenant in wire form (frame field ``n``), or None for
    the default tenant — in which case the field is omitted and legacy
    peers see byte-identical frames."""
    t = _current.get()
    if not t or t == DEFAULT_TENANT:
        return None
    return t


def from_wire(wire: object) -> str | None:
    """Tenant from the frame field (tolerant: a malformed field from a
    foreign peer reads as the default tenant rather than an error —
    tenancy must never fail a request)."""
    if not wire or not isinstance(wire, str):
        return None
    return wire


# ---------------------------------------------------------------------------
# Operator declarations (utils/config ``tenants``) and derived quotas
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's declared standing: a priority class and a share of
    every bounded resource (admission tokens, microbatch queue, generate
    slots/pages). ``share`` is a fraction of each resource's capacity;
    the derived integer quota never rounds below 1 so a configured
    tenant can always make progress."""

    name: str
    priority: str = PRIORITY_HIGH
    share: float = 1.0

    @property
    def high_priority(self) -> bool:
        return self.priority != PRIORITY_LOW


#: Standing for tenants that present a name the operator never declared:
#: lowest priority, a small share. They still get service — an unknown
#: label is a misconfiguration to surface, not traffic to blackhole.
UNKNOWN_SHARE = 0.1


def parse_tenants(cfg: Mapping[str, object] | None) -> dict[str, TenantSpec]:
    """``config.tenants`` -> specs. The wire/config form is
    ``{name: {"priority": "high"|"low", "share": 0.0..1.0}}``; missing
    fields default (high priority, share 1.0). Raises ValueError on a
    malformed entry — config errors should fail loudly at load time."""
    specs: dict[str, TenantSpec] = {}
    for name, body in dict(cfg or {}).items():
        if not isinstance(body, Mapping):
            raise ValueError(f"tenants[{name!r}] must be a mapping, got {body!r}")
        priority = str(body.get("priority", PRIORITY_HIGH))
        if priority not in (PRIORITY_HIGH, PRIORITY_LOW):
            raise ValueError(
                f"tenants[{name!r}].priority must be "
                f"{PRIORITY_HIGH!r} or {PRIORITY_LOW!r}, got {priority!r}"
            )
        share = float(body.get("share", 1.0))  # type: ignore[arg-type]
        if not 0.0 < share <= 1.0:
            raise ValueError(f"tenants[{name!r}].share must be in (0, 1], got {share}")
        specs[str(name)] = TenantSpec(name=str(name), priority=priority, share=share)
    return specs


def spec_for(tenant: str, specs: Mapping[str, TenantSpec]) -> TenantSpec:
    """The effective spec for a request's tenant: declared tenants get
    their declaration; the default tenant rides at high priority with a
    full share (legacy traffic keeps legacy behavior); an *undeclared*
    name gets the unknown-tenant standing."""
    spec = specs.get(tenant)
    if spec is not None:
        return spec
    if tenant == DEFAULT_TENANT:
        return TenantSpec(name=DEFAULT_TENANT)
    return TenantSpec(name=tenant, priority=PRIORITY_LOW, share=UNKNOWN_SHARE)


def quota_of(spec: TenantSpec, capacity: int) -> int:
    """Integer admission quota for one tenant at a resource of size
    ``capacity``: share of capacity, floored at 1 (a configured tenant
    can always hold one token) and capped at capacity."""
    if capacity <= 0:
        return 0
    return max(1, min(capacity, int(spec.share * capacity)))


class TenantLedger:
    """Per-tenant occupancy against derived quotas at ONE bounded
    resource. Not locked: every embedding surface (AdmissionGate,
    DynamicBatcher, SlotScheduler) already serializes its admission path
    and calls the ledger under its own lock.

    With no specs configured (``enforcing`` False) the ledger still
    *accounts* (occupancy feeds the CLI/status plane) but never refuses
    — behavior is bit-identical to the pre-tenancy fleet.
    """

    def __init__(self, specs: Mapping[str, TenantSpec] | None, capacity: int):
        self.specs: dict[str, TenantSpec] = dict(specs or {})
        self.capacity = max(0, int(capacity))
        self.enforcing = bool(self.specs)
        self._active: dict[str, int] = {}
        self.over_quota_sheds: dict[str, int] = {}

    def spec(self, tenant: str) -> TenantSpec:
        return spec_for(tenant, self.specs)

    def quota(self, tenant: str) -> int:
        """This tenant's token quota here (the full capacity when no
        tenants are configured — legacy single-tenant behavior)."""
        if not self.enforcing:
            return self.capacity
        return quota_of(self.spec(tenant), self.capacity)

    def active(self, tenant: str) -> int:
        return self._active.get(tenant, 0)

    def would_exceed(self, tenant: str, n: int = 1) -> bool:
        """Would admitting ``n`` more tokens put ``tenant`` over quota?
        Never true when no tenants are configured."""
        if not self.enforcing:
            return False
        return self.active(tenant) + n > self.quota(tenant)

    def over_quota(self, tenant: str) -> bool:
        return self.enforcing and self.active(tenant) > self.quota(tenant)

    def note_shed(self, tenant: str) -> None:
        self.over_quota_sheds[tenant] = self.over_quota_sheds.get(tenant, 0) + 1

    def acquire(self, tenant: str, n: int = 1) -> None:
        self._active[tenant] = self.active(tenant) + n

    def release(self, tenant: str, n: int = 1) -> None:
        left = self.active(tenant) - n
        if left > 0:
            self._active[tenant] = left
        else:
            self._active.pop(tenant, None)

    def debt(self, tenant: str) -> int:
        """Tokens held BEYOND quota right now (0 when within). The CLI
        renders this as "quota debt" per tenant."""
        if not self.enforcing:
            return 0
        return max(0, self.active(tenant) - self.quota(tenant))

    def summary(self) -> dict[str, dict[str, object]]:
        """Per-tenant occupancy/quota/debt/sheds for status planes. Only
        tenants that are configured or currently active appear."""
        names = sorted(set(self.specs) | set(self._active) | set(self.over_quota_sheds))
        out: dict[str, dict[str, object]] = {}
        for name in names:
            spec = self.spec(name)
            out[name] = {
                "active": self.active(name),
                "quota": self.quota(name),
                "debt": self.debt(name),
                "priority": spec.priority,
                "over_quota_sheds": self.over_quota_sheds.get(name, 0),
            }
        return out
