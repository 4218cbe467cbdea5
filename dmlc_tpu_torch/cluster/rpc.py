"""RPC error types the member-side worker raises.

Copied from ``dmlc_tpu/cluster/rpc.py``. The msgpack TCP fabric and the
simulator around them are not part of this package yet: the worker's
``methods()`` table is the seam a fabric plugs into.
"""

from __future__ import annotations


class RpcError(Exception):
    """Transport failure or remote method failure."""


class Overloaded(RpcError):
    """The destination shed the request at admission (queue full). Carries a
    retry-after hint; message always carries ``overloaded:`` so the verdict
    survives the wire.

    ``tenant`` + ``quota`` carry the admission verdict for multi-tenant
    gates: which tenant was refused and why — ``"over_quota"`` (the tenant
    exhausted its own share; peers still have room) vs ``"gate_full"`` (the
    whole resource is saturated)."""

    def __init__(
        self,
        msg: str,
        retry_after_s: float | None = None,
        tenant: str | None = None,
        quota: str | None = None,
    ):
        super().__init__(msg if "overloaded:" in msg else f"overloaded: {msg}")
        self.retry_after_s = retry_after_s
        self.tenant = tenant
        self.quota = quota


class DecodeError(RpcError):
    """The destination executed ``job.decode`` but the shipped bytes were
    undecodable (poison input, not peer health). Message always carries
    ``decode_error:`` so the verdict survives the wire. A member that
    answered "your JPEG is garbage" proved its own liveness, so callers
    must not charge its breaker for it."""

    def __init__(self, msg: str):
        super().__init__(msg if "decode_error:" in msg else f"decode_error: {msg}")
