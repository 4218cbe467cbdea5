"""Ring-neighbor topology.

Copied from ``dmlc_tpu/utils/ring.py`` (the whole module).

Capability parity with the reference's ``symmetric_ring_neighbors``
(reference: src/utils.rs:5-21): given a sorted ring of node ids, pick the k
nearest predecessors and k nearest successors of ``self_id`` with wrap-around,
deduplicated, optionally filtered by a predicate (the reference filters to
Active members, src/membership.rs:242-246).

The heartbeat fan-out of the gossip layer (cluster/membership.py) pings exactly
this neighbor set every round, which bounds per-node network load at O(k) while
keeping the failure-detection graph connected.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, TypeVar

T = TypeVar("T")


def symmetric_ring_neighbors(
    ids: Iterable[T],
    self_id: T,
    k: int,
    predicate: Callable[[T], bool] | None = None,
) -> list[T]:
    """k predecessors + k successors of ``self_id`` on the sorted id ring.

    ``ids`` need not contain ``self_id``. Results are deduplicated (small rings
    where the windows overlap yield fewer than 2k neighbors) and never include
    ``self_id`` itself. Order: predecessors nearest-first, then successors
    nearest-first.
    """
    ring: list[T] = sorted(x for x in set(ids) if x != self_id and (predicate is None or predicate(x)))
    if not ring or k <= 0:
        return []
    # Position where self_id would be inserted: successors start here.
    import bisect

    pos = bisect.bisect_left(ring, self_id)
    n = len(ring)
    out: list[T] = []
    seen: set[T] = set()
    for i in range(1, k + 1):  # predecessors, nearest first
        cand = ring[(pos - i) % n]
        if cand not in seen:
            seen.add(cand)
            out.append(cand)
    for i in range(k):  # successors, nearest first
        cand = ring[(pos + i) % n]
        if cand not in seen:
            seen.add(cand)
            out.append(cand)
    return out
