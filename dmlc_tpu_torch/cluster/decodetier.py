"""Distributed decode tier: fan raw JPEG bytes across members' idle lanes.

Copied from ``dmlc_tpu/cluster/decodetier.py`` (the whole module; its
local decode is this package's ``ops/preprocess.decode_blobs``): the wire
format of ``job.decode`` is the JAX package's, so the tier fans chunks out
to members of either package.

Single-host ingest is decode-bound: one host's CPU decodes JPEGs far
slower than the device consumes them. SDFS already scales storage with membership; this module does the same for
JPEG decode. The unit of work is a contiguous *chunk* of raw encoded-image
blobs shipped to a member's ``job.decode`` verb (scheduler/worker.py),
which answers one device-ready uint8 tensor block from its persistent
decode pool. The client shards a batch into chunks, fans them out on a
PERSISTENT pool (lint H1: never a per-call executor), and reassembles in
order by writing each chunk into its own disjoint slice of one
preallocated output — exactly-once, in-order tensor delivery by
construction, no matter which member answered which chunk.

Failure classes are kept apart deliberately (docs/OVERLOAD.md):

- **Transport / overload / deadline** — the peer is sick or drowning: the
  retry policy is charged (breaker accounting) and the chunk reroutes to
  the next peer, degrading to local decode when every peer is out.
- **``DecodeError``** — the peer is HEALTHY and the input is poison: the
  member's answer proves liveness (recorded as success, no retry token
  spent) and the chunk's blobs are retried locally exactly once; blobs
  that still refuse stay zero-filled and count as ``decode_tier_poison``.

Wire format (msgpack, over the existing RPC fabric): request
``{"size": S, "blobs": [bytes, ...]}``; reply ``{"n": N, "size": S,
"data": <N*S*S*3 uint8 bytes>}``. Chunks are bounded by
``max_bytes_per_rpc`` so one oversized batch can never wedge a control
frame, and batches under ``min_batch`` skip the tier entirely — the RPC
round-trip would cost more than the decode.
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
import time
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Sequence

import numpy as np

from dmlc_tpu_torch.cluster.rpc import DecodeError, Rpc, RpcError
from dmlc_tpu_torch.utils.hotpath import hot_path
from dmlc_tpu_torch.utils.tracing import tracer

if TYPE_CHECKING:
    from dmlc_tpu_torch.cluster.flight import FlightRecorder
    from dmlc_tpu_torch.cluster.retrypolicy import RetryPolicy
    from dmlc_tpu_torch.utils.metrics import Metrics

log = logging.getLogger(__name__)


class DecodeTierClient:
    """Fan-out/reassembly client for the fleet decode tier.

    ``members`` is a zero-arg callable returning the CURRENT decode-capable
    peer addresses (the node passes its live membership view minus itself),
    so the tier reacts to joins/crashes without owning membership. The
    fan-out pool is built once here — constructing this client inside a hot
    function is itself an H1 lint finding, exactly like any other pool.
    """

    def __init__(
        self,
        rpc: Rpc,
        members: Callable[[], Sequence[str]],
        *,
        min_batch: int = 16,
        max_bytes_per_rpc: int = 4 * 1024 * 1024,
        timeout_s: float = 30.0,
        fanout: int = 8,
        retry_policy: RetryPolicy | None = None,
        metrics: Metrics | None = None,
        flight: FlightRecorder | None = None,
        clock: Callable[[], float] | None = None,
    ) -> None:
        self.rpc = rpc
        # Injectable timebase (lint D1): the sim harness passes its virtual
        # clock; production reads the process monotonic clock.
        self._clock = clock or time.perf_counter
        self.members = members
        self.min_batch = int(min_batch)
        self.max_bytes_per_rpc = int(max_bytes_per_rpc)
        self.timeout_s = float(timeout_s)
        self.retry_policy = retry_policy
        self.metrics = metrics
        self.flight = flight
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, int(fanout)), thread_name_prefix="decode-tier"
        )
        # Effective fan-out: how many chunks a batch shards into. The pool
        # above is the hard ceiling (built once — lint H1); the autoscaler
        # moves this bound inside [1, ceiling] to trade ingest parallelism
        # against RPC pressure on a burning fleet.
        self.max_fanout = max(1, int(fanout))
        self._fanout = self.max_fanout
        self._lock = threading.Lock()
        # Tier accounting (decode_tier_* counters mirror into ``metrics``).
        self.remote_decoded = 0   # images decoded by a peer
        self.local_decoded = 0    # images decoded on this host (fallback/small)
        self.poison = 0           # blobs no one could decode (zero-filled)
        self.remote_failures = 0  # chunk attempts lost to transport errors
        self._busy_s = 0.0        # decode_batch wall seconds
        self._images = 0          # images through decode_batch

    # ---- autoscaler seam -------------------------------------------------

    def set_fanout(self, fanout: int) -> int:
        """Bound concurrent chunk fan-out to ``fanout``, clamped to
        [1, construction-time pool width]. Returns the effective value —
        the actuator records what actually took, not what it asked for."""
        with self._lock:
            self._fanout = max(1, min(self.max_fanout, int(fanout)))
            return self._fanout

    def fanout(self) -> int:
        with self._lock:
            return self._fanout

    # ---- stats ----------------------------------------------------------

    def stats(self) -> dict[str, int | float | None]:
        """Per-stage decode-tier stats (bench_detail.json's ``decode_tier``
        section): local vs remote decoded counts and the measured fleet
        decode rate over everything this client has pushed through."""
        with self._lock:
            rate = self._images / self._busy_s if self._busy_s > 0 else None
            return {
                "remote": self.remote_decoded,
                "local": self.local_decoded,
                "poison": self.poison,
                "remote_failures": self.remote_failures,
                "fleet_decode_img_s": round(rate, 1) if rate else None,
                "fanout": self._fanout,
            }

    # ---- decode entry points --------------------------------------------

    def decode_paths(self, paths: Sequence[str | Path], size: int) -> np.ndarray:
        """``run_paths_stream`` decode_source seam: local file paths ->
        device-ready uint8 batch through the tier. Reading raw bytes is
        ~100x cheaper than decoding them; the decode itself lands wherever
        the tier routes it."""
        return self.decode_batch([Path(p).read_bytes() for p in paths], size)

    @hot_path
    def decode_batch(self, blobs: Sequence[bytes], size: int) -> np.ndarray:
        """Raw blobs -> uint8 [N, size, size, 3], order-preserving. Small
        batches (or an empty fleet) decode locally; otherwise chunks fan
        out concurrently and each lands in its own output slice."""
        n = len(blobs)
        out = np.zeros((n, size, size, 3), np.uint8)
        if not n:
            return out
        t0 = self._clock()
        try:
            peers = [str(m) for m in (self.members() or [])]
        except Exception:
            peers = []
        if n < self.min_batch or not peers:
            self._decode_local(list(blobs), 0, out, size)
        else:
            chunks = self._chunks(blobs, min(len(peers), self.fanout()))
            with tracer.span("ingest/decode_tier", n=n, chunks=len(chunks)):
                futs = [
                    self._pool.submit(
                        self._decode_chunk, blobs, start, stop, out, size, peers, i
                    )
                    for i, (start, stop) in enumerate(chunks)
                ]
                for f in futs:
                    f.result()  # re-raise chunk worker bugs, never swallow
        with self._lock:
            self._busy_s += self._clock() - t0
            self._images += n
        return out

    # ---- internals ------------------------------------------------------

    def _chunks(self, blobs: Sequence[bytes], n_peers: int) -> list[tuple[int, int]]:
        """Contiguous chunk boundaries: roughly even across peers, each
        chunk bounded by ``max_bytes_per_rpc``."""
        target = max(1, -(-len(blobs) // max(1, n_peers)))
        chunks: list[tuple[int, int]] = []
        start, chunk_bytes = 0, 0
        for i, b in enumerate(blobs):
            if i > start and (
                chunk_bytes + len(b) > self.max_bytes_per_rpc or i - start >= target
            ):
                chunks.append((start, i))
                start, chunk_bytes = i, 0
            chunk_bytes += len(b)
        chunks.append((start, len(blobs)))
        return chunks

    def _decode_chunk(
        self,
        blobs: Sequence[bytes],
        start: int,
        stop: int,
        out: np.ndarray,
        size: int,
        peers: list[str],
        idx: int,
    ) -> None:
        chunk = list(blobs[start:stop])
        first = idx % len(peers)
        for dest in peers[first:] + peers[:first]:
            if self.retry_policy is not None and not self.retry_policy.allow(dest):
                continue  # breaker open: don't waste the chunk's time on it
            try:
                reply = self.rpc.call(
                    dest,
                    "job.decode",
                    {"size": int(size), "blobs": chunk},
                    timeout=self.timeout_s,
                )
            except DecodeError as e:
                # Poison input, not peer health: record SUCCESS (the member
                # answered) so no breaker/retry budget is charged, then
                # retry the chunk's blobs locally exactly once.
                if self.retry_policy is not None:
                    self.retry_policy.record(dest)
                log.warning(
                    "decode tier: %s refused chunk [%d:%d) as poison: %s",
                    dest, start, stop, e,
                )
                self._decode_local(chunk, start, out, size)
                return
            except RpcError as e:
                # Transport/overload/deadline class: charge the policy,
                # reroute to the next peer.
                if self.retry_policy is not None:
                    self.retry_policy.record(dest, e)
                with self._lock:
                    self.remote_failures += 1
                log.debug("decode tier: %s lost chunk [%d:%d): %s", dest, start, stop, e)
                continue
            arr = np.frombuffer(reply["data"], np.uint8)
            out[start:stop] = arr.reshape(len(chunk), size, size, 3)
            if self.retry_policy is not None:
                self.retry_policy.record(dest)
            with self._lock:
                self.remote_decoded += len(chunk)
            if self.metrics is not None:
                self.metrics.inc("decode_tier_remote", len(chunk))
            return
        # Every peer unreachable/refusing: the tier degrades, never drops.
        self._decode_local(chunk, start, out, size)

    def _decode_local(
        self, chunk: list[bytes], start: int, out: np.ndarray, size: int
    ) -> None:
        from dmlc_tpu_torch.ops import preprocess as pp

        arr, status = pp.decode_blobs(chunk, size=size)
        out[start : start + len(chunk)] = arr
        bad = int(status.sum())
        with self._lock:
            self.local_decoded += len(chunk) - bad
            self.poison += bad
        if self.metrics is not None:
            self.metrics.inc("decode_tier_local", len(chunk) - bad)
            if bad:
                self.metrics.inc("decode_tier_poison", bad)
        if bad and self.flight is not None:
            self.flight.note("decode_poison", blobs=bad, offset=start)


__all__ = ["DecodeTierClient"]
