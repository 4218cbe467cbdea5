"""Shared-key frame authentication + replay protection for the control plane.

Copied from ``dmlc_tpu/cluster/auth.py`` (the whole module).

The reference's control plane was only as safe as its network: any process
that could reach a tarpc port could call Leader/Member services directly
(src/main.rs:43-83) — it leaned on the fleet's ssh trust boundary
(src/services.rs:244-272) rather than authenticating traffic. Here both
fabrics (msgpack-TCP RPC and UDP gossip) carry an HMAC-SHA256 tag over every
frame when ``ClusterConfig.auth_key`` is set: unauthenticated or tampered
frames are dropped before any payload parsing, so reaching a port no longer
grants ``sdfs.delete`` / ``job.start``.

Replay protection: every sealed frame carries a per-sender monotonic
sequence number (nanosecond clock, forced strictly increasing per process)
AND the intended recipient address inside the MAC'd region. A receiver
tracks, per sender, the highest sequence seen plus a sliding window of
recently accepted values:

- a frame whose recipient is not one of the receiver's registered
  identities is rejected — a frame recorded in flight to member A cannot
  be replayed (even once, even fresh) against members B..Z, whose replay
  windows for the sender are independent of A's,
- a frame at or below ``highest - window`` is rejected (too old),
- a frame inside the window that was already accepted is rejected (replay),
- out-of-order but fresh UDP datagrams inside the window still pass,
- the FIRST frame from a sender this receiver has no state for must be
  within ``max_age_s`` of the receiver's clock — so a recorded frame cannot
  be replayed against a freshly restarted receiver long after capture.
  (Within ``max_age_s`` of capture, a restart-then-replay against the SAME
  recipient races the real sender's next frame; the bound is freshness, not
  perfect one-shot semantics. The reference had no authentication at all.)

Design notes:
- The tag is truncated to 16 bytes (standard HMAC truncation; 128-bit
  forgery resistance) to keep gossip datagrams small.
- Authentication, not encryption: payloads are readable on the wire, they
  just cannot be forged, altered, or replayed. Matches the threat ("any
  host can write to the control plane"), not a full TLS story.
- The freshness bound assumes fleet clocks within ``max_age_s`` (default
  120 s) of each other — ordinary NTP territory, and only consulted for
  senders with no receiver-side state yet.
- Clock-regression constraint for KNOWN senders: sequence numbers are
  wall-clock nanoseconds, so a process that restarts under the same sender
  id ("host:port") with a clock more than ``window_s`` (default 60 s)
  BEHIND its previous run re-enters below the high-water mark peers retain
  for it, and its frames are rejected ("below replay window") until its
  clock passes the old mark. This is tighter than the ``max_age_s`` skew
  bound above and is deliberate: auto-resetting a peer window on a
  below-floor-but-fresh sequence would let an attacker replay any recorded
  frame in the (window_s, max_age_s] age range once per reset. Operators
  restarting a node behind a badly-regressed clock can wait out the
  window or restart it under a fresh port.
"""

from __future__ import annotations

import hmac
import hashlib
import os
import struct
import threading
import time
from typing import Callable


TAG_BYTES = 16
# version, sequence (ns clock), sender len, recipient len — the version
# byte (MAC'd with the rest) makes envelope-format changes explicit: a
# mixed-version fleet fails with "unsupported frame version", not with
# shifted-field parses that masquerade as recipient mismatches.
_HDR = struct.Struct("!BQBB")
_VERSION = 2  # v1 was the unversioned !QB sender-only envelope (round 4)
_MAX_SENDERS = 1024  # replay-state LRU bound: gossip fan-in is << this


class AuthError(Exception):
    """Frame failed authentication (missing, truncated, wrong tag, wrong
    recipient, replay)."""


class FrameAuth:
    """Seals/opens byte frames: truncated HMAC-SHA256 tag over a
    (sequence, sender, recipient, payload) envelope, with receiver-side
    replay windows and destination binding.

    One instance per process (a node's gossip endpoint, RPC client, and RPC
    servers share it); each listening endpoint registers its advertised
    address via :meth:`add_identity` so ``open`` can verify the sealed
    recipient names THIS process. Safe for concurrent use (server
    connection threads share the receiver state under a lock).
    """

    def __init__(
        self,
        key: str | bytes,
        sender: str | None = None,
        window_s: float = 60.0,
        max_age_s: float = 120.0,
        now_ns: Callable[[], int] | None = None,
    ):
        if not key:
            raise ValueError("FrameAuth requires a non-empty key")
        # Injectable nanosecond clock (sans-IO discipline, cluster/clock.py):
        # sequence numbers and the unknown-sender freshness bound both read
        # it, so tests can drive replay-window scenarios deterministically.
        # The default IS wall time — the replay protocol's freshness bound
        # is anchored to real clocks across the fleet by design.
        self._now_ns = now_ns or time.time_ns
        self._key = key.encode() if isinstance(key, str) else bytes(key)
        sid = (sender or os.urandom(8).hex()).encode()
        if len(sid) > 255:
            raise ValueError("sender id longer than 255 bytes")
        self._sender = sid
        self._window_ns = int(window_s * 1e9)
        self._max_age_ns = int(max_age_s * 1e9)
        self._lock = threading.Lock()
        self._last_seq = 0
        # Addresses this process answers for: its own sender id (replies
        # come back addressed to it) plus every server/transport address
        # registered via add_identity.
        self._identities: set[bytes] = {sid}
        # sender id -> (highest seq seen, set of accepted seqs in window)
        self._peers: dict[bytes, tuple[int, set[int]]] = {}

    def add_identity(self, address: str | bytes) -> None:
        """Register an address this process listens on (server bind address,
        gossip endpoint) as a valid sealed-frame recipient."""
        aid = address.encode() if isinstance(address, str) else bytes(address)
        if not aid or len(aid) > 255:
            raise ValueError("identity must be 1..255 bytes")
        with self._lock:
            self._identities.add(aid)

    def _tag(self, data: bytes) -> bytes:
        return hmac.new(self._key, data, hashlib.sha256).digest()[:TAG_BYTES]

    def seal(self, data: bytes, recipient: str | bytes) -> bytes:
        """Seal ``data`` for one destination address; ``open`` at any
        process not answering for that address rejects the frame."""
        rid = recipient.encode() if isinstance(recipient, str) else bytes(recipient)
        if not rid or len(rid) > 255:
            raise ValueError("recipient must be 1..255 bytes")
        with self._lock:
            seq = max(self._last_seq + 1, self._now_ns())
            self._last_seq = seq
        body = (
            _HDR.pack(_VERSION, seq, len(self._sender), len(rid))
            + self._sender + rid + data
        )
        return self._tag(body) + body

    def open(self, frame: bytes) -> tuple[bytes, bytes]:
        """Verify and unwrap a sealed frame.

        Returns ``(payload, sender_id)`` — servers address their reply to
        the authenticated sender id. Raises :class:`AuthError` on any
        failure, including a recipient that is not one of this process's
        registered identities.
        """
        if len(frame) < TAG_BYTES + _HDR.size:
            raise AuthError(f"frame of {len(frame)} bytes is shorter than the envelope")
        tag, body = frame[:TAG_BYTES], frame[TAG_BYTES:]
        if not hmac.compare_digest(tag, self._tag(body)):
            raise AuthError("bad frame tag")
        version, seq, sender_len, recipient_len = _HDR.unpack_from(body)
        if version != _VERSION:
            raise AuthError(f"unsupported frame version {version}")
        sender_end = _HDR.size + sender_len
        recipient_end = sender_end + recipient_len
        sender = body[_HDR.size:sender_end]
        recipient = body[sender_end:recipient_end]
        if len(sender) != sender_len or len(recipient) != recipient_len:
            raise AuthError("truncated sender/recipient id")
        with self._lock:
            addressed_here = recipient in self._identities
        if not addressed_here:
            raise AuthError("frame sealed for a different recipient")
        self._check_replay(sender, seq)
        return body[recipient_end:], sender

    def _check_replay(self, sender: bytes, seq: int) -> None:
        with self._lock:
            state = self._peers.get(sender)
            if state is None:
                if abs(seq - self._now_ns()) > self._max_age_ns:
                    raise AuthError("stale frame from unknown sender")
                if len(self._peers) >= _MAX_SENDERS:
                    # Evict the peer with the oldest highest-seen sequence:
                    # a flood of fake sender ids cannot grow state unboundedly.
                    evict = min(self._peers, key=lambda s: self._peers[s][0])
                    del self._peers[evict]
                self._peers[sender] = (seq, {seq})
                return
            highest, seen = state
            floor = highest - self._window_ns
            if seq <= floor:
                raise AuthError("frame sequence below replay window")
            if seq in seen:
                raise AuthError("replayed frame")
            if seq > highest:
                highest = seq
                floor = highest - self._window_ns
                seen = {s for s in seen if s > floor}
            seen.add(seq)
            self._peers[sender] = (highest, seen)


def maybe_auth(key: str | bytes | None, sender: str | None = None) -> FrameAuth | None:
    """Config plumbing: '' / None mean authentication disabled."""
    return FrameAuth(key, sender=sender) if key else None
