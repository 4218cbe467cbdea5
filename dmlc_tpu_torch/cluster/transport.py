"""Datagram transport: real UDP for deployment, in-memory for the simulator.

Copied from ``dmlc_tpu/cluster/transport.py`` (the whole module).

The reference gossips over a raw UdpSocket with flexbuffers frames
(src/membership.rs:64,293-300) and was untestable off-cluster. Here the
membership protocol speaks to a Transport interface; the wire codec is
msgpack (schema-free like flexbuffers, available in this image).

``SimNetwork`` is the hermetic fabric: deterministic in-order delivery,
scriptable message drops and partitions — the fault-injection capability the
reference lacked (SURVEY.md §5 "Fault injection: none").
"""

from __future__ import annotations

import logging
import socket
import threading
from collections import deque
from typing import Callable

import msgpack

from dmlc_tpu_torch.cluster.auth import AuthError, FrameAuth

log = logging.getLogger(__name__)

Handler = Callable[[str, dict], None]  # (source_addr, message) -> None


def encode(msg: dict) -> bytes:
    return msgpack.packb(msg, use_bin_type=True)


def decode(data: bytes) -> dict:
    return msgpack.unpackb(data, raw=False)


class Transport:
    """One endpoint: can send datagrams to string addresses and receive via a
    handler. Addresses are opaque strings ("host:port" for UDP)."""

    address: str

    def send(self, dest: str, msg: dict) -> None:
        raise NotImplementedError

    def set_handler(self, handler: Handler) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class SimNetwork:
    """In-memory datagram fabric for N simulated nodes.

    Messages queue globally in send order; ``deliver_all()`` (or ``step()``)
    moves them to handlers. ``partition(a, b)`` / ``drop_from(addr)`` script
    faults. Deterministic: no threads, no real sockets, no wall clock.
    """

    def __init__(self):
        self.endpoints: dict[str, "SimTransport"] = {}
        self.queue: deque[tuple[str, str, bytes]] = deque()
        self.cut: set[tuple[str, str]] = set()      # directed (src, dst) blackholes
        self.down: set[str] = set()                 # crashed endpoints
        self.delivered = 0
        self.dropped = 0

    def endpoint(self, address: str) -> "SimTransport":
        ep = SimTransport(self, address)
        self.endpoints[address] = ep
        return ep

    def partition(self, a: str, b: str) -> None:
        """Cut both directions between a and b."""
        self.cut.add((a, b))
        self.cut.add((b, a))

    def heal(self, a: str, b: str) -> None:
        self.cut.discard((a, b))
        self.cut.discard((b, a))

    def crash(self, address: str) -> None:
        """Endpoint stops sending and receiving (process kill)."""
        self.down.add(address)

    def restart(self, address: str) -> None:
        self.down.discard(address)

    def _enqueue(self, src: str, dst: str, data: bytes) -> None:
        if src in self.down:
            return
        self.queue.append((src, dst, data))

    def deliver_all(self, max_messages: int = 100_000) -> int:
        """Drain the queue (including messages generated by handlers)."""
        n = 0
        while self.queue and n < max_messages:
            self._deliver(self.queue.popleft())
            n += 1
        return n

    def _deliver(self, item: tuple[str, str, bytes]) -> None:
        src, dst, data = item
        if (src, dst) in self.cut or dst in self.down or dst not in self.endpoints:
            self.dropped += 1
            return
        ep = self.endpoints[dst]
        if ep.handler is not None:
            ep.handler(src, decode(data))
            self.delivered += 1

    # ---- dmlc-mc schedule control (docs/MODELCHECK.md) -----------------
    # deliver_all preserves send order (the FIFO fidelity real UDP mostly
    # has); the model checker instead PICKS which in-flight datagram lands
    # next, so reorderings and selective loss become explicit schedule
    # choices rather than a property of the fabric.

    def pending(self) -> list[tuple[str, str]]:
        """(src, dst) of every in-flight datagram, in send order — the
        labels a schedule explorer enumerates its delivery choices from."""
        return [(src, dst) for src, dst, _ in self.queue]

    def deliver_one(self, index: int = 0) -> None:
        """Deliver exactly the index-th in-flight datagram, out of order."""
        item = self.queue[index]
        del self.queue[index]
        self._deliver(item)

    def drop_one(self, index: int = 0) -> tuple[str, str]:
        """Lose exactly the index-th in-flight datagram; returns its
        (src, dst) so the schedule trace stays self-describing."""
        src, dst, _ = self.queue[index]
        del self.queue[index]
        self.dropped += 1
        return (src, dst)


class SimTransport(Transport):
    def __init__(self, network: SimNetwork, address: str):
        self.network = network
        self.address = address
        self.handler: Handler | None = None

    def send(self, dest: str, msg: dict) -> None:
        self.network._enqueue(self.address, dest, encode(msg))

    def set_handler(self, handler: Handler) -> None:
        self.handler = handler


class UdpTransport(Transport):
    """Real UDP endpoint with a receiver thread.

    Datagram size is bounded by the 64 KiB UDP limit; the membership layer
    caps its gossip payload (config.gossip_max_entries) so pings stay under
    it at any fleet size (the reference's 4 KiB recv buffer,
    src/membership.rs:152, capped gossip size much lower).
    """

    RECV_BUF = 65536

    def __init__(self, host: str, port: int, auth: FrameAuth | None = None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        self.address = f"{host}:{self.sock.getsockname()[1]}"
        self.auth = auth
        if auth is not None:
            # Peers seal gossip datagrams for this endpoint's address;
            # open() rejects frames recorded in flight to other members.
            auth.add_identity(self.address)
        self.rejected = 0  # unauthenticated datagrams dropped (observability)
        self.send_errors = 0  # datagrams we failed to SEND (mirrors rejected)
        self._send_warned: set[str] = set()  # peers already debug-logged
        self.handler: Handler | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()

    def _recv_loop(self) -> None:
        self.sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                data, peer = self.sock.recvfrom(self.RECV_BUF)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                if self.auth is not None:
                    try:
                        data, _ = self.auth.open(data)
                    except AuthError:
                        # An unkeyed/forged datagram must not reach the
                        # membership state machine: a forged JOIN or FAILED
                        # claim is a remote eviction primitive.
                        self.rejected += 1
                        continue
                msg = decode(data)
                # Source is the SOCKET-observed peer (gossip sends from the
                # bound port, so this is host:gossip_port), never a
                # sender-asserted field — a spoofable claim the membership
                # identity must not rest on.
                src = f"{peer[0]}:{peer[1]}"
                if self.handler is not None:
                    self.handler(src, msg)
            except Exception:
                # A malformed or field-incomplete datagram must not kill the
                # receiver thread — a deaf node keeps pinging but never acks,
                # which reads as a failure to the whole ring.
                log.exception("dropping datagram that crashed the handler")

    def send(self, dest: str, msg: dict) -> None:
        host, _, port = dest.rpartition(":")
        data = encode(msg)
        try:
            if self.auth is not None:
                # Sealing inside the try: seal validates the recipient
                # length, and a corrupt gossiped address must be a dropped
                # datagram (like int(port) below), not a stepper crash.
                data = self.auth.seal(data, recipient=dest)
            self.sock.sendto(data, (host, int(port)))
        except (OSError, ValueError) as e:
            # Fire-and-forget (reference: membership.rs:293-300). ValueError
            # covers malformed addresses arriving via gossip — a corrupt entry
            # must not crash the stepper that pings it. The drop is COUNTED
            # (and debug-logged once per peer) so chaos runs can observe
            # send-side loss instead of mistaking it for network drops.
            self.send_errors += 1
            if dest not in self._send_warned:
                self._send_warned.add(dest)
                log.debug("send to %s failed (counted in send_errors): %s", dest, e)

    def set_handler(self, handler: Handler) -> None:
        self.handler = handler

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.sock.close()
