"""Control-plane RPC: named methods over msgpack frames.

Copied from ``dmlc_tpu/cluster/rpc.py`` (the whole module): the frames
(``m/p/d/t/n``, msgpack, sealed by cluster/auth.py when keyed) are the JAX
package's frames byte for byte, so a member of either package answers a
client of the other. The SDFS, the node and the leader's job scheduler that
run on this fabric in the JAX package are not ported yet.

The reference uses tarpc JSON-over-TCP for its Leader/Member services
(src/services.rs:38-52,443-448; src/main.rs:43-83). Here the same capability
is a small synchronous RPC layer with two fabrics:

- ``SimRpcNetwork`` — deterministic in-process dispatch for the simulator:
  scriptable crashes, partitions, and per-link latency, no sockets, no
  threads. This is what the hermetic cluster tests run on (the
  fake-transport strategy the reference declared via its unused
  ``mockstream`` dev-dependency but never built, SURVEY.md §4).
- ``TcpRpcServer`` / ``tcp_call`` — real length-prefixed msgpack frames over
  TCP for deployment, one connection per call (control traffic is tiny; bulk
  tensor bytes never ride this path — they go host->HBM via the staging
  pipeline, and device-to-device over ICI via XLA collectives).

A "service" is just a dict of method-name -> callable(payload dict) -> reply
dict. Method errors travel back as ``RpcError`` with the remote message.

Overload control (docs/OVERLOAD.md): every call carries a *deadline* — the
remaining budget in seconds, frame field ``d`` — computed from the explicit
timeout capped by any inherited deadline (cluster/deadline.py). Servers
check the budget before AND after method execution and bind it ambiently,
so nested calls (leader -> member -> SDFS pull) inherit the caller's budget
instead of resetting to a fresh default. Typed failures —
``DeadlineExceeded`` and ``Overloaded`` (with a retry-after hint) — survive
the wire via message prefixes, so retry policy can tell "peer drowning"
from "method bug".
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from time import monotonic
from typing import Callable

try:
    import msgpack
except ImportError as e:  # the frame format itself: there is no other encoding
    raise ImportError("dmlc_tpu_torch.cluster.rpc needs msgpack for its frames") from e

from dmlc_tpu_torch.cluster import deadline as deadline_mod
from dmlc_tpu_torch.cluster import tenant as tenant_mod
from dmlc_tpu_torch.cluster import tracectx
from dmlc_tpu_torch.cluster.auth import AuthError, FrameAuth
from dmlc_tpu_torch.utils import tracing

log = logging.getLogger(__name__)

Method = Callable[[dict], dict]

#: Verbs that are SAFE TO DELIVER MORE THAN ONCE per logical request — the
#: at-least-once contract of every retrying caller in the tree. A verb
#: belongs here iff a duplicate execution (lost reply -> caller re-sends;
#: network-level replay) cannot corrupt state or double-count an effect:
#: pure reads, pure compute, set-semantics merges, and the cumulative-ack
#: poll protocol. dmlc-analyze rule A9 (tools/analyze/rules/retrysafety.py)
#: flags any verb dispatched on a RetryPolicy-governed retry path that is
#: missing from this table, and dmlc-mc (tools/mc) reads it to decide where
#: duplicate-delivery injection is a legal schedule choice. Values are the
#: one-line justification a reviewer should be able to refute.
IDEMPOTENT_VERBS: dict[str, str] = {
    # pure compute: output is a function of the request payload only
    "job.predict": "stateless forward pass; duplicates waste work, not state",
    "job.predict_gang": "stateless gang forward pass",
    "job.decode_gang": "stateless gang decode pass",
    "job.decode": "pure JPEG decode of shipped bytes",
    # pure reads
    "sdfs.get": "directory lookup of (name, version) -> replicas + digest",
    "sdfs.fetch": "read of an immutable (name, version) blob",
    "sdfs.fetch_meta": "read of an immutable (name, version) sidecar",
    "sdfs.fetch_chunk": "read of an immutable (name, version) byte range",
    "leader.status": "leadership/epoch read",
    "obs.metrics": "metrics snapshot read",
    # set-semantics merges: re-applying the same fact is a no-op
    "sdfs.announce": "inventory merge; re-announcing the same set converges",
    "sdfs.report_corrupt": "corruption verdict is a set insert",
    # the exactly-once substrate itself: chunks are retained until the
    # CUMULATIVE ack covers them, so a replayed poll re-reads identical
    # chunks and the client dedups by seq (generate/slots.GenStream)
    "job.generate_poll": "cumulative-ack chunk retention dedups replays",
    # session-plane verbs keyed by a caller-chosen gen_id
    "job.generate": "gen_id dedup: a re-submit finds the live stream "
                    "(resumed) instead of a second prefill",
    "job.generate_cancel": "keyed delete; a repeat finds nothing and "
                           "reports cancelled=False",
}

#: dmlc-mc schedule-choice actions a SimRpcNetwork hook may return.
MC_DELIVER = "deliver"            # normal dispatch
MC_DROP_REQUEST = "drop_request"  # lost before the method ran
MC_DROP_REPLY = "drop_reply"      # method ran; the caller never hears
MC_DUPLICATE = "duplicate"        # delivered twice (at-least-once replay)


class RpcError(Exception):
    """Transport failure or remote method failure."""


class RpcUnreachable(RpcError):
    """The destination did not answer (down, partitioned, refused)."""


class DeadlineExceeded(RpcError):
    """The call's propagated budget ran out (before dialing, on arrival, or
    during method execution). Message always carries ``deadline:`` so the
    verdict survives the fabric's error-to-string flattening."""

    def __init__(self, msg: str):
        super().__init__(msg if "deadline:" in msg else f"deadline: {msg}")


class Overloaded(RpcError):
    """The destination shed the request at admission (queue full). Carries a
    retry-after hint; message always carries ``overloaded:`` so the verdict
    survives the wire.

    ``tenant`` + ``quota`` carry the admission verdict for multi-tenant
    gates (docs/OVERLOAD.md §Priority classes): which tenant was refused
    and why — ``"over_quota"`` (the tenant exhausted its own share; peers
    still have room) vs ``"gate_full"`` (the whole resource is saturated).
    Both survive the wire as dedicated reply fields, so a client can tell
    "slow down, it's you" from "the fleet is drowning"."""

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
    ``decode_error:`` so the verdict survives the wire. Deliberately NOT in
    retrypolicy's overload class: a member that answered "your JPEG is
    garbage" proved its own liveness — charging its breaker or spending
    retry tokens on the same poison blob would punish the healthy peer for
    the caller's input."""

    def __init__(self, msg: str):
        super().__init__(msg if "decode_error:" in msg else f"decode_error: {msg}")


def remote_error(
    msg: str,
    retry_after_s: float | None = None,
    tenant: str | None = None,
    quota: str | None = None,
) -> RpcError:
    """Re-type a remote error string: the server flattened the exception to
    ``ClassName: message``; the prefixes put the type back so client-side
    retry policy keys on it. The tenant/quota verdict fields (when the
    remote gate supplied them) re-attach to the rebuilt ``Overloaded``."""
    if "deadline:" in msg:
        return DeadlineExceeded(msg)
    if "overloaded:" in msg:
        return Overloaded(msg, retry_after_s=retry_after_s, tenant=tenant, quota=quota)
    if "decode_error:" in msg:
        return DecodeError(msg)
    return RpcError(msg)


def _now() -> float:
    # The real-IO fabric's clock seam. The Sim fabric never calls this — it
    # runs on its own virtual clock (SimRpcNetwork.now).
    return monotonic()  # dmlc-lint: disable=D1 -- TCP fabric phase deadlines are genuinely wall-time


class Rpc:
    """Client interface: synchronous call to a named method at an address.

    ``timeout`` is this hop's ceiling; ``deadline`` (a Deadline or plain
    seconds-remaining) caps it further, as does any ambient deadline bound
    by an enclosing serving scope."""

    def call(
        self,
        addr: str,
        method: str,
        payload: dict,
        timeout: float = 60.0,
        deadline=None,
    ) -> dict:
        raise NotImplementedError


def _dispatch(methods: dict[str, Method], method: str, payload: dict) -> dict:
    fn = methods.get(method)
    if fn is None:
        raise RpcError(f"unknown method {method!r}")
    return fn(payload)


def serve_with_deadline(
    methods: dict[str, Method],
    method: str,
    payload: dict,
    budget_s: float | None,
    clock: Callable[[], float],
    trace=None,
    lane: str | None = None,
    tenant=None,
) -> dict:
    """Server-side dispatch under the caller's propagated budget: refuse
    work that arrives already expired, bind the deadline ambiently so
    nested calls inherit it, and refuse to *return* a result the caller has
    already given up on (the reply would be dead bytes; the caller must see
    the same verdict its own clock reached).

    ``trace`` is the frame's ``t`` field (cluster/tracectx.py): it is bound
    ambiently — INCLUDING the None case, which clears any context inherited
    on the caller's stack, so the sim fabric propagates exactly what the
    wire carries and nothing more. ``tenant`` is the frame's ``n`` field
    (cluster/tenant.py), bound identically — an absent field clears to the
    default tenant, so legacy callers on a mixed-version fleet keep their
    pre-tenancy standing. ``lane`` is the serving node's identity, bound so
    every span the handler opens attributes to this node."""
    with tracing.lane(lane), tracectx.bind(tracectx.from_wire(trace)), \
            tenant_mod.bind(tenant_mod.from_wire(tenant)):
        if budget_s is None:
            return _dispatch(methods, method, payload)
        budget_s = float(budget_s)
        if budget_s <= 0:
            raise DeadlineExceeded(f"{method}: budget exhausted on arrival")
        dl = deadline_mod.Deadline(budget_s, clock=clock)
        with deadline_mod.bind(dl):
            reply = _dispatch(methods, method, payload)
        if dl.expired():
            raise DeadlineExceeded(
                f"{method}: finished {-dl.remaining():.3f}s past its "
                f"{budget_s:.3f}s deadline"
            )
        return reply


class SimRpcNetwork(Rpc):
    """Deterministic in-process RPC fabric.

    Services register under string addresses; calls dispatch synchronously on
    the caller's stack. Crashed or partitioned destinations raise
    ``RpcUnreachable`` exactly like a dead TCP peer would.

    Time is VIRTUAL: ``now`` advances only through scripted per-link latency
    (``set_latency``) or explicit test advancement (``advance``), so
    timeout/deadline/breaker behavior replays deterministically. A call
    whose link latency meets or exceeds its budget times out (``now``
    advances by the full budget — the caller really waited that long) and
    the method never runs; otherwise the latency is charged against the
    propagated deadline before dispatch, exactly like wire transit."""

    def __init__(self):
        self.services: dict[str, dict[str, Method]] = {}
        self.down: set[str] = set()
        self.cut: set[tuple[str, str]] = set()
        self.calls: list[tuple[str, str]] = []  # (addr, method) trace for tests
        # Frame METADATA per call ({"m", "d"} + "t"/"n" when present — payload
        # deliberately excluded so soak tests don't pin every transferred
        # blob in memory), for tests that assert on the wire format.
        self.frames: list[dict] = []
        self.now = 0.0                          # virtual clock (seconds)
        self.latency: dict[tuple[str, str], float] = {}  # (src, dst) -> s
        # dmlc-mc schedule hook (docs/MODELCHECK.md): called per reachable
        # call with (source, addr, method); returns one of the MC_* actions.
        # The fabric stays byte-identical with the hook unset — the None
        # check is the entire production cost of the seam.
        self.mc_hook: Callable[[str, str, str], str] | None = None

    def serve(self, addr: str, methods: dict[str, Method]) -> None:
        self.services[addr] = methods

    def crash(self, addr: str) -> None:
        self.down.add(addr)

    def restart(self, addr: str) -> None:
        self.down.discard(addr)

    def partition(self, a: str, b: str) -> None:
        self.cut.add((a, b))
        self.cut.add((b, a))

    def heal(self, a: str, b: str) -> None:
        self.cut.discard((a, b))
        self.cut.discard((b, a))

    def set_latency(self, src: str, dst: str, seconds: float) -> None:
        """Script one direction's transit latency (0 restores instant)."""
        if seconds <= 0:
            self.latency.pop((src, dst), None)
        else:
            self.latency[(src, dst)] = float(seconds)

    def advance(self, seconds: float) -> None:
        """Advance the virtual clock (tests model think-time/idleness)."""
        if seconds < 0:
            raise ValueError("time goes forward")
        self.now += seconds

    def clock(self) -> float:
        """The virtual clock as a callable-friendly read (pass
        ``net.clock`` wherever a monotonic timer is injected)."""
        return self.now

    def client(self, source: str) -> "SimRpcClient":
        return SimRpcClient(self, source)

    def _call_from(
        self,
        source: str,
        addr: str,
        method: str,
        payload: dict,
        timeout: float = 60.0,
        deadline=None,
    ) -> dict:
        self.calls.append((addr, method))
        budget = deadline_mod.resolve_budget(timeout, deadline)
        if budget <= 0:
            raise DeadlineExceeded(f"{addr}/{method}: no budget remaining before dialing")
        if source in self.down:
            raise RpcUnreachable(f"{source} is down")
        if addr in self.down or addr not in self.services or (source, addr) in self.cut:
            raise RpcUnreachable(f"{addr} unreachable from {source}")
        lat = self.latency.get((source, addr), 0.0)
        if lat >= budget:
            # The caller waits out its whole budget before giving up; the
            # frame is still in flight, so the method never executes here
            # (the deterministic reading of "the reply came too late").
            self.now += budget
            raise RpcUnreachable(
                f"{addr}: no reply within {budget:.3f}s (link latency {lat:.3f}s)"
            )
        self.now += lat
        # The frame as the TCP fabric would build it: `t` is present only
        # when a trace context is ambient (tracing disabled or no open span
        # -> no field -> zero frame bytes), and the server re-binds FROM the
        # frame, never from the caller's stack.
        frame: dict = {"m": method, "d": budget - lat}
        t = tracectx.wire_context()
        if t is not None:
            frame["t"] = t
        n = tenant_mod.wire_context()
        if n is not None:
            frame["n"] = n
        self.frames.append(frame)
        action = MC_DELIVER
        if self.mc_hook is not None:
            action = self.mc_hook(source, addr, method)
        if action == MC_DROP_REQUEST:
            # The frame never arrived: the caller waits out its budget and
            # the method never runs (a lost datagram / dead TCP dial).
            self.now += budget - lat
            raise RpcUnreachable(
                f"{addr}/{method}: request lost in transit (mc schedule)"
            )

        def dispatch() -> dict:
            try:
                return serve_with_deadline(
                    self.services[addr], method, payload, budget - lat,
                    clock=self.clock, trace=frame.get("t"), lane=addr,
                    tenant=frame.get("n"),
                )
            except RpcError:
                raise
            except Exception as e:
                # Fidelity with the TCP fabric: a crashed method arrives at
                # the caller as a remote RpcError (TcpRpcServer._serve_conn),
                # never as the raw exception on the caller's stack.
                raise RpcError(f"{type(e).__name__}: {e}") from e

        reply = dispatch()
        if action == MC_DUPLICATE:
            # At-least-once replay: the server executes the SAME frame again
            # (retried send after a timeout the caller never saw). Only legal
            # where the scenario consulted IDEMPOTENT_VERBS — the explorer
            # asserts that, not the fabric.
            reply = dispatch()
        if action == MC_DROP_REPLY:
            # The method ran — its effects stand — but the reply is lost, so
            # the caller sees the same verdict a reply-less timeout yields.
            self.now += budget - lat
            raise RpcUnreachable(
                f"{addr}/{method}: reply lost in transit (mc schedule)"
            )
        return reply


class SimRpcClient(Rpc):
    def __init__(self, network: SimRpcNetwork, source: str):
        self.network = network
        self.source = source

    def call(
        self,
        addr: str,
        method: str,
        payload: dict,
        timeout: float = 60.0,
        deadline=None,
    ) -> dict:
        return self.network._call_from(
            self.source, addr, method, payload, timeout=timeout, deadline=deadline
        )


# ---------------------------------------------------------------------------
# Real TCP fabric
# ---------------------------------------------------------------------------

_HDR = struct.Struct("!I")  # 4-byte big-endian frame length
MAX_FRAME = 1 << 30  # 1 GiB — model weights fit; corrupt headers don't OOM us


def _send_frame(
    sock: socket.socket,
    obj: dict,
    auth: FrameAuth | None = None,
    recipient: str | bytes | None = None,
) -> None:
    data = msgpack.packb(obj, use_bin_type=True)
    if auth is not None:
        if not recipient:
            raise RpcError("sealed frames require an explicit recipient")
        data = auth.seal(data, recipient=recipient)
    if len(data) > MAX_FRAME:
        raise RpcError(f"frame of {len(data)} bytes exceeds MAX_FRAME")
    sock.sendall(_HDR.pack(len(data)) + data)


def _recv_frame(
    sock: socket.socket, auth: FrameAuth | None = None
) -> tuple[dict, bytes | None]:
    """Returns ``(message, authenticated_sender_id)`` — the sender id is the
    reply's sealed destination; ``None`` when authentication is off."""
    hdr = _recv_exact(sock, _HDR.size)
    (length,) = _HDR.unpack(hdr)
    if length > MAX_FRAME:
        raise RpcUnreachable(f"frame header claims {length} bytes (> MAX_FRAME)")
    data = bytes(_recv_exact(sock, length))
    sender = None
    if auth is not None:
        data, sender = auth.open(data)  # AuthError -> caller drops the connection
    return msgpack.unpackb(data, raw=False), sender


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        read = sock.recv_into(view[got:], n - got)
        if not read:
            raise RpcUnreachable("connection closed mid-frame")
        got += read
    return buf


class TcpRpcServer:
    """Threaded TCP server hosting one method table.

    ``metrics`` (utils/metrics.Counters, optional) counts the
    ``deadline_exceeded`` verdicts this server hands out (budget ran out on
    arrival or during execution); sheds are counted by the admission gates
    that raise them. ``lane`` is the owning node's identity
    (utils/tracing.lane): spans recorded while serving attribute to it."""

    def __init__(
        self,
        host: str,
        port: int,
        methods: dict[str, Method],
        auth: FrameAuth | None = None,
        metrics=None,
        lane: str | None = None,
    ):
        self.methods = methods
        self.auth = auth
        self.metrics = metrics
        self.lane = lane
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(64)
        self.address = f"{host}:{self.sock.getsockname()[1]}"
        if auth is not None:
            # Clients seal requests for this server's address; frames
            # recorded in flight to any other endpoint are rejected here.
            auth.add_identity(self.address)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        self.sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _count(self, e: Exception) -> None:
        # Sheds are counted by the admission gates themselves (the same
        # Counters instance) — counting Overloaded here again would double
        # every shed. Deadline verdicts have no other server-side counter.
        if self.metrics is not None and isinstance(e, DeadlineExceeded):
            self.metrics.inc("deadline_exceeded")

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            try:
                while True:
                    req, peer = _recv_frame(conn, self.auth)
                    # Replies are sealed for the AUTHENTICATED requester id,
                    # so a recorded reply cannot be replayed to anyone else.
                    try:
                        reply = serve_with_deadline(
                            self.methods, req["m"], req["p"], req.get("d"),
                            clock=_now, trace=req.get("t"), lane=self.lane,
                            tenant=req.get("n"),
                        )
                        _send_frame(conn, {"ok": True, "r": reply}, self.auth, recipient=peer)
                    except Exception as e:  # method error -> remote RpcError
                        self._count(e)
                        err: dict = {"ok": False, "e": f"{type(e).__name__}: {e}"}
                        if isinstance(e, Overloaded):
                            if e.retry_after_s is not None:
                                err["retry_after"] = float(e.retry_after_s)
                            if e.tenant is not None:
                                err["tenant"] = str(e.tenant)
                            if e.quota is not None:
                                err["quota"] = str(e.quota)
                        _send_frame(conn, err, self.auth, recipient=peer)
            except (RpcUnreachable, OSError):
                return  # client went away
            except AuthError as e:
                # Unauthenticated frame: drop the connection WITHOUT an error
                # reply — an unkeyed caller gets silence, not an oracle. The
                # reason is logged server-side for the operator: a
                # wrong-recipient drop usually means the caller dialed an
                # alias (DNS name, 127.0.0.1) instead of the canonical
                # config.host address the frame must be sealed for.
                log.warning("closing connection after unauthenticated frame: %s", e)
                return
            except Exception:
                # Malformed frame (bad msgpack, missing keys): drop the
                # connection, never the server.
                log.warning("closing connection after malformed frame", exc_info=True)
                return

    def close(self) -> None:
        self._stop.set()
        self.sock.close()
        self._thread.join(timeout=1.0)


class TcpRpc(Rpc):
    """One connection per call. Control messages are small and infrequent
    (heartbeats ride UDP, tensor bytes ride ICI/PCIe), so connection reuse
    is not worth the failure-mode complexity here.

    With auth enabled, requests are sealed for the DIALED address, and the
    server only opens frames sealed for an address it registered — so keyed
    callers must dial members by their canonical ``config.host:port``
    strings (the ones membership gossips), not an alias ('localhost', a DNS
    name, a second NIC). Every in-tree caller gets addresses from
    membership/config, which satisfies this by construction.

    The call's budget is spent ONCE across the connect, send, and recv
    phases: each phase's socket timeout is the time *remaining* from a
    monotonic start, so a slow connect plus a slow reply can never stretch
    one call to ~2x the stated bound."""

    def __init__(self, auth: FrameAuth | None = None):
        self.auth = auth

    def call(
        self,
        addr: str,
        method: str,
        payload: dict,
        timeout: float = 60.0,
        deadline=None,
    ) -> dict:
        budget = deadline_mod.resolve_budget(timeout, deadline)
        if budget <= 0:
            raise DeadlineExceeded(f"{addr}/{method}: no budget remaining before dialing")
        host, _, port = addr.rpartition(":")
        start = _now()

        def remaining() -> float:
            return budget - (_now() - start)

        try:
            with socket.create_connection((host, int(port)), timeout=budget) as sock:
                left = remaining()
                if left <= 0:
                    raise RpcUnreachable(f"{addr}: connect consumed the whole budget")
                sock.settimeout(left)
                # The server's budget is what remains NOW, not the original
                # timeout — the connect phase already spent its share. The
                # trace context (if any span is open here) rides as `t`;
                # with tracing off no span binds one, so the frame carries
                # zero extra bytes.
                req: dict = {"m": method, "p": payload, "d": left}
                t = tracectx.wire_context()
                if t is not None:
                    req["t"] = t
                n = tenant_mod.wire_context()
                if n is not None:
                    req["n"] = n
                _send_frame(sock, req, self.auth, recipient=addr)
                left = remaining()
                if left <= 0:
                    raise RpcUnreachable(f"{addr}: budget exhausted before the reply")
                sock.settimeout(left)
                # Replies are authenticated too: a spoofed leader cannot feed
                # a keyed member forged directory state.
                reply, _ = _recv_frame(sock, self.auth)
        except RpcUnreachable:
            raise
        except AuthError as e:
            raise RpcUnreachable(f"{addr}: reply failed authentication: {e}") from e
        except (OSError, ValueError) as e:
            raise RpcUnreachable(f"{addr}: {e}") from e
        if not reply.get("ok"):
            raise remote_error(
                reply.get("e", "remote error"),
                retry_after_s=reply.get("retry_after"),
                tenant=reply.get("tenant"),
                quota=reply.get("quota"),
            )
        return reply["r"]
