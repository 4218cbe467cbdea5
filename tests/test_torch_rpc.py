"""The port's RPC fabric (cluster/rpc.py, cluster/auth.py) against the JAX
package's: a client of either package calls a server of the other over TCP
on localhost, sealed frames are the same bytes from both, and one seeded
scenario on the in-process simulator gives the same results in both.

Every server binds port 0 and is closed in ``finally``; every socket test
runs under the per-test time limit of ``torch_sockets``.
"""

import random
import socket
import threading
import time

import msgpack
import numpy as np
import pytest
from torch_sockets import socket_time_limit  # noqa: F401  (autouse fixture)

import dmlc_tpu.cluster.admission as jax_admission
import dmlc_tpu.cluster.auth as jax_auth
import dmlc_tpu.cluster.deadline as jax_deadline
import dmlc_tpu.cluster.retrypolicy as jax_retrypolicy
import dmlc_tpu.cluster.rpc as jax_rpc
import dmlc_tpu.cluster.tenant as jax_tenant
import dmlc_tpu.cluster.tracectx as jax_tracectx
import dmlc_tpu.scheduler.worker as jax_worker
import dmlc_tpu_torch.cluster.admission as port_admission
import dmlc_tpu_torch.cluster.auth as port_auth
import dmlc_tpu_torch.cluster.deadline as port_deadline
import dmlc_tpu_torch.cluster.retrypolicy as port_retrypolicy
import dmlc_tpu_torch.cluster.rpc as port_rpc
import dmlc_tpu_torch.cluster.tenant as port_tenant
import dmlc_tpu_torch.cluster.tracectx as port_tracectx
import dmlc_tpu_torch.scheduler.worker as port_worker

CALL_S = 10.0


class Pkg:
    """One package's fabric modules, by role."""

    def __init__(self, name, rpc, auth, tenant, tracectx, deadline, admission,
                 retrypolicy, worker):
        self.name, self.rpc, self.auth, self.tenant = name, rpc, auth, tenant
        self.tracectx, self.deadline, self.admission = tracectx, deadline, admission
        self.retrypolicy, self.worker = retrypolicy, worker

    def __repr__(self):
        return self.name


JAX = Pkg("jax", jax_rpc, jax_auth, jax_tenant, jax_tracectx, jax_deadline, jax_admission,
          jax_retrypolicy, jax_worker)
PORT = Pkg("port", port_rpc, port_auth, port_tenant, port_tracectx, port_deadline,
           port_admission, port_retrypolicy, port_worker)
#: (client package, server package): each direction across the packages.
DIRECTIONS = [pytest.param(JAX, PORT, id="jax_client-port_server"),
              pytest.param(PORT, JAX, id="port_client-jax_server")]


def probe_methods(srv: Pkg) -> dict:
    """Methods that answer with what the server sees of the call."""

    def probe(p):
        dl = srv.deadline.current()
        ctx = srv.tracectx.current()
        return {"remaining": None if dl is None else dl.remaining(),
                "trace": None if ctx is None else [ctx.trace_id, ctx.span_id, ctx.sampled],
                "tenant": srv.tenant.current(), "echo": p}

    def out_of_time(p):
        raise srv.rpc.DeadlineExceeded("inner hop ran out")

    def boom(p):
        raise ValueError("kapow")

    return {"probe": probe, "out_of_time": out_of_time, "boom": boom}


class Serving:
    """A TcpRpcServer of one package on 127.0.0.1, port 0, closed on exit."""

    def __init__(self, pkg: Pkg, methods: dict, auth=None):
        self.server = pkg.rpc.TcpRpcServer("127.0.0.1", 0, methods, auth=auth)

    def __enter__(self):
        return self.server.address

    def __exit__(self, *exc):
        self.server.close()


@pytest.mark.parametrize("cli,srv", DIRECTIONS)
def test_round_trip_across_packages(cli, srv):
    blob = bytes(range(256)) * 64
    with Serving(srv, probe_methods(srv)) as addr:
        reply = cli.rpc.TcpRpc().call(addr, "probe", {"k": "v", "blob": blob}, timeout=CALL_S)
    assert reply["echo"] == {"k": "v", "blob": blob}
    assert reply["trace"] is None and reply["tenant"] == "default"


@pytest.mark.parametrize("cli,srv", DIRECTIONS)
def test_unknown_method_and_method_error(cli, srv):
    with Serving(srv, probe_methods(srv)) as addr:
        rpc = cli.rpc.TcpRpc()
        with pytest.raises(cli.rpc.RpcError, match="unknown method 'nope'") as e:
            rpc.call(addr, "nope", {}, timeout=CALL_S)
        assert type(e.value) is cli.rpc.RpcError
        with pytest.raises(cli.rpc.RpcError, match="ValueError: kapow"):
            rpc.call(addr, "boom", {}, timeout=CALL_S)


@pytest.mark.parametrize("cli,srv", DIRECTIONS)
def test_deadline_exceeded_is_typed_across_packages(cli, srv):
    with Serving(srv, probe_methods(srv)) as addr:
        with pytest.raises(cli.rpc.DeadlineExceeded, match="deadline: inner hop ran out"):
            cli.rpc.TcpRpc().call(addr, "out_of_time", {}, timeout=CALL_S)


@pytest.mark.parametrize("cli,srv", DIRECTIONS)
def test_deadline_trace_and_tenant_reach_the_method(cli, srv):
    ctx = cli.tracectx.TraceContext(trace_id="ab" * 8, span_id="cd" * 8, sampled=False)
    with Serving(srv, probe_methods(srv)) as addr:
        rpc = cli.rpc.TcpRpc()
        with cli.tracectx.bind(ctx), cli.tenant.bind("acme"), \
                cli.deadline.bind(cli.deadline.Deadline(3.0)):
            got = rpc.call(addr, "probe", {}, timeout=CALL_S)
        plain = rpc.call(addr, "probe", {}, timeout=CALL_S)
    assert got["trace"] == ["ab" * 8, "cd" * 8, False]
    assert got["tenant"] == "acme"
    assert 0.0 < got["remaining"] <= 3.0  # the bound deadline caps the 10 s timeout
    assert plain["trace"] is None and plain["tenant"] == "default"
    assert 3.0 < plain["remaining"] <= CALL_S


def _constant_backend(synsets):
    return [7] * len(synsets)


@pytest.mark.parametrize("cli,srv", DIRECTIONS)
def test_overloaded_from_a_full_gate_keeps_its_verdict(cli, srv):
    """The server's PredictWorker admits through an AdmissionGate of two
    tokens where tenant acme may hold one: acme holding its one is refused
    over quota, and with the gate full an undeclared tenant is refused as
    gate_full; both refusals reach the client typed, with their fields."""
    gate = srv.admission.AdmissionGate(
        1, 1, name="predict", retry_after_s=0.75,
        tenants=srv.tenant.parse_tenants({"acme": {"share": 0.5}}))
    worker = srv.worker.PredictWorker({"m": _constant_backend}, gate=gate)
    req = {"model": "m", "synsets": ["a", "b"]}
    with Serving(srv, worker.methods()) as addr:
        rpc = cli.rpc.TcpRpc()
        assert rpc.call(addr, "job.predict", req, timeout=CALL_S) == {"predictions": [7, 7]}
        with srv.tenant.bind("acme"), gate.admit():
            with cli.tenant.bind("acme"), pytest.raises(cli.rpc.Overloaded) as over:
                rpc.call(addr, "job.predict", req, timeout=CALL_S)
            with srv.tenant.bind(None), gate.admit(), cli.tenant.bind("beta"), \
                    pytest.raises(cli.rpc.Overloaded) as full:
                rpc.call(addr, "job.predict", req, timeout=CALL_S)
        assert rpc.call(addr, "job.predict", req, timeout=CALL_S) == {"predictions": [7, 7]}
    assert (over.value.retry_after_s, over.value.tenant, over.value.quota) == \
        (0.75, "acme", "over_quota")
    assert (full.value.retry_after_s, full.value.tenant, full.value.quota) == \
        (0.75, "beta", "gate_full")
    assert cli.retrypolicy.is_overload_error(over.value)
    assert gate.summary()["sheds"] == 2 and gate.summary()["active"] == 0


@pytest.mark.parametrize("cli,srv", DIRECTIONS)
def test_decode_error_names_the_poison_blob(cli, srv):
    from PIL import Image
    import io

    buf = io.BytesIO()
    Image.fromarray(np.full((20, 30, 3), 90, np.uint8)).save(buf, format="JPEG")
    good = buf.getvalue()
    worker = srv.worker.PredictWorker({})
    with Serving(srv, worker.methods()) as addr:
        rpc = cli.rpc.TcpRpc()
        reply = rpc.call(addr, "job.decode", {"blobs": [good, good], "size": 16},
                         timeout=CALL_S)
        with pytest.raises(cli.rpc.DecodeError, match=r"1/3 blobs undecodable \(indices \[1\]\)"):
            rpc.call(addr, "job.decode", {"blobs": [good, b"not an image", good], "size": 16},
                     timeout=CALL_S)
    assert reply["n"] == 2 and len(reply["data"]) == 2 * 16 * 16 * 3
    assert not cli.retrypolicy.is_overload_error(cli.rpc.DecodeError("x"))


@pytest.mark.parametrize("cli,srv", DIRECTIONS)
def test_unreachable_peer(cli, srv):
    """A port nobody listens on, and a server of the other package after
    it closed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        closed = f"127.0.0.1:{s.getsockname()[1]}"
    with pytest.raises(cli.rpc.RpcUnreachable):
        cli.rpc.TcpRpc().call(closed, "probe", {}, timeout=2.0)
    with Serving(srv, probe_methods(srv)) as addr:
        assert cli.rpc.TcpRpc().call(addr, "probe", {}, timeout=CALL_S)["tenant"] == "default"
    with pytest.raises(cli.rpc.RpcUnreachable):
        cli.rpc.TcpRpc().call(addr, "probe", {}, timeout=2.0)
    assert cli.retrypolicy.is_overload_error(cli.rpc.RpcUnreachable("x"))


@pytest.mark.parametrize("cli,srv", DIRECTIONS)
def test_keyed_fabric_across_packages(cli, srv):
    """Keyed both ways: the call goes through; a wrong key, an unkeyed
    client and a keyed client of an unkeyed server each get silence."""
    with Serving(srv, probe_methods(srv), auth=srv.auth.FrameAuth("fleet")) as addr:
        rpc = cli.rpc.TcpRpc(auth=cli.auth.FrameAuth("fleet"))
        assert rpc.call(addr, "probe", {"x": 1}, timeout=CALL_S)["echo"] == {"x": 1}
        with pytest.raises(cli.rpc.RpcError, match="kapow"):
            rpc.call(addr, "boom", {}, timeout=CALL_S)
        with pytest.raises(cli.rpc.RpcUnreachable):
            cli.rpc.TcpRpc(auth=cli.auth.FrameAuth("other")).call(addr, "probe", {}, timeout=2.0)
        with pytest.raises(cli.rpc.RpcUnreachable):
            cli.rpc.TcpRpc().call(addr, "probe", {}, timeout=2.0)
        assert rpc.call(addr, "probe", {"x": 2}, timeout=CALL_S)["echo"] == {"x": 2}
    with Serving(srv, probe_methods(srv)) as addr:
        with pytest.raises(cli.rpc.RpcUnreachable):
            cli.rpc.TcpRpc(auth=cli.auth.FrameAuth("fleet")).call(addr, "probe", {}, timeout=2.0)


@pytest.mark.parametrize("cli,srv", DIRECTIONS)
def test_replayed_frame_is_dropped_across_packages(cli, srv):
    """The same sealed request sent twice: the server of the other package
    answers the first and drops the connection on the second."""
    with Serving(srv, probe_methods(srv), auth=srv.auth.FrameAuth("fleet")) as addr:
        auth = cli.auth.FrameAuth("fleet", sender="client-a")
        frame = auth.seal(msgpack.packb({"m": "probe", "p": {"n": 1}, "d": CALL_S},
                                        use_bin_type=True), recipient=addr)
        wire = cli.rpc._HDR.pack(len(frame)) + frame
        host, _, port = addr.rpartition(":")
        with socket.create_connection((host, int(port)), timeout=CALL_S) as s:
            s.sendall(wire)
            reply, sender = cli.rpc._recv_frame(s, auth)
        assert reply["ok"] and reply["r"]["echo"] == {"n": 1}
        with socket.create_connection((host, int(port)), timeout=CALL_S) as s:
            s.sendall(wire)
            with pytest.raises(cli.rpc.RpcUnreachable, match="closed"):
                cli.rpc._recv_frame(s, auth)


@pytest.mark.parametrize("a,b", [pytest.param(JAX, PORT, id="jax_seals"),
                                 pytest.param(PORT, JAX, id="port_seals")])
def test_frame_auth_opens_across_packages(a, b):
    clock = iter(range(10**18, 10**18 + 100))
    sealer = a.auth.FrameAuth("k", sender="s:1", now_ns=lambda: next(clock))
    opener = b.auth.FrameAuth("k", sender="r:2", now_ns=lambda: 10**18)
    opener.add_identity("r:9")
    frame = sealer.seal(b"payload", recipient="r:9")
    assert opener.open(frame) == (b"payload", b"s:1")
    with pytest.raises(b.auth.AuthError, match="replayed frame"):
        opener.open(frame)
    with pytest.raises(b.auth.AuthError, match="bad frame tag"):
        b.auth.FrameAuth("other").open(frame)
    with pytest.raises(b.auth.AuthError, match="different recipient"):
        b.auth.FrameAuth("k", now_ns=lambda: 10**18).open(sealer.seal(b"x", recipient="r:9"))
    stale = a.auth.FrameAuth("k", sender="s:3", now_ns=lambda: 1).seal(b"x", recipient="r:9")
    with pytest.raises(b.auth.AuthError, match="stale frame"):
        opener.open(stale)


def _fixed_auth(pkg, key="fleet"):
    clock = iter(range(1_700_000_000_000_000_000, 1_700_000_000_000_000_100))
    return pkg.auth.FrameAuth(key, sender="10.0.0.1:8851", now_ns=lambda: next(clock))


def _frame_bytes(pkg, obj, auth=None, recipient=None) -> bytes:
    a, b = socket.socketpair()
    try:
        pkg.rpc._send_frame(a, obj, auth, recipient=recipient)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while chunk := b.recv(1 << 16):
            chunks.append(chunk)
        return b"".join(chunks)
    finally:
        a.close()
        b.close()


def test_sealed_frames_are_byte_identical():
    payload = msgpack.packb({"m": "job.predict", "p": {"synsets": ["n01"]}, "d": 1.5},
                            use_bin_type=True)
    sealed = [_fixed_auth(p).seal(payload, recipient="10.0.0.2:8851") for p in (JAX, PORT)]
    assert sealed[0] == sealed[1]
    req = {"m": "job.predict", "p": {"model": "resnet18", "synsets": ["n01", "n02"],
                                     "blob": b"\x00\xff" * 40}, "d": 2.25,
           "t": ["ab" * 8, "cd" * 8, 1], "n": "acme"}
    plain = [_frame_bytes(p, req) for p in (JAX, PORT)]
    assert plain[0] == plain[1] and len(plain[0]) > 4
    keyed = [_frame_bytes(p, req, _fixed_auth(p), "10.0.0.2:8851") for p in (JAX, PORT)]
    assert keyed[0] == keyed[1] and keyed[0] != plain[0]


def sim_scenario(pkg: Pkg, seed: int = 11) -> tuple:
    """A seeded run of crashes, partitions, heals, latencies and calls on
    one package's SimRpcNetwork; every call's outcome, the virtual clock
    after it, and the fabric's call and frame logs."""
    R = pkg.rpc
    net = R.SimRpcNetwork()
    nodes = ["a", "b", "c", "d"]
    for name in nodes:
        net.serve(name, {
            "echo": lambda p, name=name: {"at": name, "x": p["x"],
                                          "tenant": pkg.tenant.current()},
            "boom": lambda p: 1 // 0,
            "late": lambda p: (net.advance(p["s"]), {"ok": True})[1],
        })
    rng = random.Random(seed)
    out = []
    for step in range(400):
        op = rng.random()
        x, y = rng.sample(nodes, 2)
        if op < 0.06:
            net.crash(x)
        elif op < 0.14:
            net.restart(x)
        elif op < 0.2:
            net.partition(x, y)
        elif op < 0.3:
            net.heal(x, y)
        elif op < 0.4:
            net.set_latency(x, y, rng.choice([0.0, 0.05, 0.4, 3.0]))
        else:
            method = rng.choice(["echo", "echo", "boom", "late", "nope"])
            payload = {"x": step, "s": rng.choice([0.1, 2.5])}
            timeout = rng.choice([1.0, 2.0, 5.0])
            tenant = rng.choice([None, "acme"])
            try:
                with pkg.tenant.bind(tenant):
                    reply = net.client(x).call(y, method, payload, timeout=timeout)
                out.append(("ok", reply))
            except R.RpcError as e:
                out.append((type(e).__name__, str(e)))
        out.append(net.now)
    return out, net.calls, net.frames


def test_sim_fabric_scenario_is_the_same_in_both_packages():
    got, want = sim_scenario(PORT), sim_scenario(JAX)
    assert got == want
    kinds = {o[0] for o in got[0] if isinstance(o, tuple)}
    assert {"ok", "RpcError", "RpcUnreachable", "DeadlineExceeded"} <= kinds


def test_port_client_survives_a_slow_server_thread():
    """Concurrent callers of one port server: each gets its own answer."""
    methods = {"sq": lambda p: (time.sleep(0.01), {"y": p["x"] ** 2})[1]}
    results, errors = {}, []
    with Serving(PORT, methods) as addr:
        rpc = port_rpc.TcpRpc()

        def run(i):
            try:
                results[i] = rpc.call(addr, "sq", {"x": i}, timeout=CALL_S)["y"]
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=CALL_S)
    assert not any(t.is_alive() for t in threads) and not errors
    assert results == {i: i * i for i in range(16)}
