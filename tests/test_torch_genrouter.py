"""Every case of tests/test_genrouter.py, run against both packages (the
``pkg`` fixture): position-seeded resume and router-driven migration on
each package's own engines (the port's on the CPU, loaded with the JAX
package's lm_small variables), the session router on toy decoders
(gauge-driven placement, tenant sheds, member amnesia, cancel, TTL sweep,
session-lost verdicts), drain as first-class state with the autoscaler's
held shrink, standby readoption of the ledger, the kill-mid-stream soak and
its certificate, and the CLI's sessions/drain/status/undrain on each
package's own one-node localcluster.

The names imported below are the JAX package's; ``sided`` rebinds each to
the object of the same name in the package under test, for each case, and
``on_cpu`` builds the port's engines on the CPU.
"""

import functools
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_sides import JAX, bind_sides, pkg  # noqa: F401  (pkg: fixture)

from dmlc_tpu.cluster import tenant as tenant_mod
from dmlc_tpu.cluster.flight import FlightRecorder
from dmlc_tpu.cluster.rpc import (
    Overloaded,
    RpcError,
    SimRpcNetwork,
)
from dmlc_tpu.generate.engine import GenerationEngine
from dmlc_tpu.generate.slots import GenStream
from dmlc_tpu.generate.worker import (
    GenerateWorker,
    GenerationBackend,
)
from dmlc_tpu.loadgen import (
    ISOLATION_TENANTS,
    _session_plan,
    session_churn_harness,
    validate_sessions,
)
from dmlc_tpu.models.registry import get_model
from dmlc_tpu.scheduler.autoscaler import Autoscaler, ScaleTarget
from dmlc_tpu.scheduler.genrouter import GenRouter
from dmlc_tpu.utils.metrics import Counters
from tools.slo_cert import session_failures

sided = bind_sides(globals(), {
    "FlightRecorder": "flight", "Overloaded": "rpc", "RpcError": "rpc",
    "SimRpcNetwork": "rpc", "GenStream": "slots", "GenerateWorker": "genworker",
    "GenerationBackend": "genworker", "ISOLATION_TENANTS": "loadgen",
    "_session_plan": "loadgen", "session_churn_harness": "loadgen",
    "validate_sessions": "loadgen", "Autoscaler": "autoscaler", "ScaleTarget": "autoscaler",
    "GenRouter": "genrouter", "Counters": "metrics",
})


@pytest.fixture(autouse=True)
def on_cpu(sided, pkg, monkeypatch):
    """``tenant_mod`` is the package's tenant module, and the port's
    engines are built on the CPU (the card is not here)."""
    monkeypatch.setitem(globals(), "tenant_mod", pkg.tenant)
    if pkg.name == "port":
        from dmlc_tpu_torch.generate import engine as port_engine

        monkeypatch.setitem(globals(), "GenerationEngine",
                            functools.partial(port_engine.GenerationEngine, device="cpu"))
        monkeypatch.setitem(globals(), "GenerationBackend",
                            functools.partial(pkg.genworker.GenerationBackend, device="cpu"))


SEED_BASE = int(os.environ.get("DMLC_CHAOS_SEED", "0"))
SPEC = get_model("lm_small")
VOCAB = SPEC.num_outputs


@pytest.fixture(scope="module")
def variables():
    _, v = SPEC.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    return v


def make_engine(variables, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("num_pages", 128)
    kw.setdefault("max_prefill", 32)
    return GenerationEngine("lm_small", variables=variables, **kw)


def reference_sampled(variables, prompt, n_new, seed, temperature=0.8):
    """Isolated single-slot run: THE unkilled reference for a seeded
    sampled stream."""
    eng = make_engine(variables, max_slots=1)
    toks = [eng.join(0, np.asarray(prompt, np.int32),
                     temperature=temperature, seed=seed)]
    for _ in range(n_new - 1):
        eng.ensure_capacity(0)
        toks.append(int(eng.step()[0]))
    return toks


# ---------------------------------------------------------------------------
# Toy decoder: step-driven, resume-capable, thread-safe
# ---------------------------------------------------------------------------


class ToyDecoder:
    """Deterministic GenerationBackend stand-in whose plan is a pure
    function of (prompt, seed, position) — the engine's position-seeded
    contract — with the resume-from-prefix entry and an explicit
    ``step()`` so tests control exactly when tokens appear."""

    def __init__(self, member: str, prefills: dict[str, int],
                 prefill_lock: threading.Lock):
        self.member = member
        self.prefills = prefills
        self.prefill_lock = prefill_lock
        self._lock = threading.Lock()
        self.live: list[tuple[GenStream, list[int]]] = []

    def submit(self, prompt, *, max_new_tokens, temperature=0.0,
               eos_id=None, request_id="", seed=None, resume_tokens=None):
        stream = GenStream(request_id)
        done = [int(t) for t in resume_tokens] if resume_tokens else []
        full = _session_plan(list(prompt), seed or 0,
                             len(done) + int(max_new_tokens))
        with self.prefill_lock:
            self.prefills[request_id] = self.prefills.get(request_id, 0) + 1
        with self._lock:
            self.live.append((stream, full[len(done):]))
        return stream

    def step(self, n: int = 1) -> None:
        with self._lock:
            live = list(self.live)
        for stream, remaining in live:
            if stream.done or stream.cancelled:
                continue
            for _ in range(n):
                if remaining:
                    stream.push([remaining.pop(0)])
            if not remaining:
                stream.finish()


class World:
    """N toy members + one leading router on the sim fabric."""

    def __init__(self, n_members: int, *, tenants=None, **router_kw):
        self.net = SimRpcNetwork()
        self.alive = {f"m{i}" for i in range(n_members)}
        self.prefills: dict[str, int] = {}
        self._plock = threading.Lock()
        self.decoders: dict[str, ToyDecoder] = {}
        self.workers: dict[str, GenerateWorker] = {}
        for m in sorted(self.alive):
            self.decoders[m] = ToyDecoder(m, self.prefills, self._plock)
            self.workers[m] = GenerateWorker(
                {"toy": self.decoders[m]}, session_ttl_s=1e9,
            )
            self.net.serve(m, self.workers[m].methods())
        self.metrics = Counters()
        self.flight = FlightRecorder(node="L")
        router_kw.setdefault("session_ttl_s", 1e9)
        router_kw.setdefault("timeout_s", 5.0)
        self.router = GenRouter(
            self.net.client("L"), lambda: sorted(self.alive),
            tenants=tenants, metrics=self.metrics, flight=self.flight,
            **router_kw,
        )
        self.router.is_leading = True
        self.router.epoch = [1, "L"]
        self.net.serve("L", self.router.methods())

    def submit(self, cid, prompt, seed, tokens, tenant=""):
        with tenant_mod.bind(tenant or tenant_mod.DEFAULT_TENANT):
            return self.net.client(cid).call("L", "job.generate", {
                "model": "toy", "prompt": prompt,
                "max_new_tokens": tokens, "seed": seed,
            })["gen_id"]

    def crash(self, member):
        self.alive.discard(member)
        self.net.crash(member)

    def session(self, sid):
        return next(s for s in self.router.sessions_table()
                    if s["id"] == sid)

    def drain_chunks(self, cid, sid, acked=0, consumed=None):
        """One poll: fold new chunks, return (reply, acked, consumed)."""
        consumed = consumed if consumed is not None else []
        r = self.net.client(cid).call(
            "L", "job.generate_poll", {"gen_id": sid, "ack": acked},
        )
        for seq, toks in sorted(r.get("chunks", [])):
            if seq <= acked:
                continue
            acked = seq
            consumed.extend(int(t) for t in toks)
        return r, acked, consumed

    def run_to_completion(self, cid, sid, max_rounds=200):
        acked, consumed = 0, []
        for _ in range(max_rounds):
            for m in sorted(self.alive):
                self.decoders[m].step()
            self.router.tick()
            r, acked, consumed = self.drain_chunks(cid, sid, acked, consumed)
            if r.get("done") and not r.get("chunks"):
                return consumed, r.get("error")
        raise AssertionError(f"session {sid} never completed")


# ---------------------------------------------------------------------------
# Real engine: seeded sampling + resume + migration token identity
# ---------------------------------------------------------------------------


class TestSeededResume:
    def _backend(self, variables):
        backend = GenerationBackend(
            "lm_small", max_slots=4, page_size=8, num_pages=128,
            max_prefill=32, max_waiting=64,
        )
        backend.warmup()
        backend.load_variables(variables)
        return backend

    def test_resume_from_prefix_is_token_identical(self, variables):
        """Prefilling prompt+delivered with the same seed continues the
        sampled sequence exactly where it left off — the migration
        contract, straight on the engine's RNG."""
        prompt, seed, n = [3, 1, 4, 1, 5], 1234 + SEED_BASE, 8
        ref = reference_sampled(variables, prompt, n, seed)
        backend = self._backend(variables)
        try:
            cut = 3
            stream = backend.submit(
                prompt, max_new_tokens=n - cut, temperature=0.8,
                request_id="resume", seed=seed, resume_tokens=ref[:cut],
            )
            assert stream.result(timeout=120) == ref[cut:]
        finally:
            backend.stop()

    def test_migration_is_token_identical_on_real_engines(self, variables):
        """A sampled stream routed to a real member, crashed mid-decode,
        and migrated by the router ends token-identical to the unkilled
        single-slot reference — the tentpole, end to end on the real
        RNG."""
        prompt, seed, n = [2, 7, 1], 99 + SEED_BASE, 8
        ref = reference_sampled(variables, prompt, n, seed)
        net = SimRpcNetwork()
        alive = {"m0", "m1"}
        backends = {}
        for m in sorted(alive):
            backends[m] = self._backend(variables)
            net.serve(m, GenerateWorker(
                {"lm_small": backends[m]}, session_ttl_s=1e9,
            ).methods())
        router = GenRouter(net.client("L"), lambda: sorted(alive),
                           session_ttl_s=1e9, timeout_s=30.0)
        router.is_leading = True
        router.epoch = [1, "L"]
        net.serve("L", router.methods())
        try:
            sid = net.client("c").call("L", "job.generate", {
                "model": "lm_small", "prompt": prompt,
                "max_new_tokens": n, "temperature": 0.8, "seed": seed,
            })["gen_id"]
            placed = next(s["member"] for s in router.sessions_table()
                          if s["id"] == sid)
            acked, consumed = 0, []
            deadline = time.monotonic() + 60
            while len(consumed) < 2 and time.monotonic() < deadline:
                r = net.client("c").call(
                    "L", "job.generate_poll", {"gen_id": sid, "ack": acked},
                )
                for seq, toks in sorted(r.get("chunks", [])):
                    if seq <= acked:
                        continue
                    acked = seq
                    consumed.extend(int(t) for t in toks)
                time.sleep(0.01)
            assert len(consumed) >= 2, "no tokens before the crash"
            alive.discard(placed)
            net.crash(placed)
            router.tick()
            s = next(s for s in router.sessions_table() if s["id"] == sid)
            assert s["migrations"] == 1 and s["member"] != placed
            while time.monotonic() < deadline:
                r = net.client("c").call(
                    "L", "job.generate_poll", {"gen_id": sid, "ack": acked},
                )
                for seq, toks in sorted(r.get("chunks", [])):
                    if seq <= acked:
                        continue
                    acked = seq
                    consumed.extend(int(t) for t in toks)
                if r.get("done") and not r.get("chunks"):
                    assert not r.get("error"), r
                    break
                time.sleep(0.01)
            assert consumed == ref, (consumed, ref)
        finally:
            for b in backends.values():
                b.stop()


# ---------------------------------------------------------------------------
# Router unit behavior (toy decoders)
# ---------------------------------------------------------------------------


class TestRouterUnit:
    def test_routes_least_loaded_by_gauges(self):
        gauges = {
            "m0": {"generate-toy_slots_active": 6.0, "mfu_toy": 0.5},
            "m1": {"generate-toy_slots_active": 1.0, "mfu_toy": 0.1,
                   "generate-toy_pages_free": 100.0},
            "m2": {"generate-toy_slots_active": 3.0, "mfu_toy": None},
        }
        w = World(3, metrics_for=lambda m: gauges[m])
        sid = w.submit("c0", [1], 5, 3)
        assert w.session(sid)["member"] == "m1"
        assert w.metrics.get("gen_sessions_routed") == 1
        assert any(e["kind"] == "route" for e in w.flight.events())

    def test_residency_corrects_scrape_lag(self):
        # No gauges at all: placement spreads by the ledger's own counts.
        w = World(3)
        members = {w.session(w.submit(f"c{i}", [i + 1], i, 2))["member"]
                   for i in range(3)}
        assert members == {"m0", "m1", "m2"}

    def test_tenant_quota_sheds_typed_over_quota(self):
        tenants = tenant_mod.parse_tenants(ISOLATION_TENANTS)
        w = World(2, tenants=tenants, max_sessions=4)  # acme share 0.5 -> 2
        w.submit("c0", [1], 0, 2, tenant="acme")
        w.submit("c1", [2], 0, 2, tenant="acme")
        with pytest.raises(Overloaded, match="at quota") as exc:
            w.submit("c2", [3], 0, 2, tenant="acme")
        assert exc.value.quota == "over_quota"
        assert w.metrics.get("shed_genroute") == 1
        # The default tenant's headroom is untouched by acme's refusal.
        w.submit("c3", [4], 0, 2)

    def test_gate_full_sheds_typed(self):
        w = World(2, max_sessions=1)
        w.submit("c0", [1], 0, 2)
        with pytest.raises(Overloaded, match="ledger full") as exc:
            w.submit("c1", [2], 0, 2)
        assert exc.value.quota == "gate_full"

    def test_submit_is_idempotent_by_gen_id(self):
        w = World(2)
        sid = w.submit("c0", [1], 0, 3)
        reply = w.net.client("c0").call("L", "job.generate", {
            "model": "toy", "prompt": [1], "max_new_tokens": 3,
            "gen_id": sid, "seed": 0,
        })
        assert reply["resumed"] and reply["gen_id"] == sid
        assert w.prefills[sid] == 1

    def test_cancel_retires_ledger_and_member(self):
        tenants = tenant_mod.parse_tenants(ISOLATION_TENANTS)
        w = World(2, tenants=tenants)
        sid = w.submit("c0", [1], 0, 5, tenant="acme")
        assert w.router.ledger.active("acme") == 1
        r = w.net.client("c0").call("L", "job.generate_cancel",
                                    {"gen_id": sid})
        assert r["cancelled"]
        assert w.router.ledger.active("acme") == 0
        with pytest.raises(RpcError, match="unknown generation"):
            w.net.client("c0").call("L", "job.generate_poll",
                                    {"gen_id": sid, "ack": 0})

    def test_member_amnesia_triggers_immediate_migration(self):
        w = World(2)
        sid = w.submit("c0", [1], 7, 4)
        placed = w.session(sid)["member"]
        # The member restarts: fresh worker, empty session table, same
        # address. The next proxied poll hits "unknown generation".
        w.net.serve(placed, GenerateWorker(
            {"toy": ToyDecoder(placed, w.prefills, w._plock)},
            session_ttl_s=1e9,
        ).methods())
        w.drain_chunks("c0", sid)
        s = w.session(sid)
        assert s["migrations"] == 1 and s["member"] != placed
        consumed, err = w.run_to_completion("c0", sid)
        assert err is None and consumed == _session_plan([1], 7, 4)

    def test_session_lost_without_survivor_is_a_typed_verdict(self):
        w = World(1)
        sid = w.submit("c0", [1], 0, 4)
        w.crash("m0")
        w.router.tick()
        r, _, _ = w.drain_chunks("c0", sid)
        assert r["done"] and "session lost" in (r.get("error") or "")
        assert w.metrics.get("gen_sessions_lost") == 1
        assert any(e["kind"] == "session_lost" for e in w.flight.events())

    def test_ttl_sweeps_abandoned_sessions(self):
        now = [0.0]
        w = World(1, session_ttl_s=10.0, clock=lambda: now[0])
        sid = w.submit("c0", [1], 0, 4)
        now[0] = 11.0
        w.router.tick()
        with pytest.raises(RpcError, match="unknown generation"):
            w.net.client("c0").call("L", "job.generate_poll",
                                    {"gen_id": sid, "ack": 0})


class TestDrain:
    def test_drain_stops_admission_and_migrates_at_deadline(self):
        now = [0.0]
        w = World(2, drain_deadline_s=5.0, clock=lambda: now[0])
        sid = w.submit("c0", [1], 3, 6)
        placed = w.session(sid)["member"]
        other = ({"m0", "m1"} - {placed}).pop()
        r = w.router.drain(placed)
        assert r["resident"] == 1 and r["deadline_s"] == 5.0
        assert w.router.drain_active() == 1
        # Admission stops instantly: new sessions land elsewhere.
        sid2 = w.submit("c1", [2], 4, 2)
        assert w.session(sid2)["member"] == other
        # Before the deadline residents stay put...
        w.router.tick()
        assert w.session(sid)["member"] == placed
        # ...at the deadline they migrate, and the drain completes.
        now[0] = 5.0
        w.router.tick()
        s = w.session(sid)
        assert s["member"] == other and s["migrations"] == 1
        assert w.router.draining()[placed]["complete"]
        assert w.router.drain_active() == 0
        kinds = [e["kind"] for e in w.flight.events()]
        assert "drain_start" in kinds and "drain_complete" in kinds
        # The drained stream still finishes exactly-once.
        consumed, err = w.run_to_completion("c0", sid)
        assert err is None and consumed == _session_plan([1], 3, 6)
        # Undrain reopens admission.
        assert w.router.undrain(placed)["was"]
        assert placed not in w.router.draining()

    def test_redrain_tightens_never_extends(self):
        now = [0.0]
        w = World(1, clock=lambda: now[0])
        w.router.drain("m0", deadline_s=30.0)
        w.router.drain("m0", deadline_s=5.0)
        assert w.router.draining()["m0"]["deadline_s"] == 5.0
        w.router.drain("m0", deadline_s=60.0)
        assert w.router.draining()["m0"]["deadline_s"] == 5.0

    def test_autoscaler_shrink_holds_until_drained(self):
        """The replicas target's scale-down goes through the drain door:
        hold (visible, reasoned) while two members host live sessions,
        apply once release_capacity finds the excess member clear."""
        w = World(2, drain_deadline_s=0.0)
        # Residency spread places one stream per member: shrinking to 1
        # would abandon a live stream, so the drain hook must refuse.
        sid_a = w.submit("c0", [1], 2, 3)
        sid_b = w.submit("c1", [2], 4, 3)
        assert w.session(sid_a)["member"] != w.session(sid_b)["member"]
        cur = {"v": 2}
        applied = []
        auto = Autoscaler(clock=lambda: 0.0, clear_windows=1)
        auto.register(ScaleTarget(
            "replicas-toy", get=lambda: cur["v"],
            apply=lambda v: applied.append(v) or cur.update(v=v) or v,
            lo=1, models=["toy"],
            drain=lambda keep: w.router.release_capacity("toy", keep),
        ))
        decisions = auto.tick([])  # quiet window: shrink wants 2 -> 1
        assert [d["direction"] for d in decisions] == ["hold"]
        assert decisions[0]["reason"] == "draining"
        assert cur["v"] == 2 and not applied
        # release_capacity initiated a drain on the lightest member.
        assert w.router.drain_active() == 1
        # Deadline 0: the resident migrates on the next tick, the drained
        # member empties, and the held shrink finally lands.
        for sid, cid in ((sid_a, "c0"), (sid_b, "c1")):
            consumed, err = w.run_to_completion(cid, sid)
            assert err is None
        decisions = auto.tick([])
        assert [d["direction"] for d in decisions] == ["down"]
        assert cur["v"] == 1 and applied == [1]


# ---------------------------------------------------------------------------
# Leader failover: ledger adoption
# ---------------------------------------------------------------------------


class TestFailoverReadoption:
    def _standby(self, w):
        standby = GenRouter(w.net.client("L1"), lambda: sorted(w.alive),
                            session_ttl_s=1e9, timeout_s=5.0)
        w.net.serve("L1", standby.methods())
        return standby

    def test_adopt_is_idempotent_and_never_rewinds(self):
        w = World(2)
        sid = w.submit("c0", [1], 5, 6)
        w.decoders[w.session(sid)["member"]].step(3)
        _, acked, consumed = w.drain_chunks("c0", sid)
        assert len(consumed) == 3
        standby = self._standby(w)
        wire = w.router.to_wire()
        assert standby.adopt_state(wire) == 1
        assert standby.adopt_state(wire) == 0  # re-adopt: no new sessions
        # A STALE wire (shorter delivered) must never rewind the ledger.
        stale = w.router.to_wire()
        stale["sessions"][sid]["delivered"] = consumed[:1]
        standby.adopt_state(stale)
        assert standby._sessions[sid].delivered == consumed

    def test_failover_mid_migration_single_prefill(self):
        """Crash the placed member, fail the leader over BEFORE its tick
        migrates, and let the promoted standby drive the migration: the
        stream completes exactly-once with precisely 1 + kills prefills
        and no duplicate adoption."""
        w = World(2)
        sid = w.submit("c0", [1], 9, 5)
        placed = w.session(sid)["member"]
        w.decoders[placed].step(2)
        _, acked, consumed = w.drain_chunks("c0", sid)
        w.crash(placed)
        standby = self._standby(w)
        wire = w.router.to_wire()
        standby.adopt_state(wire)
        standby.adopt_state(wire)
        w.router.is_leading = False
        standby.is_leading = True
        standby.epoch = [2, "L1"]
        assert standby.readopt() == 1
        standby.tick()
        s = next(s for s in standby.sessions_table() if s["id"] == sid)
        assert s["migrations"] == 1 and s["member"] != placed
        # Drive the survivor to completion through the NEW leader.
        for _ in range(50):
            for m in sorted(w.alive):
                w.decoders[m].step()
            standby.tick()
            r = w.net.client("c0").call(
                "L1", "job.generate_poll", {"gen_id": sid, "ack": acked},
            )
            for seq, toks in sorted(r.get("chunks", [])):
                if seq <= acked:
                    continue
                acked = seq
                consumed.extend(int(t) for t in toks)
            if r.get("done") and not r.get("chunks"):
                break
        assert consumed == _session_plan([1], 9, 5)
        assert w.prefills[sid] == 2  # 1 original + 1 kill, never more


# ---------------------------------------------------------------------------
# The seeded kill-mid-stream soak + certificate
# ---------------------------------------------------------------------------


class TestChurnSoak:
    def test_concurrent_soak_16_streams_2_kills_1_drain(self):
        """Truly concurrent: 16 client threads stream against the router
        while a stepper thread decodes and ticks; two members die
        mid-decode and one drains. Every stream must reassemble its exact
        plan (token-identical to the unkilled reference, exactly-once)
        and every migration costs exactly one prefill."""
        rng = np.random.default_rng(500 + SEED_BASE)
        w = World(4, drain_deadline_s=0.0, max_sessions=64)
        plans, sids = {}, {}
        for i in range(16):
            prompt = [int(rng.integers(1, 50))]
            seed = int(rng.integers(0, 1000))
            tokens = int(rng.integers(6, 14))
            plans[i] = _session_plan(prompt, seed, tokens)
            sids[i] = w.submit(f"c{i}", prompt, seed, tokens,
                               tenant="acme" if i % 2 else "")
        results, errors = {}, {}
        stop = threading.Event()

        def stepper():
            while not stop.is_set():
                for m in sorted(set(w.alive)):
                    w.decoders[m].step()
                w.router.tick()
                time.sleep(0.002)

        def client(i):
            acked, consumed = 0, []
            try:
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    r, acked, consumed = w.drain_chunks(
                        f"c{i}", sids[i], acked, consumed)
                    if r.get("done") and not r.get("chunks"):
                        assert not r.get("error"), r
                        break
                    time.sleep(0.003)
                results[i] = consumed
            except Exception as e:  # collected and asserted below
                errors[i] = e

        threads = [threading.Thread(target=stepper)]
        threads += [threading.Thread(target=client, args=(i,))
                    for i in range(16)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.05)
            victims = [str(v) for v in
                       rng.choice(sorted(w.alive), size=3, replace=False)]
            w.crash(victims[0])
            time.sleep(0.05)
            w.crash(victims[1])
            time.sleep(0.02)
            w.router.drain(victims[2], reason="soak")
            for t in threads[1:]:
                t.join(timeout=90)
        finally:
            stop.set()
            threads[0].join(timeout=10)
        assert not errors, errors
        assert results == plans  # exactly-once, token-identical, all 16
        migrations = {s["id"]: s["migrations"]
                      for s in w.router.sessions_table()}
        for i in range(16):
            # One prefill per migration, never a re-driven duplicate.
            assert w.prefills[sids[i]] == 1 + migrations[sids[i]]
        assert w.metrics.get("gen_migrations") == sum(migrations.values())
        # The drained member's drain completed and dropped nothing (one
        # more tick: the last stream may have folded after the stepper's
        # final pass).
        w.router.tick()
        assert w.router.draining()[victims[2]]["complete"]

    def test_session_churn_certificate_is_clean(self):
        """The pinned loadgen scenario (one definition, three consumers:
        here, tools/slo_cert.py --sessions, and ci_check's chaos legs)."""
        doc = session_churn_harness(4, 300 + SEED_BASE).run()
        assert validate_sessions(doc) == []
        assert session_failures(doc) == []
        s = doc["sessions"]
        assert s["certified"]
        assert (s["streams"], s["kills"], s["drains"]) == (16, 2, 1)
        assert s["completed"] == 16 and s["lost"] == 0
        assert s["duplicated"] == 0 and s["drain_lost"] == 0
        assert s["migrations"] <= s["migration_budget"]
        assert set(s["tenants"]) == {"acme", tenant_mod.DEFAULT_TENANT}

    def test_validate_sessions_rejects_tampered_docs(self):
        doc = session_churn_harness(4, SEED_BASE).run()
        assert validate_sessions({}) == []  # section is optional
        bad = {**doc, "sessions": {**doc["sessions"], "lost": "zero"}}
        assert any("wrong type" in p for p in validate_sessions(bad))
        bad = {**doc, "sessions": {**doc["sessions"], "completed": 3}}
        assert any("completed + lost" in p for p in validate_sessions(bad))
        tenants = {k: dict(v) for k, v in doc["sessions"]["tenants"].items()}
        tenants["acme"]["migrations"] += 1
        bad = {**doc, "sessions": {**doc["sessions"], "tenants": tenants}}
        assert any("tenant migrations" in p for p in validate_sessions(bad))
        lost = [f for f in session_failures(
            {**doc, "sessions": {**doc["sessions"], "lost": 2,
                                 "completed": 14}})]
        assert lost


# ---------------------------------------------------------------------------
# Localcluster: the CLI surface end to end
# ---------------------------------------------------------------------------


class TestLocalclusterCli:
    def test_sessions_drain_status_undrain(self, tmp_path, pkg):
        Cli = pkg.cli.Cli
        start_local_cluster = pkg.localcluster.start_local_cluster
        stop_local_cluster = pkg.localcluster.stop_local_cluster
        wait_until = pkg.localcluster.wait_until
        on = {"device": "cpu"} if pkg.name == "port" else {}

        nodes = start_local_cluster(
            tmp_path, 1, **on,
            n_leader_candidates=1,
            generate_models=["lm_small"],
            gen_page_size=8,
            gen_num_pages=64,
            gen_max_prefill=16,
            eager_load=False,
        )
        try:
            node = nodes[0]
            wait_until(lambda: node.genrouter is not None
                       and node.genrouter.is_leading,
                       msg="router promotion")
            cli = Cli(node)
            out = cli.run_command("generate lm_small 1 2 3 --max-new 4 --seed 5")
            assert "(router)" in out and "4 token(s)" in out
            # The ledger keeps the completed session until TTL.
            out = cli.run_command("sessions")
            assert "lm_small" in out and "done" in out
            member = node.self_member_addr
            out = cli.run_command(f"drain {member} --deadline 9")
            assert f"draining {member}" in out and "9.0s" in out
            out = cli.run_command("status")
            assert f"drain {member}: " in out and "reason operator" in out
            # Admission is refused with every member draining.
            with pytest.raises(RpcError, match="no eligible member"):
                node.generate("lm_small", [4], max_new_tokens=2)
            out = cli.run_command(f"undrain {member}")
            assert "admission reopened" in out
            reply = node.generate("lm_small", [4], max_new_tokens=2)
            assert reply["routed"] and len(reply["tokens"]) == 2
        finally:
            stop_local_cluster(nodes)
