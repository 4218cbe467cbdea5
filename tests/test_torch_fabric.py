"""The port's fabric policies against the JAX package's, on the same inputs:
RetryPolicy and AdmissionGate on a fake clock, the metrics Registry and its
Prometheus text, ClusterConfig loaded from JSON, and the ring neighbours."""

import dataclasses
import json
import random
from contextlib import ExitStack

import pytest

import dmlc_tpu.cluster.admission as jax_admission
import dmlc_tpu.cluster.retrypolicy as jax_retrypolicy
import dmlc_tpu.cluster.rpc as jax_rpc
import dmlc_tpu.cluster.tenant as jax_tenant
import dmlc_tpu.utils.config as jax_config
import dmlc_tpu.utils.metrics as jax_metrics
import dmlc_tpu.utils.ring as jax_ring
import dmlc_tpu_torch.cluster.admission as port_admission
import dmlc_tpu_torch.cluster.retrypolicy as port_retrypolicy
import dmlc_tpu_torch.cluster.rpc as port_rpc
import dmlc_tpu_torch.cluster.tenant as port_tenant
import dmlc_tpu_torch.utils.config as port_config
import dmlc_tpu_torch.utils.metrics as port_metrics
import dmlc_tpu_torch.utils.ring as port_ring

SIDES = {
    "jax": (jax_admission, jax_retrypolicy, jax_rpc, jax_tenant, jax_metrics),
    "port": (port_admission, port_retrypolicy, port_rpc, port_tenant, port_metrics),
}


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def retry_run(side: str, seed: int) -> list:
    """A seeded sequence of allow / allow_retry / record / clock steps over
    three destinations; every verdict, state and snapshot along the way."""
    _, retrypolicy, rpc, _, metrics = SIDES[side]
    clock = FakeClock()
    counters = metrics.Counters()
    policy = retrypolicy.RetryPolicy(clock=clock, breaker_threshold=3, breaker_cooldown_s=2.0,
                                     retry_rate_per_s=0.5, retry_burst=3.0, metrics=counters)
    errors = [None, rpc.RpcUnreachable("down"), rpc.Overloaded("full", retry_after_s=0.1),
              rpc.DeadlineExceeded("late"), rpc.RpcError("method bug"),
              rpc.DecodeError("poison")]
    rng = random.Random(seed)
    out = []
    for _ in range(600):
        dest = rng.choice(["a:1", "b:1", "c:1"])
        op = rng.random()
        if op < 0.3:
            out.append(("allow", dest, policy.allow(dest)))
        elif op < 0.5:
            out.append(("retry", dest, policy.allow_retry(dest)))
        elif op < 0.85:
            err = rng.choice(errors)
            policy.record(dest, err)
            out.append(("record", dest, None if err is None else type(err).__name__,
                        retrypolicy.is_overload_error(err) if err is not None else False))
        else:
            clock.t += rng.choice([0.1, 0.7, 2.5])
        out.append((policy.breaker_state(dest), policy.open_count(dest)))
    out.append(policy.snapshot())
    out.append(counters.snapshot())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retry_policy_verdicts_match(seed):
    got, want = retry_run("port", seed), retry_run("jax", seed)
    assert got == want
    assert any(step[0] == "open" for step in got if isinstance(step, tuple) and len(step) == 2)


def gate_run(side: str, seed: int) -> list:
    """A seeded sequence of admissions held open and released, across
    tenants with declared shares; every verdict and summary."""
    admission, _, rpc, tenant, metrics = SIDES[side]
    counters = metrics.Counters()
    gate = admission.AdmissionGate(
        3, 2, name="predict", metrics=counters, retry_after_s=0.5,
        tenants=tenant.parse_tenants({"acme": {"share": 0.4, "priority": "low"},
                                      "beta": {"share": 0.8}}))
    rng = random.Random(seed)
    held: list[ExitStack] = []
    out = []
    for _ in range(300):
        if held and rng.random() < 0.4:
            held.pop(rng.randrange(len(held))).close()
            out.append("release")
        else:
            name = rng.choice([None, "acme", "beta", "stranger"])
            stack = ExitStack()
            try:
                stack.enter_context(tenant.bind(name))
                stack.enter_context(gate.admit())
            except rpc.Overloaded as e:
                stack.close()
                out.append(("shed", str(e), e.retry_after_s, e.tenant, e.quota))
            else:
                held.append(stack)
                out.append(("admit", name))
        out.append(gate.summary())
    while held:
        held.pop().close()
    out.append(gate.summary())
    out.append(counters.snapshot())
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_admission_gate_verdicts_match(seed):
    got, want = gate_run("port", seed), gate_run("jax", seed)
    assert got == want
    quotas = {step[4] for step in got if isinstance(step, tuple) and step[0] == "shed"}
    assert quotas == {"over_quota", "gate_full"}


def registry_text(side: str) -> tuple[str, dict, dict]:
    metrics = SIDES[side][4]
    reg = metrics.Registry()
    reg.counters.inc("shed", 3)
    reg.counters.inc("deadline_exceeded")
    reg.counters.observe_high("queue_hw_predict", 4)
    reg.gauge("predict_gate_active", lambda: 2)
    reg.gauge("broken", lambda: 1 / 0)
    rng = random.Random(5)
    for name in ("rpc/job.predict", "rpc/job.decode"):
        stats = reg.latency(name)
        for _ in range(500):
            stats.record(rng.lognormvariate(-4, 1))
    guard = metrics.TenantLabelGuard(max_tenants=2, counters=reg.counters)
    labels = [guard.label(t) for t in ("a", "b", "c", "a", "d")]
    merged = metrics.merge_mergeable_snapshots([reg.snapshot(mergeable=True)] * 3)
    return (reg.prometheus_text(labels='node="10.0.0.1:8852"') + "|".join(labels),
            metrics.summarize_mergeable(merged), reg.snapshot())


def test_registry_and_prometheus_text_match():
    got, want = registry_text("port"), registry_text("jax")
    assert got == want
    assert "dmlc_shed" in got[0] and "_hist_seconds_bucket" in got[0]
    assert got[1]["nodes"] == 3 and got[1]["counters"]["shed"] == 9


def test_cluster_config_from_the_same_json_matches(tmp_path):
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps({"ring_k": 3, "heartbeat_interval_s": 0.5,
                                "auth_key": "fleet", "gossip_max_entries": 16,
                                "tenants": {"acme": {"share": 0.25}}}))
    got = port_config.ClusterConfig.from_json(path)
    want = jax_config.ClusterConfig.from_json(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(port_config.ClusterConfig()) == \
        dataclasses.asdict(jax_config.ClusterConfig())
    out = tmp_path / "again.json"
    got.to_json(out)
    assert dataclasses.asdict(jax_config.ClusterConfig.from_json(out)) == \
        dataclasses.asdict(want)
    path.write_text(json.dumps({"no_such_key": 1}))
    with pytest.raises(ValueError, match="unknown config keys"):
        port_config.ClusterConfig.from_json(path)


@pytest.mark.parametrize("seed", range(4))
def test_ring_neighbours_match(seed):
    rng = random.Random(seed)
    for _ in range(200):
        ids = [(f"10.0.0.{rng.randrange(40)}:8850", float(rng.randrange(3)))
               for _ in range(rng.randrange(0, 30))]
        me = (f"10.0.0.{rng.randrange(40)}:8850", 0.0)
        k = rng.randrange(0, 5)
        dead = set(rng.sample(ids, len(ids) // 4)) if ids else set()
        for predicate in (None, lambda i: i not in dead):
            assert port_ring.symmetric_ring_neighbors(ids, me, k, predicate) == \
                jax_ring.symmetric_ring_neighbors(ids, me, k, predicate)
