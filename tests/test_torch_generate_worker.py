"""job.generate / job.generate_poll / job.generate_cancel through the port's
GenerateWorker, against the JAX package's GenerateWorker on the same
weights. An in-process ``rpc`` (calls go straight to a worker's
``methods()`` table) keeps these tests off sockets; the same verbs over the
TCP fabric are tests/test_torch_serve_tcp.py's. Greedy tokens must be
identical.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.generate.worker import GenerateWorker as JaxWorker
from dmlc_tpu.generate.worker import GenerationBackend as JaxBackend
from dmlc_tpu.models.registry import get_model as jax_get_model
from dmlc_tpu_torch.cluster.deadline import Deadline
from dmlc_tpu_torch.cluster.rpc import DeadlineExceeded, Overloaded, RpcError, remote_error
from dmlc_tpu_torch.generate.worker import (
    GenerateWorker,
    GenerationBackend,
    generate,
    generate_stream,
)

BACKEND_KW = dict(max_slots=4, page_size=8, num_pages=128, max_prefill=16, max_waiting=64)
TIMEOUT_S = 60.0


class LocalRpc:
    """In-process stand-in for the RPC fabric: ``call`` runs the method of
    the worker's table on the caller's thread."""

    def __init__(self, methods):
        self.methods = methods

    def call(self, addr, method, payload, timeout=None):
        return self.methods[method](dict(payload))


@pytest.fixture(scope="module")
def jax_variables():
    cache = {}

    def get(name):
        if name not in cache:
            _, v = jax_get_model(name).init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
            cache[name] = jax.tree_util.tree_map(np.asarray, v)
        return cache[name]

    return get


def _worker(variables, model="lm_small", **kw):
    backend = GenerationBackend(model, device="cpu", **{**BACKEND_KW, **kw})
    backend.warmup()
    backend.load_variables(variables)
    return backend, GenerateWorker({model: backend})


def _requests(seed, vocab, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(2, 15))).tolist(),
             int(rng.integers(1, 10))) for _ in range(n)]


def _poll_until_done(methods, gen_id, ack=0):
    deadline = time.monotonic() + TIMEOUT_S
    while time.monotonic() < deadline:
        reply = methods["job.generate_poll"]({"gen_id": gen_id, "ack": ack})
        if reply["done"]:
            return reply
        time.sleep(0.005)
    raise AssertionError(f"generation {gen_id} did not finish")


def test_generate_then_poll_with_cumulative_ack(jax_variables):
    backend, worker = _worker(jax_variables("lm_small"))
    try:
        methods = worker.methods()
        reply = methods["job.generate"]({"model": "lm_small", "prompt": [1, 2, 3],
                                         "max_new_tokens": 5})
        gid = reply["gen_id"]
        r1 = _poll_until_done(methods, gid)
        # Unacked chunks are retained: a replayed poll reads the same ones.
        r2 = methods["job.generate_poll"]({"gen_id": gid, "ack": 0})
        assert r1["chunks"] == r2["chunks"] and r2["done"] and r2["error"] is None
        assert [seq for seq, _ in r1["chunks"]] == [1, 2, 3, 4, 5]
        # A cumulative ack drops every chunk at or below it, for good.
        r3 = methods["job.generate_poll"]({"gen_id": gid, "ack": 3})
        assert [seq for seq, _ in r3["chunks"]] == [4, 5]
        r4 = methods["job.generate_poll"]({"gen_id": gid, "ack": 5})
        assert r4["chunks"] == [] and r4["done"]
        again = methods["job.generate_poll"]({"gen_id": gid, "ack": 0})
        assert again["chunks"] == []
    finally:
        backend.stop()


@pytest.mark.parametrize("model", ["lm_small", "lm_wide"])
def test_greedy_tokens_match_the_jax_worker(model, jax_variables):
    """Concurrent clients through both workers: every stream's tokens equal
    the JAX worker's for the same request."""
    variables = jax_variables(model)
    vocab = jax_get_model(model).num_outputs
    backend, worker = _worker(variables, model=model)
    ref_backend = JaxBackend(model, **BACKEND_KW)
    ref_backend.warmup()
    ref_backend.load_variables(variables)
    ref = JaxWorker({model: ref_backend})
    reqs = _requests(200, vocab, 8)
    try:
        results, errors = {}, {}

        def run(i, w, key):
            prompt, n = reqs[i]
            try:
                results[key, i] = generate(LocalRpc(w.methods()), "member", model, prompt,
                                           max_new_tokens=n, poll_interval_s=0.002)
            except Exception as e:  # collected and asserted below
                errors[key, i] = e

        threads = [threading.Thread(target=run, args=(i, w, key))
                   for key, w in (("port", worker), ("jax", ref)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        for i, (_, n) in enumerate(reqs):
            assert len(results["port", i]) == n
            assert results["port", i] == results["jax", i], i
        eng = backend._scheduler.engine
        assert eng.pages_free == eng.cache.allocator.pages_total
    finally:
        backend.stop()
        ref_backend.stop()


def test_generate_is_idempotent_on_gen_id(jax_variables):
    backend, worker = _worker(jax_variables("lm_small"))
    try:
        methods = worker.methods()
        req = {"model": "lm_small", "prompt": [4, 5], "max_new_tokens": 4, "gen_id": "g1"}
        assert methods["job.generate"](req) == {"gen_id": "g1", "model": "lm_small"}
        assert methods["job.generate"](req)["resumed"] is True
        _poll_until_done(methods, "g1")
        assert backend.summary()["requests"] == 1  # one prefill, not two
    finally:
        backend.stop()


def test_cancel_frees_the_slot(jax_variables):
    backend, worker = _worker(jax_variables("lm_small"), max_slots=1, max_waiting=0)
    try:
        methods = worker.methods()
        long = {"model": "lm_small", "prompt": [1, 2], "max_new_tokens": 200, "gen_id": "long"}
        methods["job.generate"](long)
        stream = worker._sessions["long"].stream
        assert methods["job.generate_cancel"]({"gen_id": "long"}) == {"cancelled": True}
        assert methods["job.generate_cancel"]({"gen_id": "long"}) == {"cancelled": False}
        assert stream.wait(timeout=TIMEOUT_S) and stream.error.startswith("cancelled")
        eng = backend._scheduler.engine
        assert eng.slots_active == 0 and len(stream.tokens()) < 200
        # The freed slot and its pages admit the next request.
        out = generate(LocalRpc(methods), "member", "lm_small", [3, 4], max_new_tokens=3,
                       poll_interval_s=0.002)
        assert len(out) == 3
        assert eng.pages_free == eng.cache.allocator.pages_total
    finally:
        backend.stop()


def test_full_slot_table_sheds_typed_overloaded(jax_variables):
    backend, worker = _worker(jax_variables("lm_small"), max_slots=2, max_waiting=0)
    try:
        methods = worker.methods()
        for i in range(2):
            methods["job.generate"]({"model": "lm_small", "prompt": [1, 2, 3],
                                     "max_new_tokens": 200, "gen_id": f"busy{i}"})
        with pytest.raises(Overloaded) as e:
            methods["job.generate"]({"model": "lm_small", "prompt": [1], "max_new_tokens": 2})
        assert e.value.retry_after_s is not None and "slot table full" in str(e.value)
        assert backend.summary()["sheds"] == 1
        for i in range(2):
            methods["job.generate_cancel"]({"gen_id": f"busy{i}"})
    finally:
        backend.stop()


def test_deadline_and_errors_are_typed(jax_variables):
    backend, worker = _worker(jax_variables("lm_small"))
    try:
        stream = backend.submit([1, 2, 3], max_new_tokens=200, deadline=Deadline(0.02))
        with pytest.raises(DeadlineExceeded):
            stream.result(timeout=TIMEOUT_S)
        methods = worker.methods()
        with pytest.raises(RpcError, match="not served here"):
            methods["job.generate"]({"model": "nope", "prompt": [1], "max_new_tokens": 1})
        with pytest.raises(RpcError, match="unknown generation"):
            methods["job.generate_poll"]({"gen_id": "missing", "ack": 0})
        with pytest.raises(RpcError, match="max_prefill"):
            methods["job.generate"]({"model": "lm_small", "prompt": list(range(17)),
                                     "max_new_tokens": 1})
    finally:
        backend.stop()
    assert isinstance(remote_error("Overloaded: overloaded: full", 0.5), Overloaded)
    assert isinstance(remote_error("deadline: late"), DeadlineExceeded)
    assert type(remote_error("boom")) is RpcError


def test_generate_stream_yields_tokens_as_they_come(jax_variables):
    backend, worker = _worker(jax_variables("lm_small"))
    try:
        rpc = LocalRpc(worker.methods())
        stream = generate_stream(rpc, "member", "lm_small", [7, 8, 9], max_new_tokens=6,
                                 temperature=0.8, seed=3, poll_interval_s=0.002)
        first = next(stream)
        rest = list(stream)
        again = generate(rpc, "member", "lm_small", [7, 8, 9], max_new_tokens=6,
                         temperature=0.8, seed=3, poll_interval_s=0.002)
        assert [first, *rest] == again  # seeded sampling replays
    finally:
        backend.stop()


def test_backend_needs_cuda_unless_the_cpu_is_named(monkeypatch):
    from dmlc_tpu_torch.generate.engine import GenerationEngine
    from dmlc_tpu_torch.generate.kvcache import PagedKVCache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: GenerationBackend("lm_small"),
        lambda: GenerationEngine("lm_small"),
        lambda: PagedKVCache(num_layers=1, num_pages=2, page_size=4, num_heads=1,
                             head_dim=8, max_slots=1, max_pages_per_slot=1),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert GenerationBackend("lm_small", device="cpu").summary() == {"built": False}
