"""The port's DynamicBatcher (scheduler/worker.py) against the JAX
package's: the cases of tests/test_microbatch.py (coalescing, deadline,
result mapping, error propagation, backend passthrough, the acceptance bar
of N concurrent single-image requests in at most ceil(N / batch)
dispatches), and the bounded queue, brownout and tenant quota cases of
tests/test_overload.py and tests/test_tenant.py, each run once against each
package. The "device" is a fake predict function that records its calls.
"""

import threading
import time

import pytest
from torch_sides import pkg  # noqa: F401  (fixture)


class FakePredict:
    """Records every dispatched batch; predicts int(synset) deterministically."""

    def __init__(self, error=None, delay_s: float = 0.0):
        self.calls: list[list[str]] = []
        self.delay_s = delay_s
        self.error = error
        self._lock = threading.Lock()

    def __call__(self, synsets):
        with self._lock:
            self.calls.append(list(synsets))
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.error is not None:
            raise self.error("backend down")
        return [int(s) for s in synsets]

    def warmup(self):
        return "warm"

    def predict_gang(self, synsets, rank, world):
        return [0] * len(synsets)


def test_coalesces_concurrent_requests_acceptance(pkg):
    fake = FakePredict()
    batcher = pkg.worker.DynamicBatcher(fake, batch_size=8, max_wait_s=0.25)
    try:
        n = 12
        results: dict[int, int] = {}
        barrier = threading.Barrier(n)

        def one(i: int) -> None:
            barrier.wait()
            results[i] = batcher([str(i)])[0]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert results == {i: i for i in range(n)}
        assert sum(len(c) for c in fake.calls) == n
        assert len(fake.calls) <= -(-n // 8), f"{len(fake.calls)} dispatches: {fake.calls}"
        s = batcher.summary()
        assert s["requests"] == n and s["dispatches"] == len(fake.calls)
        assert s["mean_fill"] > 0.5
    finally:
        batcher.stop()


def test_full_batch_dispatches_without_waiting_deadline(pkg):
    fake = FakePredict()
    batcher = pkg.worker.DynamicBatcher(fake, batch_size=4, max_wait_s=30.0)
    try:
        t0 = time.perf_counter()
        preds = batcher(["1", "2", "3", "4"])
        elapsed = time.perf_counter() - t0
        assert preds == [1, 2, 3, 4]
        assert elapsed < 5.0
        assert fake.calls == [["1", "2", "3", "4"]]
    finally:
        batcher.stop()


def test_deadline_dispatches_partial_batch(pkg):
    fake = FakePredict()
    batcher = pkg.worker.DynamicBatcher(fake, batch_size=8, max_wait_s=0.05)
    try:
        assert batcher(["7"]) == [7]
        assert fake.calls == [["7"]]
        assert batcher.summary()["mean_fill"] == pytest.approx(1 / 8)
    finally:
        batcher.stop()


def test_oversized_request_splits_into_device_batches(pkg):
    fake = FakePredict()
    batcher = pkg.worker.DynamicBatcher(fake, batch_size=4, max_wait_s=0.05)
    try:
        preds = batcher([str(i) for i in range(10)])
        assert preds == list(range(10))
        assert all(len(c) <= 4 for c in fake.calls)
        assert sum(len(c) for c in fake.calls) == 10
    finally:
        batcher.stop()


def test_backend_error_propagates_to_every_waiter(pkg):
    batcher = pkg.worker.DynamicBatcher(FakePredict(error=pkg.rpc.RpcError), batch_size=4,
                                        max_wait_s=0.02)
    try:
        with pytest.raises(pkg.rpc.RpcError, match="backend down"):
            batcher(["1", "2"])
    finally:
        batcher.stop()


def test_wrong_prediction_count_is_an_error(pkg):
    batcher = pkg.worker.DynamicBatcher(lambda synsets: [0], batch_size=4, max_wait_s=0.02)
    try:
        with pytest.raises(pkg.rpc.RpcError, match="predictions"):
            batcher(["1", "2", "3"])
    finally:
        batcher.stop()


def test_stop_drains_queue_then_rejects_new_work(pkg):
    fake = FakePredict(delay_s=0.05)
    batcher = pkg.worker.DynamicBatcher(fake, batch_size=2, max_wait_s=0.01)
    futs = [batcher.submit(str(i)) for i in range(4)]
    batcher.stop()
    assert [f.result(timeout=5) for f in futs] == [0, 1, 2, 3]
    with pytest.raises(RuntimeError, match="stopped"):
        batcher.submit("5")


def test_backend_capability_passthrough(pkg):
    fake = FakePredict()
    batcher = pkg.worker.DynamicBatcher(fake, batch_size=4)
    try:
        assert batcher.warmup() == "warm"
        assert hasattr(batcher, "predict_gang")
        assert batcher.predict_gang(["a", "b"], 0, 1) == [0, 0]
        assert not hasattr(batcher, "decode_gang")
    finally:
        batcher.stop()


def test_submit_returns_future_per_request(pkg):
    fake = FakePredict()
    batcher = pkg.worker.DynamicBatcher(fake, batch_size=2, max_wait_s=0.02)
    try:
        f1, f2 = batcher.submit("4"), batcher.submit("9")
        assert f1.result(timeout=5) == 4 and f2.result(timeout=5) == 9
    finally:
        batcher.stop()


def test_sequential_calls_reuse_one_worker(pkg):
    fake = FakePredict()
    batcher = pkg.worker.DynamicBatcher(fake, batch_size=2, max_wait_s=0.02)
    try:
        assert batcher(["1", "2"]) == [1, 2]
        assert batcher(["3", "4"]) == [3, 4]
        s = batcher.summary()
        assert s["requests"] == 4 and s["dispatches"] == 2
        assert s["mean_fill"] == pytest.approx(1.0)
    finally:
        batcher.stop()


def test_predict_worker_serves_through_batcher(pkg):
    """``job.predict`` works unchanged over a wrapped backend; the gang
    verbs' backend call passes through the batcher undispatched."""
    fake = FakePredict()
    batcher = pkg.worker.DynamicBatcher(fake, batch_size=4, max_wait_s=0.02)
    try:
        worker = pkg.worker.PredictWorker({"m": batcher})
        reply = worker._predict({"model": "m", "synsets": ["3", "1"]})
        assert reply["predictions"] == [3, 1]
        assert batcher.predict_gang(["3", "1"], 0, 1) == [0, 0]
        assert [c for c in fake.calls if c] == [["3", "1"]]
    finally:
        batcher.stop()


def test_node_config_has_microbatch_knob(pkg):
    cfg = pkg.config.ClusterConfig()
    assert cfg.microbatch_wait_s == 0.0
    assert cfg.with_updates(microbatch_wait_s=0.002).microbatch_wait_s == 0.002


# ---------------------------------------------------------------------------
# Overload control: the bounded queue and its brownout
# ---------------------------------------------------------------------------


def test_batcher_bounded_queue_sheds_typed(pkg):
    release = threading.Event()

    def blocked(synsets):
        release.wait(5.0)
        return [int(s) for s in synsets]

    metrics = pkg.metrics.Counters()
    batcher = pkg.worker.DynamicBatcher(blocked, batch_size=2, max_wait_s=0.01, max_queue=4,
                                        metrics=metrics)
    try:
        futs = [batcher.submit(str(i)) for i in range(2)]
        time.sleep(0.1)
        futs += [batcher.submit(str(i)) for i in range(2, 6)]
        with pytest.raises(pkg.rpc.Overloaded) as exc:
            batcher.submit("nope")
        assert exc.value.retry_after_s == pytest.approx(0.01)
        release.set()
        assert sorted(f.result(timeout=5) for f in futs) == list(range(6))
        s = batcher.summary()
        assert s["sheds"] == 1 and s["queue_hw"] == 4
        assert metrics.snapshot()["shed_microbatch"] == 1
    finally:
        release.set()
        batcher.stop()


def test_batcher_brownout_skips_wait_when_queue_deep(pkg):
    def backend(synsets):
        return [int(s) for s in synsets]

    batcher = pkg.worker.DynamicBatcher(backend, batch_size=4, max_wait_s=0.5, max_queue=4)
    try:
        t0 = time.monotonic()
        futs = [batcher.submit(str(i)) for i in range(8)]
        for f in futs:
            f.result(timeout=5)
        elapsed = time.monotonic() - t0
        assert elapsed < 0.45, f"brownout failed to shrink the wait: {elapsed:.2f}s"
    finally:
        batcher.stop()


def test_shed_is_noted_in_the_flight_recorder(pkg):
    release = threading.Event()
    recorder = pkg.flight.FlightRecorder()
    batcher = pkg.worker.DynamicBatcher(lambda s: (release.wait(5.0), [0] * len(s))[1],
                                        batch_size=2, max_wait_s=0.01, max_queue=4,
                                        flight=recorder, name="mb")
    try:
        futs = [batcher.submit(str(i)) for i in range(2)]
        time.sleep(0.1)
        futs += [batcher.submit(str(i)) for i in range(4)]
        with pytest.raises(pkg.rpc.Overloaded):
            batcher.submit("x")
        events = recorder.events()
        assert [e["kind"] for e in events] == ["shed"]
        assert events[0]["gate"] == "mb" and events[0]["quota"] == "gate_full"
        release.set()
        assert [f.result(timeout=5) for f in futs] == [0] * 6
    finally:
        release.set()
        batcher.stop()


# ---------------------------------------------------------------------------
# Tenant quotas and displacement ordering
# ---------------------------------------------------------------------------


def specs(pkg, **kw):
    return pkg.tenant.parse_tenants(
        {name: {"priority": p, "share": s} for name, (p, s) in kw.items()})


def drain_first_batch(b) -> None:
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        with b._cv:
            if not b._queue:
                return
        time.sleep(0.001)
    raise AssertionError("worker never picked up the priming batch")


def test_quota_edge_and_displacement_ordering(pkg):
    release = threading.Event()

    def predict(synsets):
        release.wait(timeout=10.0)
        return [0] * len(synsets)

    b = pkg.worker.DynamicBatcher(predict, batch_size=4, max_wait_s=0.005, max_queue=8,
                                  tenants=specs(pkg, acme=("low", 0.2), beta=("high", 1.0)))
    try:
        primed = [b.submit(f"p{i}") for i in range(4)]
        drain_first_batch(b)
        with pkg.tenant.bind("acme"):
            acme_fut = b.submit("acme0")
            with pytest.raises(pkg.rpc.Overloaded) as e:
                b.submit("acme1")
        assert e.value.quota == "over_quota" and e.value.tenant == "acme"

        filler = [b.submit(f"f{i}") for i in range(7)]
        with pkg.tenant.bind("beta"):
            with pytest.raises(pkg.rpc.Overloaded) as e:
                b.submit("beta0")
        assert e.value.quota == "gate_full"

        b.ledger.acquire("acme")
        with pkg.tenant.bind("beta"):
            beta_fut = b.submit("beta1")
        with pytest.raises(pkg.rpc.Overloaded) as displaced:
            acme_fut.result(timeout=5.0)
        assert displaced.value.quota == "over_quota" and displaced.value.tenant == "acme"

        release.set()
        assert [f.result(timeout=10.0) for f in primed] == [0] * 4
        assert [f.result(timeout=10.0) for f in filler] == [0] * 7
        assert beta_fut.result(timeout=10.0) == 0
        assert b.summary()["tenants"]["acme"]["over_quota_sheds"] == 2
    finally:
        release.set()
        b.stop()


def test_batcher_without_bound_never_enforces(pkg):
    b = pkg.worker.DynamicBatcher(lambda s: [0] * len(s), batch_size=2)
    try:
        with pkg.tenant.bind("acme"):
            assert b.submit("x").result(timeout=5.0) == 0
        assert not b.ledger.enforcing
    finally:
        b.stop()
