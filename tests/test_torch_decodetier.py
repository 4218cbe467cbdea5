"""Every case of tests/test_decodetier.py, run against both packages (the
``pkg`` fixture): the fleet decode tier's fan-out (order, spans), chunking
by bytes, poison input redone locally without charging the breaker,
``job.decode`` admission, member death mid-batch, the whole fleet dead,
the ``run_paths_stream`` decode seam of each package's own engine (the
port's on the CPU), the profiler's decode stage and the decode-lane gauge.

The names imported below are the JAX package's; ``sided`` rebinds each to
the object of the same name in the package under test, for each case.
"""

from __future__ import annotations

import io
import os
import time

import numpy as np
import pytest
from torch_sides import JAX, bind_sides, pkg  # noqa: F401  (pkg: fixture)

from dmlc_tpu.cluster.decodetier import DecodeTierClient
from dmlc_tpu.cluster.retrypolicy import RetryPolicy
from dmlc_tpu.cluster.rpc import (
    DecodeError,
    Overloaded,
    RpcError,
    RpcUnreachable,
    remote_error,
    serve_with_deadline,
)
from dmlc_tpu.scheduler.worker import PredictWorker
from dmlc_tpu.utils import tracing

sided = bind_sides(globals(), {
    "DecodeTierClient": "decodetier", "RetryPolicy": "retrypolicy", "DecodeError": "rpc",
    "Overloaded": "rpc", "RpcError": "rpc", "RpcUnreachable": "rpc", "remote_error": "rpc",
    "serve_with_deadline": "rpc", "PredictWorker": "worker", "tracing": None,
})

SEED_BASE = int(os.environ.get("DMLC_CHAOS_SEED", "0"))


def seeds(n: int) -> range:
    return range(SEED_BASE, SEED_BASE + n)


def jpeg(i: int, size: int = 32) -> bytes:
    """A solid-color JPEG whose color encodes the blob's index, so order
    and drops are checkable on the decoded tensor."""
    from PIL import Image

    arr = np.full((size, size, 3), (i * 7) % 256, np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=95)
    return buf.getvalue()


def assert_rows_in_order(out: np.ndarray, n: int, skip: set[int] = frozenset()):
    """Every row i must be blob i's color (JPEG is lossy: +-4 levels)."""
    for i in range(n):
        if i in skip:
            continue
        got, want = int(out[i, 0, 0, 0]), (i * 7) % 256
        assert abs(got - want) <= 4, f"row {i}: got {got}, want {want}"


class FakeFleet:
    """In-process member fleet: each address routes to a real PredictWorker
    through ``serve_with_deadline`` (so the deadline frame and the
    traced-methods span wrapping are the production ones), with an
    injectable kill schedule for the chaos tests."""

    def __init__(self, n: int = 4):
        self.workers = {
            f"10.0.0.{i}:7000": PredictWorker({}) for i in range(n)
        }
        self.calls: list[tuple[str, str]] = []
        self.dead: set[str] = set()
        self.die_after: dict[str, int] = {}  # dest -> calls served before death

    def members(self):
        return sorted(self.workers)

    def call(self, dest, method, payload, timeout=None, **kw):
        self.calls.append((dest, method))
        if dest in self.die_after:
            if self.die_after[dest] <= 0:
                self.dead.add(dest)
                del self.die_after[dest]
            else:
                self.die_after[dest] -= 1
        if dest in self.dead:
            raise RpcUnreachable(f"unreachable: {dest}")
        try:
            return serve_with_deadline(
                self.workers[dest].methods(), method, payload,
                timeout or 30.0, time.monotonic,
            )
        except RpcError as e:
            # The server flattens errors to strings; re-type like the
            # production client so DecodeError/Overloaded survive the wire.
            raise remote_error(str(e)) from None


@pytest.fixture
def traced():
    tracer = tracing.tracer
    was = tracer.enabled
    tracer.reset()
    tracer.enabled = True
    yield tracer
    tracer.enabled = was
    tracer.reset()


# ---------------------------------------------------------------------------
# fan-out correctness + span visibility
# ---------------------------------------------------------------------------


def test_fan_out_preserves_order_and_traces_every_remote_decode(traced):
    fleet = FakeFleet(n=4)
    tier = DecodeTierClient(fleet, fleet.members, min_batch=4, fanout=4)
    n = 32
    out = tier.decode_batch([jpeg(i) for i in range(n)], 32)
    assert out.shape == (n, 32, 32, 3)
    assert_rows_in_order(out, n)
    stats = tier.stats()
    assert stats["remote"] == n and stats["local"] == 0 and stats["poison"] == 0
    # Every remote chunk is one rpc/job.decode span — visibility comes from
    # the member's traced method table, exactly like job.predict.
    n_chunks = len([c for c in fleet.calls if c[1] == "job.decode"])
    assert n_chunks >= 4  # 4 peers, contiguous chunks
    summary = traced.summary()
    assert summary["rpc/job.decode"]["count"] == n_chunks


def test_small_batch_skips_the_tier():
    fleet = FakeFleet(n=4)
    tier = DecodeTierClient(fleet, fleet.members, min_batch=16)
    n = 8
    out = tier.decode_batch([jpeg(i) for i in range(n)], 32)
    assert_rows_in_order(out, n)
    assert fleet.calls == []  # below min_batch: the RPC round-trip loses
    assert tier.stats()["local"] == n


def test_chunks_are_contiguous_and_byte_bounded():
    tier = DecodeTierClient(None, lambda: [], max_bytes_per_rpc=100)
    blobs = [b"x" * 40 for _ in range(10)]
    chunks = tier._chunks(blobs, n_peers=2)
    # Complete, contiguous, in order.
    assert chunks[0][0] == 0 and chunks[-1][1] == len(blobs)
    for (_, a_stop), (b_start, _) in zip(chunks, chunks[1:]):
        assert a_stop == b_start
    for start, stop in chunks:
        assert sum(len(b) for b in blobs[start:stop]) <= 100


# ---------------------------------------------------------------------------
# acceptance: N=4 members >= 2.5x the single-host baseline, same test
# ---------------------------------------------------------------------------


def test_fleet_decode_beats_single_host_by_2_5x(traced, monkeypatch, pkg):
    pp = pkg.preprocess
    PER_BLOB_S = 0.005
    N = 64

    def slow_decode(blobs, size=224, **kw):
        # GIL-releasing decode stand-in; rows carry the blob's first byte
        # so order/drops stay checkable through the fan-out.
        time.sleep(PER_BLOB_S * len(blobs))
        out = np.zeros((len(blobs), size, size, 3), np.uint8)
        for i, b in enumerate(blobs):
            out[i] = b[0]
        return out, np.zeros(len(blobs), np.uint8)

    monkeypatch.setattr(pp, "decode_blobs", slow_decode)
    blobs = [bytes([i % 251]) * 64 for i in range(N)]

    # Single-host baseline: same client code path, empty fleet.
    solo = DecodeTierClient(None, lambda: [], min_batch=4)
    t0 = time.perf_counter()
    out = solo.decode_batch(blobs, 16)
    baseline_s = time.perf_counter() - t0
    assert [int(out[i, 0, 0, 0]) for i in range(N)] == [i % 251 for i in range(N)]

    # N=4 decode-capable members.
    fleet = FakeFleet(n=4)
    tier = DecodeTierClient(fleet, fleet.members, min_batch=4, fanout=8)
    t0 = time.perf_counter()
    out = tier.decode_batch(blobs, 16)
    fleet_s = time.perf_counter() - t0

    # Zero reordered/dropped tensors...
    assert [int(out[i, 0, 0, 0]) for i in range(N)] == [i % 251 for i in range(N)]
    # ... every remote decode visible as an rpc/job.decode span ...
    n_chunks = len([c for c in fleet.calls if c[1] == "job.decode"])
    assert traced.summary()["rpc/job.decode"]["count"] == n_chunks
    assert tier.stats()["remote"] == N
    # ... and the fleet beats the single host by the acceptance ratio.
    assert fleet_s < baseline_s / 2.5, (
        f"fleet {fleet_s:.3f}s vs baseline {baseline_s:.3f}s: "
        f"speedup {baseline_s / fleet_s:.2f}x < 2.5x"
    )


# ---------------------------------------------------------------------------
# poison: typed DecodeError, no breaker/budget charge, one local retry
# ---------------------------------------------------------------------------


def test_truncated_jpeg_is_typed_decode_error_not_transport():
    w = PredictWorker({})
    blobs = [jpeg(0), jpeg(1)[:24], jpeg(2)]  # middle blob truncated
    with pytest.raises(DecodeError) as ei:
        w._decode({"size": 32, "blobs": blobs})
    # The verdict survives the wire's string flattening.
    assert "decode_error:" in str(ei.value)
    assert isinstance(remote_error(str(ei.value)), DecodeError)


def test_poison_chunk_redone_locally_without_charging_the_breaker():
    fleet = FakeFleet(n=2)
    policy = RetryPolicy(breaker_threshold=1)  # hair-trigger on purpose
    tier = DecodeTierClient(
        fleet, fleet.members, min_batch=4, retry_policy=policy
    )
    n = 8
    blobs = [jpeg(i) for i in range(n)]
    blobs[5] = blobs[5][:24]  # poison
    out = tier.decode_batch(blobs, 32)
    # Good rows exact, the poison slot zero-filled — never dropped rows.
    assert_rows_in_order(out, n, skip={5})
    assert not out[5].any()
    stats = tier.stats()
    assert stats["poison"] == 1
    assert stats["remote"] + stats["local"] == n - 1
    # The member ANSWERED — poison is input badness, not peer health: even a
    # breaker that opens on one failure must still admit every peer.
    for dest in fleet.members():
        assert policy.allow(dest), f"breaker tripped on poison for {dest}"


def test_decode_admission_sheds_typed_overloaded(pkg):
    AdmissionGate = pkg.admission.AdmissionGate

    gate = AdmissionGate(max_inflight=1, max_queue=0, name="predict")
    w = PredictWorker({}, gate=gate)
    with gate.admit():  # the one slot is taken
        with pytest.raises(Overloaded):
            w._decode({"size": 32, "blobs": [jpeg(0)]})


# ---------------------------------------------------------------------------
# chaos: member death mid-batch degrades throughput, never correctness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", seeds(3))
def test_member_death_mid_batch_reroutes_chunks(seed, traced):
    import random

    rng = random.Random(seed)
    fleet = FakeFleet(n=4)
    victim = rng.choice(fleet.members())
    # Dies after serving 0-2 chunks — possibly before its first answer.
    fleet.die_after[victim] = rng.randrange(3)
    policy = RetryPolicy()
    n = 48
    blobs = [jpeg(i) for i in range(n)]
    tier = DecodeTierClient(
        fleet, fleet.members, min_batch=4, fanout=4, retry_policy=policy,
        # ~3 blobs per chunk -> every peer sees several chunks, so the kill
        # schedule always lands mid-batch (not after the victim's only call).
        max_bytes_per_rpc=3 * max(len(b) for b in blobs),
    )
    out = tier.decode_batch(blobs, 32)
    # Exactly-once, in-order delivery regardless of the kill schedule: every
    # chunk landed via a live peer or the local fallback.
    assert_rows_in_order(out, n)
    stats = tier.stats()
    assert stats["remote"] + stats["local"] == n
    assert stats["poison"] == 0
    assert victim in fleet.dead
    assert stats["remote_failures"] >= 1  # the death was observed, not masked


def test_whole_fleet_dead_degrades_to_local():
    fleet = FakeFleet(n=3)
    fleet.dead.update(fleet.members())
    tier = DecodeTierClient(fleet, fleet.members, min_batch=4)
    n = 16
    out = tier.decode_batch([jpeg(i) for i in range(n)], 32)
    assert_rows_in_order(out, n)
    assert tier.stats()["local"] == n  # degraded, nothing dropped


# ---------------------------------------------------------------------------
# wiring: run_paths_stream seam + decode-lane gauge
# ---------------------------------------------------------------------------


def test_run_paths_stream_decode_source_matches_default(tmp_path, pkg):
    from tiny_model import N_CLASSES  # noqa: F401  (registers "tinynet")

    from dmlc_tpu.utils import corpus

    if pkg.name == "port":
        import test_torch_engine  # noqa: F401  (registers the port's "tinynet")
        from dmlc_tpu_torch.parallel.inference import InferenceEngine as Engine

        def InferenceEngine(*a, **kw):  # noqa: N802  (the reference's name)
            return Engine(*a, device="cpu", **kw)
    else:
        from dmlc_tpu.parallel.inference import InferenceEngine

    data_dir, _ = corpus.generate(
        tmp_path, n_classes=8, images_per_class=4, size=48
    )
    paths = sorted(p for d in sorted(data_dir.iterdir()) for p in d.iterdir())
    engine = InferenceEngine("tinynet", batch_size=8, seed=5)
    engine.warmup()
    want = engine.run_paths_stream(paths).top1_index
    tier = DecodeTierClient(None, lambda: [])  # local mode, fleet path
    got = engine.run_paths_stream(paths, decode_source=tier.decode_paths).top1_index
    assert list(got) == list(want)
    assert tier.stats()["local"] == len(paths)


def test_remote_decode_spans_fold_into_profiler_decode_stage(traced, pkg):
    ANY_MODEL, CostProfiler = pkg.profile.ANY_MODEL, pkg.profile.CostProfiler

    fleet = FakeFleet(n=2)
    tier = DecodeTierClient(fleet, fleet.members, min_batch=4)
    tier.decode_batch([jpeg(i) for i in range(16)], 32)
    profiler = CostProfiler(window_s=60.0, windows=4)
    assert profiler.ingest_scrape("m0", {"spans": traced.summary()}) >= 1
    # rpc/job.decode lands in the same "decode" stage host/decode feeds —
    # placement sees one decode cost signal whichever host did the work.
    assert profiler.mean_cost("m0", stage="decode", model=ANY_MODEL) is not None


def test_decode_lane_idle_gauge_tracks_inflight(pkg):
    Registry = pkg.metrics.Registry

    w = PredictWorker({}, decode_lanes=4)
    reg = Registry()
    reg.gauge("decode_lane_idle", w.decode_lane_idle)
    assert reg.snapshot()["gauges"]["decode_lane_idle"] == 4
    with w._decode_lock:
        w._decode_active = 3
    assert reg.snapshot()["gauges"]["decode_lane_idle"] == 1
