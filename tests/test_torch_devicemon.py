"""The device monitor (cluster/devicemon.py) of both packages.

- Every case of tests/test_devicemon.py run against both packages (``pkg``)
  but those of ``CensusedJit``, ``jax.monitoring`` and the JAX compile
  cache, which this package has no counterpart of: the compile census's
  warmup windows and steady-state edge, graceful ``None`` gauges on the
  CPU, the fleet merge dropping them, the MFU window math, the per-model
  gauges, ``pytree_nbytes``, and a three-node localcluster whose fleet
  scrape carries the device gauges.
- This package's own parts: the HBM gauges read ``torch.cuda.memory_stats``
  only once CUDA is initialized (never initializing it), the GPU roofline,
  state-dict byte counts, and the kernel-build census of ``ops/_build``
  (with the compiler stubbed: the CPU cannot run nvcc) — a build is
  recorded as ``kernel/<name>``, a cached load is not, and a rebuild after
  the warmup window lands ``recompile_steady_state``.
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch_sides import PORT, pkg  # noqa: F401  (pkg: fixture)


class VClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# tests/test_devicemon.py, both packages
# ---------------------------------------------------------------------------


class TestCompileCensus:
    def test_compiles_inside_warmup_are_not_steady(self, pkg):
        clock = VClock()
        census = pkg.devicemon.CompileCensus(clock)
        census.warmup_s = 10.0
        assert census.record("prog") is False
        clock.t = 5.0
        assert census.record("prog") is False
        assert census.compiles() == 2
        assert census.steady_recompiles() == 0

    def test_compile_after_warmup_is_steady_and_fires_callbacks(self, pkg):
        clock = VClock()
        census = pkg.devicemon.CompileCensus(clock)
        census.warmup_s = 10.0
        fired = []
        census.subscribe(lambda label, count: fired.append((label, count)))
        census.record("prog")
        clock.t = 11.0
        assert census.record("prog") is True
        assert census.steady_recompiles() == 1
        assert fired == [("prog", 2)]

    def test_warmup_windows_are_per_label(self, pkg):
        clock = VClock()
        census = pkg.devicemon.CompileCensus(clock)
        census.warmup_s = 10.0
        census.record("old")
        clock.t = 11.0
        # "young" opens its OWN window at t=11: not steady at t=15.
        census.record("young")
        clock.t = 15.0
        assert census.record("young") is False
        assert census.record("old") is True

    def test_unsubscribe_stops_callbacks(self, pkg):
        clock = VClock()
        census = pkg.devicemon.CompileCensus(clock)
        census.warmup_s = 0.0
        fired = []
        cb = lambda label, count: fired.append(label)  # noqa: E731
        census.subscribe(cb)
        census.record("prog")
        clock.t = 1.0
        census.record("prog")
        assert fired == ["prog"]
        census.unsubscribe(cb)
        clock.t = 2.0
        census.record("prog")
        assert fired == ["prog"]

    def test_callback_errors_never_break_record(self, pkg):
        clock = VClock()
        census = pkg.devicemon.CompileCensus(clock)
        census.warmup_s = 0.0
        census.subscribe(lambda label, count: 1 / 0)
        census.record("prog")
        clock.t = 1.0
        assert census.record("prog") is True  # did not raise

    def test_snapshot_shape(self, pkg):
        # The reference case's label rollup; its jax.monitoring rollup
        # (``jax_events``) has no counterpart in this package.
        clock = VClock()
        census = pkg.devicemon.CompileCensus(clock)
        census.warmup_s = 7.0
        census.record("prog", seconds=1.5)
        census.record("prog", seconds=0.5)
        snap = census.snapshot()
        assert snap["warmup_s"] == 7.0
        assert snap["labels"]["prog"] == {
            "compiles": 2, "seconds": 2.0, "steady_recompiles": 0,
        }
        assert census.compile_seconds() == pytest.approx(2.0)


def break_device_introspection(pkg, monkeypatch):
    """Make the package's device read raise: the JAX package's
    ``jax.local_devices``; this package's ``torch.cuda.memory_stats``, with
    CUDA reported initialized so the monitor reaches it."""
    def boom(*a, **k):
        raise RuntimeError("boom")

    if pkg.name == "jax":
        import jax

        monkeypatch.setattr(jax, "local_devices", boom)
    else:
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "memory_stats", boom)


class TestGracefulCpu:
    """On the CPU the monitor reports None gauges, never raises, and the
    fleet merge drops the Nones."""

    def test_hbm_gauges_read_none_on_cpu(self, pkg):
        registry = pkg.metrics.Registry()
        mon = pkg.devicemon.DeviceMonitor(
            registry, census=pkg.devicemon.CompileCensus(VClock()))
        try:
            gauges = registry.snapshot()["gauges"]
            # Present (the contract: graceful degradation, not absence) ...
            for key in ("hbm_bytes_in_use", "hbm_peak_bytes", "hbm_limit_bytes"):
                assert key in gauges
                # ... and None: the CPU has no device memory stats.
                assert gauges[key] is None
            # The census/roofline gauges still read real numbers.
            assert gauges["jit_compiles"] == 0.0
            assert gauges["device_peak_flops"] == pkg.devicemon.PEAK_FLOPS["cpu"]
        finally:
            mon.close()

    def test_broken_device_introspection_never_raises(self, pkg, monkeypatch):
        break_device_introspection(pkg, monkeypatch)
        registry = pkg.metrics.Registry()
        mon = pkg.devicemon.DeviceMonitor(
            registry, census=pkg.devicemon.CompileCensus(VClock()))
        try:
            assert mon.memory_stats() is None
            assert mon.headroom_bytes() is None
            mon.poll()  # watermark pass on a broken backend: silent no-op
            assert registry.snapshot()["gauges"]["hbm_bytes_in_use"] is None
        finally:
            mon.close()

    def test_fleet_merge_drops_none_gauges(self, pkg):
        registry = pkg.metrics.Registry()
        mon = pkg.devicemon.DeviceMonitor(
            registry, census=pkg.devicemon.CompileCensus(VClock()))
        try:
            cpu_snap = registry.snapshot(mergeable=True)
        finally:
            mon.close()
        card_snap = {
            "counters": {}, "latency": {},
            "gauges": {"hbm_bytes_in_use": 2.0e9, "jit_compiles": 3.0},
        }
        merged = pkg.metrics.merge_mergeable_snapshots([cpu_snap, card_snap])
        # The CPU member's None did not poison (or zero) the card's number.
        assert merged["gauges"]["hbm_bytes_in_use"] == 2.0e9
        assert merged["gauges"]["jit_compiles"] == 3.0

    def test_summary_never_raises_without_stats(self, pkg):
        mon = pkg.devicemon.DeviceMonitor(
            None, census=pkg.devicemon.CompileCensus(VClock()))
        try:
            summary = mon.summary()
            assert summary["hbm"]["bytes_in_use"] is None
            assert summary["platform_peak_flops"] > 0
        finally:
            mon.close()


class TestMfuWindow:
    def _monitor(self, pkg, clock):
        mon = pkg.devicemon.DeviceMonitor(
            None, clock=clock, peak_flops=100.0, mfu_window_s=60.0,
            census=pkg.devicemon.CompileCensus(clock),
        )
        mon._flops_per_item["fake"] = 10.0
        return mon

    def test_mfu_is_achieved_over_peak(self, pkg):
        clock = VClock()
        mon = self._monitor(pkg, clock)
        try:
            # 5 items * 10 flops in 1 device-second = 50 FLOP/s vs peak 100.
            mon.device_work("fake", 5, 1.0)
            assert mon.mfu("fake") == pytest.approx(0.5)
            mon.device_work("fake", 5, 1.0)  # same rate: ratio unchanged
            assert mon.mfu("fake") == pytest.approx(0.5)
        finally:
            mon.close()

    def test_window_expiry_returns_none(self, pkg):
        clock = VClock()
        mon = self._monitor(pkg, clock)
        try:
            mon.device_work("fake", 5, 1.0)
            clock.t = 61.0
            assert mon.mfu("fake") is None
        finally:
            mon.close()

    def test_unknown_model_skips_mfu_but_feeds_profiler(self, pkg):
        records = []

        class Profiler:
            def record(self, model, member, lane, seconds, count=1):
                records.append((model, member, lane, seconds, count))

        clock = VClock()
        mon = pkg.devicemon.DeviceMonitor(
            None, profiler=Profiler(), member="m0", clock=clock,
            peak_flops=100.0, census=pkg.devicemon.CompileCensus(clock),
        )
        try:
            mon.device_work("no_such_model_zzz", 4, 0.5)
            assert mon.mfu("no_such_model_zzz") is None
            assert records == [("no_such_model_zzz", "m0", "device", 0.5, 4)]
        finally:
            mon.close()

    def test_zero_items_or_seconds_ignored(self, pkg):
        clock = VClock()
        mon = self._monitor(pkg, clock)
        try:
            mon.device_work("fake", 0, 1.0)
            mon.device_work("fake", 5, 0.0)
            assert mon.mfu("fake") is None
        finally:
            mon.close()

    def test_register_model_exports_resident_and_mfu_gauges(self, pkg):
        clock = VClock()
        registry = pkg.metrics.Registry()
        mon = pkg.devicemon.DeviceMonitor(
            registry, clock=clock, peak_flops=100.0,
            census=pkg.devicemon.CompileCensus(clock),
        )
        mon._flops_per_item["fake"] = 10.0
        try:
            resident = {"value": None}
            mon.register_model("fake", resident_bytes=lambda: resident["value"])
            gauges = registry.snapshot()["gauges"]
            assert gauges["resident_bytes_fake"] is None  # lazy engine unbuilt
            assert gauges["mfu_fake"] is None
            resident["value"] = 12345
            mon.device_work("fake", 10, 1.0)
            gauges = registry.snapshot()["gauges"]
            assert gauges["resident_bytes_fake"] == 12345.0
            assert gauges["mfu_fake"] == pytest.approx(1.0)
            assert mon.resident_bytes_total() == 12345
        finally:
            mon.close()


class TestPytreeNbytes:
    def test_counts_array_leaves(self, pkg):
        tree = {"w": np.zeros((4, 4), np.float32), "b": np.zeros((4,), np.float32)}
        assert pkg.devicemon.pytree_nbytes(tree) == 4 * 4 * 4 + 4 * 4

    def test_none_and_arrayless_leaves_count_zero(self, pkg):
        assert pkg.devicemon.pytree_nbytes(None) == 0
        assert pkg.devicemon.pytree_nbytes({"hp": "adam", "steps": 7}) == 0


class TestFleetScrape:
    """A real 3-node localcluster's fleet scrape carries the devicemon
    gauges after a predict (echo backends: no engine, so the HBM and MFU
    gauges are present and None)."""

    def test_fleet_scrape_carries_device_gauges(self, pkg, tmp_path):
        lc = pkg.localcluster
        nodes = lc.start_local_cluster(tmp_path, n_nodes=3)
        try:
            leader = nodes[0]
            lc.wait_until(
                lambda: leader.tracker.current == leader.self_leader_addr,
                msg="tracker converged on the promoted leader",
            )
            leader.predict()
            lc.wait_until(
                lambda: all(j.done for j in leader.scheduler.jobs.values()),
                msg="predict jobs complete",
            )
            # One compile in the process-global census (the reference makes
            # it with a censused jax.jit; a kernel build is this package's):
            # every co-hosted member's jit_compiles gauge reflects it.
            pkg.devicemon.CENSUS.record("test/fleet_scrape", 0.0)
            assert pkg.devicemon.CENSUS.compiles() > 0

            def scraped():
                good = []
                for addr, reply in leader.fleet_metrics.items():
                    gauges = (reply.get("metrics") or {}).get("gauges", {})
                    if (
                        "hbm_bytes_in_use" in gauges
                        and "hbm_limit_bytes" in gauges
                        and any(k.startswith("mfu_") for k in gauges)
                        and (gauges.get("jit_compiles") or 0) > 0
                    ):
                        good.append(addr)
                return good

            lc.wait_until(
                lambda: len(scraped()) >= 1,
                timeout=30.0,
                msg="devicemon gauges in the leader's fleet scrape",
            )
            # The CLI device verb renders the fleet table from any member.
            table = pkg.cli.Cli(nodes[1]).run_command("device")
            assert "hbm used/limit" in table
            assert "compiles" in table
            for node in nodes:
                assert node.self_member_addr in table
        finally:
            lc.stop_local_cluster(nodes)


# ---------------------------------------------------------------------------
# This package's device reads
# ---------------------------------------------------------------------------


def test_hbm_gauges_never_initialize_cuda(monkeypatch):
    """While CUDA is not initialized the monitor reads no device: none of
    the calls that would initialize it is made, and every HBM gauge and
    the headroom read None."""
    touched = []
    for name in ("memory_stats", "get_device_properties", "current_device", "init"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _n=name, **k: touched.append(_n))
    registry = PORT.metrics.Registry()
    mon = PORT.devicemon.DeviceMonitor(registry, census=PORT.devicemon.CompileCensus(VClock()))
    try:
        gauges = registry.snapshot()["gauges"]
        mon.poll()
        assert [gauges[k] for k in ("hbm_bytes_in_use", "hbm_peak_bytes",
                                    "hbm_limit_bytes")] == [None, None, None]
        assert mon.headroom_bytes() is None
        assert mon.summary()["hbm"]["bytes_limit"] is None
        assert gauges["device_peak_flops"] == PORT.devicemon.PEAK_FLOPS["cpu"]
    finally:
        mon.close()
    assert touched == []
    assert not torch.cuda.is_initialized()


def fake_card(monkeypatch, allocated=3 << 30, peak=5 << 30, total=80 << 30):
    """A card as torch.cuda reports one: initialized, device 0, the caching
    allocator's counters and the device's total memory."""
    class Props:
        total_memory = total

    seen = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: seen.append(i) or {
        "allocated_bytes.all.current": allocated, "allocated_bytes.all.peak": peak,
        "reserved_bytes.all.current": peak + (1 << 20)})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props())
    return seen


def test_hbm_gauges_read_the_caching_allocator(monkeypatch):
    seen = fake_card(monkeypatch)
    registry = PORT.metrics.Registry()
    flight = PORT.flight.FlightRecorder()
    mon = PORT.devicemon.DeviceMonitor(registry, flight=flight, device="cuda:0",
                                       census=PORT.devicemon.CompileCensus(VClock()))
    try:
        gauges = registry.snapshot()["gauges"]
        assert gauges["hbm_bytes_in_use"] == float(3 << 30)
        assert gauges["hbm_peak_bytes"] == float(5 << 30)
        assert gauges["hbm_limit_bytes"] == float(80 << 30)
        assert mon.headroom_bytes() == float((80 - 3) << 30)
        # The H100's dense bf16 peak once CUDA is initialized on a CUDA node.
        assert gauges["device_peak_flops"] == PORT.devicemon.PEAK_FLOPS["gpu"] == 989e12
        mon.poll()  # 3/80 is under the alert fraction
        assert not [e for e in flight.events() if e["kind"] == "hbm_high_watermark"]
    finally:
        mon.close()
    assert set(seen) == {0}


def test_hbm_high_watermark_fires_once_past_the_alert_fraction(monkeypatch):
    fake_card(monkeypatch, allocated=75 << 30, peak=75 << 30)
    flight = PORT.flight.FlightRecorder()
    metrics = PORT.metrics.Counters()
    mon = PORT.devicemon.DeviceMonitor(None, flight=flight, metrics=metrics,
                                       hbm_alert_fraction=0.9,
                                       census=PORT.devicemon.CompileCensus(VClock()))
    try:
        mon.poll()
        mon.poll()  # still past the edge: no second alert
    finally:
        mon.close()
    (alert,) = [e for e in flight.events() if e["kind"] == "hbm_high_watermark"]
    assert alert["bytes_in_use"] == 75 << 30 and alert["bytes_limit"] == 80 << 30
    assert metrics.get("hbm_high_watermark") == 1


def test_cpu_node_reads_no_hbm_on_an_initialized_card(monkeypatch):
    fake_card(monkeypatch)
    registry = PORT.metrics.Registry()
    mon = PORT.devicemon.DeviceMonitor(registry, device="cpu",
                                       census=PORT.devicemon.CompileCensus(VClock()))
    try:
        gauges = registry.snapshot()["gauges"]
        assert gauges["hbm_bytes_in_use"] is None
        assert gauges["device_peak_flops"] == PORT.devicemon.PEAK_FLOPS["cpu"]
    finally:
        mon.close()


def test_state_dict_nbytes():
    model = torch.nn.Linear(4, 3)  # 12 + 3 float32
    assert PORT.devicemon.pytree_nbytes(model.state_dict()) == 15 * 4
    nested = {"a": [torch.zeros(2, dtype=torch.bfloat16)], "b": (np.zeros(3, np.int8),)}
    assert PORT.devicemon.pytree_nbytes(nested) == 2 * 2 + 3


# ---------------------------------------------------------------------------
# The kernel-build census (ops/_build with the compiler stubbed)
# ---------------------------------------------------------------------------


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """ops/_build against a compiler that writes its ``-o`` output and
    nothing else, into a build directory under ``tmp_path``; a fresh census
    on a virtual clock takes the records. Returns (the _build module, the
    census, the clock)."""
    from dmlc_tpu_torch.ops import _build

    compiler = tmp_path / "nvcc"
    compiler.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "if sys.argv[-1].endswith('normalize_u8.cu'):\n"
        "    time.sleep(0.6)  # a slow source, for the per-library walls\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'stub library')\n"
        "print('ptxas info    : stub')\n")
    compiler.chmod(0o755)
    clock = VClock(100.0)
    census = PORT.devicemon.CompileCensus(clock)
    monkeypatch.setattr(_build, "nvcc", lambda: str(compiler))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(PORT.devicemon, "CENSUS", census)
    return _build, census, clock


def test_build_records_each_compiled_library(stub_nvcc):
    _build, census, _ = stub_nvcc
    assert _build.build(["softmax_top1", "normalize_u8"]) > 0
    labels = census.snapshot()["labels"]
    assert sorted(labels) == ["kernel/normalize_u8", "kernel/softmax_top1"]
    for entry in labels.values():
        assert entry["compiles"] == 1 and entry["steady_recompiles"] == 0
        assert entry["seconds"] > 0
    assert census.compiles() == 2


def test_each_library_records_its_own_compile_wall(stub_nvcc):
    """Builds run in parallel: a fast library reaped after a slow one still
    records its own compiler's wall, not the slow one's."""
    _build, census, _ = stub_nvcc
    _build.build(["normalize_u8", "softmax_top1"])  # the slow one first
    labels = census.snapshot()["labels"]
    assert labels["kernel/normalize_u8"]["seconds"] >= 0.6
    assert labels["kernel/softmax_top1"]["seconds"] < 0.6


def test_cached_library_is_not_recorded(stub_nvcc):
    _build, census, _ = stub_nvcc
    _build.build(["softmax_top1"])
    assert _build.build(["softmax_top1"]) == 0.0  # up to date: no compile
    assert census.compiles() == 1


def test_rebuild_after_warmup_is_a_steady_state_recompile(stub_nvcc):
    _build, census, clock = stub_nvcc
    flight = PORT.flight.FlightRecorder()
    metrics = PORT.metrics.Counters()
    registry = PORT.metrics.Registry()
    mon = PORT.devicemon.DeviceMonitor(registry, flight=flight, metrics=metrics,
                                       warmup_s=60.0, census=census, clock=clock)
    try:
        _build.build(["softmax_top1"])
        clock.t += 30.0
        lib = _build.library_path("softmax_top1")
        os.utime(lib, (0, 0))  # older than its source: stale
        _build.build(["softmax_top1"])  # inside the warmup window
        assert census.steady_recompiles() == 0
        clock.t += 61.0
        os.utime(lib, (0, 0))
        _build.build(["softmax_top1"])
        gauges = registry.snapshot()["gauges"]
    finally:
        mon.close()
    assert census.snapshot()["labels"]["kernel/softmax_top1"]["compiles"] == 3
    assert gauges["jit_compiles"] == 3.0 and gauges["jit_steady_recompiles"] == 1.0
    assert gauges["jit_compile_seconds"] > 0
    (event,) = [e for e in flight.events() if e["kind"] == "recompile_steady_state"]
    assert event["program"] == "kernel/softmax_top1"
    assert event["compiles"] == 3 and event["warmup_s"] == 60.0
    assert metrics.get("recompile_steady_state") == 1


def test_failed_build_is_not_recorded(stub_nvcc, tmp_path):
    _build, census, _ = stub_nvcc
    bad = tmp_path / "bad_nvcc"
    bad.write_text("#!/bin/sh\necho 'error: stub refuses' ; exit 2\n")
    bad.chmod(0o755)
    _build.nvcc = lambda: str(bad)  # restored by monkeypatch with the stub
    with pytest.raises(RuntimeError, match="stub refuses"):
        _build.build(["softmax_top1"])
    assert census.compiles() == 0
