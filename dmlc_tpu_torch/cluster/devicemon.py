"""Device-plane telemetry: kernel-build census, HBM accounting, live MFU.

Ported from ``dmlc_tpu/cluster/devicemon.py`` with its class names, gauge
names and flight events, which the fleet merge and the CLI read. What the
card changes:

- **Build census** — this package's engines run eagerly, so nothing is
  jitted; the counterpart of a compile is an ``nvcc`` build of a kernel
  library. ``ops/_build.build`` records each library it compiles in the
  process-global ``CENSUS`` under ``kernel/<name>`` with that build's wall
  seconds; a library loaded from ``_build/`` without a compile is not
  recorded. A label built again AFTER its warmup window is a *steady-state
  recompile* and lands a ``recompile_steady_state`` flight event, as in the
  reference. The gauges keep the reference's ``jit_*`` names. The JAX
  package's ``CensusedJit``, ``hook_jax_monitoring`` and
  ``CompileCensus.note_jax_event`` have no counterpart here: they wrap
  ``jax.jit`` objects and listen to ``jax.monitoring``.
- **HBM accounting** — ``torch.cuda.memory_stats`` of the node's device
  polled into ``hbm_bytes_in_use`` / ``hbm_peak_bytes`` /
  ``hbm_limit_bytes`` gauges (``None`` on the CPU, and while CUDA is not
  initialized), plus resident bytes per loaded model (parameters, buffers,
  KV page pools), with an ``hbm_high_watermark`` flight event at the alert
  fraction.
- **Live MFU** — each dispatch/gen-step reports (items, device-seconds);
  with the registry's analytic ``flops_per_item`` that becomes achieved
  FLOP/s against the per-platform ``PEAK_FLOPS`` roofline, exported as
  per-model ``mfu_<model>`` gauges and folded into CostProfiler lanes.

The census is process-global (kernel libraries are loaded once a process);
co-hosted nodes in the localcluster harness therefore share one census,
exactly like they share the process-global tracer.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Any, Callable

import torch

if TYPE_CHECKING:
    from dmlc_tpu_torch.cluster.flight import FlightRecorder
    from dmlc_tpu_torch.utils.metrics import Metrics, Registry

log = logging.getLogger(__name__)

# Per-device peak dense FLOP/s (bf16) by platform. The GPU row is the H100
# SXM's dense bf16 tensor-core peak, the roofline chip_smoke.py's device
# line scores against; the CPU row is a nominal 1 TFLOP/s so MFU stays a
# meaningful (if generous) ratio in the CPU tests. Override per-node with
# config.devicemon_peak_flops.
PEAK_FLOPS: dict[str, float] = {"gpu": 989e12, "cpu": 1e12}


def pytree_nbytes(tree: Any) -> int:
    """Total bytes of every tensor in a state dict or a nested dict, list or
    tuple (0 for None). Tensors and numpy arrays alike; a leaf without
    ``nbytes`` counts 0 rather than raising. (The reference walks a JAX
    tree; the port's weights are state dicts.)"""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(pytree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_nbytes(v) for v in tree)
    return int(getattr(tree, "nbytes", 0) or 0)


class CompileCensus:
    """Process-global compile ledger: per-program-label compile counts and
    seconds, with steady-state-recompile detection.

    A label's first compile opens its *warmup window* (``warmup_s``).
    Compiles inside the window are expected (cold start, shape discovery);
    a compile AFTER the window means a steady-state program lost its cache
    entry or saw a new shape — the condition analyzer rule A6 hunts
    statically, observed live. Subscribed callbacks (each node's
    DeviceMonitor) fire on that edge."""

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self.warmup_s = 60.0
        self._labels: dict[str, dict[str, float]] = {}
        self._callbacks: list[Callable[[str, int], None]] = []

    def subscribe(self, callback: Callable[[str, int], None]) -> None:
        with self._lock:
            if callback not in self._callbacks:
                self._callbacks.append(callback)

    def unsubscribe(self, callback: Callable[[str, int], None]) -> None:
        with self._lock:
            if callback in self._callbacks:
                self._callbacks.remove(callback)

    def record(self, label: str, seconds: float = 0.0) -> bool:
        """Count one compile under ``label``; returns True when it landed
        after the label's warmup window (a steady-state recompile). The
        seconds are the build's wall (``ops/_build.build``: the nvcc
        process of that library)."""
        now = self._clock()
        with self._lock:
            ent = self._labels.get(label)
            if ent is None:
                ent = {
                    "compiles": 0.0, "seconds": 0.0,
                    "first": now, "steady_recompiles": 0.0,
                }
                self._labels[label] = ent
            ent["compiles"] += 1.0
            ent["seconds"] += max(0.0, float(seconds))
            steady = (now - ent["first"]) > self.warmup_s
            if steady:
                ent["steady_recompiles"] += 1.0
            count = int(ent["compiles"])
            callbacks = list(self._callbacks)
        if steady:
            for cb in callbacks:
                try:
                    cb(label, count)
                except Exception:  # noqa: BLE001 - telemetry must not break dispatch
                    log.exception("steady-recompile callback failed for %s", label)
        return steady

    # ---- reads ----------------------------------------------------------

    def compiles(self) -> int:
        with self._lock:
            return int(sum(e["compiles"] for e in self._labels.values()))

    def compile_seconds(self) -> float:
        with self._lock:
            return float(sum(e["seconds"] for e in self._labels.values()))

    def steady_recompiles(self) -> int:
        with self._lock:
            return int(sum(e["steady_recompiles"] for e in self._labels.values()))

    def snapshot(self) -> dict[str, Any]:
        """Wire/report form: the per-label census."""
        with self._lock:
            labels = {
                label: {
                    "compiles": int(e["compiles"]),
                    "seconds": round(e["seconds"], 6),
                    "steady_recompiles": int(e["steady_recompiles"]),
                }
                for label, e in sorted(self._labels.items())
            }
        return {"labels": labels, "warmup_s": self.warmup_s}

    def reset(self) -> None:
        """Tests only: drop every label."""
        with self._lock:
            self._labels.clear()


CENSUS = CompileCensus()

class DeviceMonitor:
    """One node's device-plane telemetry: registry gauges + flight events.

    Never raises from a gauge read or a poll — on the CPU, and on the card
    until CUDA is initialized, the hbm gauges read None, which the registry
    snapshot carries and the fleet merge drops (docs/OBSERVABILITY.md §2).
    ``device`` is the node's engine device (None: the current CUDA device);
    a CPU device reads no HBM and scores against the CPU roofline."""

    def __init__(
        self,
        registry: Registry | None,
        *,
        flight: FlightRecorder | None = None,
        metrics: Metrics | None = None,
        profiler: Any = None,
        member: str = "",
        clock: Callable[[], float] = time.monotonic,
        warmup_s: float = 60.0,
        hbm_alert_fraction: float = 0.9,
        peak_flops: float = 0.0,
        mfu_window_s: float = 60.0,
        census: CompileCensus | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        self.registry = registry
        self.device = torch.device(device) if device is not None else None
        self.flight = flight
        self.metrics = metrics
        self.profiler = profiler
        self.member = member
        self.clock = clock
        self.hbm_alert_fraction = float(hbm_alert_fraction)
        self.mfu_window_s = float(mfu_window_s)
        self._peak_override = float(peak_flops)
        self._peak: float | None = None  # resolved lazily (CUDA init)
        self.census = census if census is not None else CENSUS
        self.census.warmup_s = float(warmup_s)
        self.census.subscribe(self._on_steady_recompile)
        self._lock = threading.Lock()
        # model -> deque[(t, flops, device_seconds)] inside mfu_window_s
        self._work: dict[str, deque[tuple[float, float, float]]] = {}
        self._flops_per_item: dict[str, float | None] = {}
        self._residents: dict[str, Callable[[], int | None]] = {}
        self._hbm_peak_seen = 0.0
        self._hbm_alerted = False
        if registry is not None:
            registry.gauge("hbm_bytes_in_use", lambda: self._hbm_value("bytes_in_use"))
            registry.gauge("hbm_peak_bytes", lambda: self._hbm_value("peak_bytes_in_use"))
            registry.gauge("hbm_limit_bytes", lambda: self._hbm_value("bytes_limit"))
            registry.gauge("jit_compiles", self.census.compiles)
            registry.gauge("jit_compile_seconds", self.census.compile_seconds)
            registry.gauge("jit_steady_recompiles", self.census.steady_recompiles)
            registry.gauge("device_peak_flops", self.peak_flops)

    def close(self) -> None:
        self.census.unsubscribe(self._on_steady_recompile)

    # ---- compile census -------------------------------------------------

    def _on_steady_recompile(self, label: str, compiles: int) -> None:
        if self.metrics is not None:
            self.metrics.inc("recompile_steady_state")
        if self.flight is not None:
            self.flight.note(
                "recompile_steady_state", program=label, compiles=compiles,
                warmup_s=self.census.warmup_s,
            )

    # ---- HBM accounting -------------------------------------------------

    def _on_card(self) -> bool:
        """True when this node's device is a CUDA device and CUDA is
        already initialized in this process. Reads no device and never
        initializes CUDA (the reference likewise never pays the jax
        import): the gauges come alive once an engine has built."""
        if self.device is not None and self.device.type != "cuda":
            return False
        return torch.cuda.is_initialized()

    def memory_stats(self) -> dict[str, Any] | None:
        """The reference's three ``memory_stats`` keys for this node's CUDA
        device, read from the caching allocator: ``bytes_in_use`` (bytes
        of live tensors), ``peak_bytes_in_use`` (their high-water mark)
        and ``bytes_limit`` (the card's total memory). None on the CPU and
        while CUDA is not initialized. Never raises."""
        if not self._on_card():
            return None
        try:
            index = self.device.index if self.device is not None else None
            if index is None:
                index = torch.cuda.current_device()
            stats = torch.cuda.memory_stats(index)
            return {
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
                "bytes_limit": torch.cuda.get_device_properties(index).total_memory,
            }
        except Exception:  # noqa: BLE001 - telemetry degrades to None, never raises
            return None

    def _hbm_value(self, key: str) -> float | None:
        stats = self.memory_stats()
        if stats is None:
            return None
        value = stats.get(key)
        if value is None and key == "peak_bytes_in_use":
            # A stats source without a peak: fall back to our own polled
            # watermark.
            with self._lock:
                return self._hbm_peak_seen if self._hbm_peak_seen > 0 else None
        return float(value) if value is not None else None

    def headroom_bytes(self) -> float | None:
        """limit - in_use, or None when the device reports no stats."""
        stats = self.memory_stats()
        if stats is None:
            return None
        limit, used = stats.get("bytes_limit"), stats.get("bytes_in_use")
        if limit is None or used is None:
            return None
        return float(limit) - float(used)

    def poll(self) -> None:
        """One watermark/alert pass (the node runs this on its devicemon
        cadence). Tracks the high watermark and stamps an
        ``hbm_high_watermark`` flight event on the alert-fraction edge."""
        stats = self.memory_stats()
        if stats is None:
            return
        used = float(stats.get("bytes_in_use") or 0.0)
        limit = float(stats.get("bytes_limit") or 0.0)
        peak = float(stats.get("peak_bytes_in_use") or used)
        with self._lock:
            self._hbm_peak_seen = max(self._hbm_peak_seen, used, peak)
            fraction = (used / limit) if limit > 0 else 0.0
            fire = fraction >= self.hbm_alert_fraction and not self._hbm_alerted
            if fire:
                self._hbm_alerted = True
            elif fraction < self.hbm_alert_fraction * 0.9:
                self._hbm_alerted = False  # hysteresis: re-arm well below the edge
        if fire:
            if self.metrics is not None:
                self.metrics.inc("hbm_high_watermark")
            if self.flight is not None:
                self.flight.note(
                    "hbm_high_watermark", bytes_in_use=int(used),
                    bytes_limit=int(limit), fraction=round(fraction, 4),
                    threshold=self.hbm_alert_fraction,
                )

    def register_model(
        self, model: str, resident_bytes: Callable[[], int | None] | None = None
    ) -> None:
        """Register one servable model: a ``resident_bytes_<model>`` gauge
        (weights + KV bytes, None until the lazy engine builds)
        and its ``mfu_<model>`` gauge."""
        if resident_bytes is not None:
            self._residents[model] = resident_bytes
            if self.registry is not None:
                self.registry.gauge(
                    f"resident_bytes_{model}",
                    lambda m=model: self._resident_value(m),
                )
        if self.registry is not None:
            self.registry.gauge(f"mfu_{model}", lambda m=model: self.mfu(m))

    def _resident_value(self, model: str) -> float | None:
        fn = self._residents.get(model)
        if fn is None:
            return None
        value = fn()
        return float(value) if value is not None else None

    def resident_bytes_total(self) -> int:
        """Sum of every registered model's known resident bytes."""
        total = 0
        for model in list(self._residents):
            value = self._resident_value(model)
            if value is not None:
                total += int(value)
        return total

    # ---- live MFU -------------------------------------------------------

    def peak_flops(self) -> float:
        """The roofline this node scores against: the configured override,
        else the per-platform table: the GPU row once CUDA is initialized
        on a CUDA node (cached), else the CPU row (not cached, so a node
        resolves the GPU row once its engines initialize CUDA)."""
        if self._peak_override > 0:
            return self._peak_override
        if self._peak is None:
            if not self._on_card():
                return PEAK_FLOPS["cpu"]
            self._peak = PEAK_FLOPS["gpu"]
        return self._peak

    def _item_flops(self, model: str) -> float | None:
        if model not in self._flops_per_item:
            value: float | None = None
            try:
                from dmlc_tpu_torch.models.registry import get_model

                value = get_model(model).flops_per_item()
            except Exception:  # noqa: BLE001 - unknown/unregistered models just skip MFU
                value = None
            self._flops_per_item[model] = value
        return self._flops_per_item[model]

    def device_work(self, model: str, items: int, seconds: float) -> None:
        """One device execution's accounting: ``items`` units (images or
        generated tokens) took ``seconds`` of device wall. This is the
        callback the engines call per dispatch/gen-step; it feeds the MFU
        window and the per-model CostProfiler compute lane."""
        if items <= 0 or seconds <= 0:
            return
        flops = self._item_flops(model)
        now = self.clock()
        if flops is not None:
            with self._lock:
                window = self._work.setdefault(model, deque())
                window.append((now, float(items) * flops, float(seconds)))
                horizon = now - self.mfu_window_s
                while window and window[0][0] < horizon:
                    window.popleft()
        if self.profiler is not None:
            try:
                self.profiler.record(model, self.member, "device", seconds, count=items)
            except Exception:  # noqa: BLE001 - telemetry must not break dispatch
                log.debug("profiler device-lane record failed", exc_info=True)

    def mfu(self, model: str) -> float | None:
        """Model FLOP/s Utilization over the sliding window: achieved
        FLOP/s during device execution divided by the platform roofline.
        None until the model has reported work (or has no analytic
        flops_per_item)."""
        now = self.clock()
        with self._lock:
            window = self._work.get(model)
            if not window:
                return None
            horizon = now - self.mfu_window_s
            while window and window[0][0] < horizon:
                window.popleft()
            flops = sum(f for _, f, _ in window)
            seconds = sum(s for _, _, s in window)
        if seconds <= 0:
            return None
        peak = self.peak_flops()
        if peak <= 0:
            return None
        return (flops / seconds) / peak

    # ---- reporting ------------------------------------------------------

    def summary(self) -> dict[str, Any]:
        """One node's device section (bench/CLI form): census, HBM, MFU."""
        stats = self.memory_stats()
        with self._lock:
            models = sorted(set(self._work) | set(self._residents))
        mfu = {m: self.mfu(m) for m in models}
        residents = {m: self._resident_value(m) for m in sorted(self._residents)}
        return {
            "platform_peak_flops": self.peak_flops(),
            "hbm": {
                "bytes_in_use": stats.get("bytes_in_use") if stats else None,
                "peak_bytes_in_use": (
                    stats.get("peak_bytes_in_use") if stats else None
                ),
                "bytes_limit": stats.get("bytes_limit") if stats else None,
            },
            "resident_bytes": residents,
            "mfu": {m: v for m, v in mfu.items() if v is not None},
            "census": self.census.snapshot(),
        }


__all__ = [
    "CENSUS",
    "CompileCensus",
    "DeviceMonitor",
    "PEAK_FLOPS",
    "pytree_nbytes",
]
