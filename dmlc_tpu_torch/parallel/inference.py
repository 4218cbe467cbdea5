"""Batched inference engine on one CUDA device.

Port of ``dmlc_tpu/parallel/inference.py``. The unit of work is a shard: a
fixed-size uint8 NHWC image batch that goes to the card as bytes, is
normalized there by the ``normalize_u8`` kernel straight into the model's
compute dtype, runs through the model (bfloat16, ``channels_last``), and is
read out by the ``softmax_top1`` kernel, so only two [B] arrays come back
to the host. The kernels are the path: there is no switch to a plain
version, which the kernel wrappers take only for tensors on the CPU.

Static shapes: partial shards are padded to ``batch_size`` and the pad rows
are dropped on the host.

Not ported here: the multi-host ``run_batch_global``, the device-side
resize (``device_resize_from``) and the compile census.
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from dmlc_tpu_torch.models import get_model
from dmlc_tpu_torch.models.convert import variables_from_jax
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.ops import preprocess as pp
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.hotpath import hot_path
from dmlc_tpu_torch.utils.metrics import LatencyStats
from dmlc_tpu_torch.utils.tracing import tracer

# ---- persistent decode-stage pool -----------------------------------------
# Batch-granular decode tasks for run_paths_stream (each task itself fans
# out per image through ops.preprocess's cached pool). Module-level and
# built once, lazily; only needs enough slots to keep ``prefetch`` batches
# decoding concurrently.
_STAGE_POOL: concurrent.futures.ThreadPoolExecutor | None = None
_STAGE_POOL_LOCK = threading.Lock()


def _stage_pool() -> concurrent.futures.ThreadPoolExecutor:
    global _STAGE_POOL
    with _STAGE_POOL_LOCK:
        if _STAGE_POOL is None:
            _STAGE_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=max(2, min(4, os.cpu_count() or 2)),
                thread_name_prefix="ingest-decode",
            )
        return _STAGE_POOL


#: Stage names exported by InferenceEngine.ingest_summary(), in pipeline
#: order. "pipeline" records whole run_paths_stream walls, which is the
#: denominator for per-stage occupancy.
INGEST_STAGES = ("decode", "stage", "dispatch", "sync", "pipeline")

#: Depth of the staging ring: batch i+1 is copied to the card while batch i
#: computes.
_RING = 2


@dataclass
class BatchResult:
    top1_index: np.ndarray      # [N] int32 class indices
    top1_prob: np.ndarray       # [N] float32
    embeddings: np.ndarray | None  # [N, D] for embedding models (None here)
    # Wall seconds behind this result: the device execution for run_batch /
    # run_paths; the WHOLE pipeline (decode || transfer || compute) for
    # run_paths_stream.
    device_seconds: float


class InferenceEngine:
    """One model on one device, one input shape."""

    def __init__(
        self,
        model_name: str,
        device: str | torch.device | None = None,
        variables: Mapping | None = None,
        dtype: torch.dtype = torch.bfloat16,
        batch_size: int = 256,
        seed: int = 0,
        device_work=None,
    ):
        self.spec = get_model(model_name)
        if not self.spec.classifier:
            raise ValueError(f"{model_name!r} is an embedding model; the engine serves classifiers")
        self.device = resolve_device(device)
        # Device-plane telemetry hook: called with (model, items, seconds)
        # per device execution. None = off.
        self.device_work = device_work
        self.batch_size = int(batch_size)
        self.dtype = dtype
        model = self.spec.init_params(seed, dtype=dtype)
        model.eval().requires_grad_(False)
        # channels_last: 4-D weights get NHWC strides, the layout the
        # model's permuted NHWC input already has.
        self.model = model.to(device=self.device, memory_format=torch.channels_last)
        if variables is not None:
            self.load_variables(variables)
        self._mean, self._std = pp.stats_for_model(model_name)
        self._stats = LatencyStats()
        self._cuda = self.device.type == "cuda"
        # Staging ring (CUDA only): pinned host slots, a copy stream so
        # host->device transfers overlap compute, and per-slot events that
        # guard a slot against reuse before its copy has finished.
        self._pinned: list[torch.Tensor] = []
        self._slot_done: list[torch.cuda.Event | None] = [None] * _RING
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        # Per-stage ingest pipeline counters (INGEST_STAGES): decode records
        # from pool threads too, hence the lock.
        self._ingest_lock = threading.Lock()
        self._ingest = {k: LatencyStats() for k in INGEST_STAGES}

    @property
    def input_size(self) -> int:
        """Host-side staging size: what decoded batches must be shaped as."""
        return self.spec.input_size

    # ---- the forward ------------------------------------------------------

    @torch.inference_mode()
    def _forward(self, u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """uint8 NHWC on the device -> (top-1 index, top-1 prob);
        asynchronous on CUDA."""
        x = kernels.normalize_u8(u8, self._mean, self._std, self.dtype)
        return kernels.softmax_top1(self.model(x))

    @staticmethod
    def _to_host(out: tuple[torch.Tensor, torch.Tensor]) -> tuple[np.ndarray, np.ndarray]:
        return out[0].cpu().numpy(), out[1].cpu().numpy()

    def _pad(self, batch_u8: np.ndarray) -> np.ndarray:
        n = batch_u8.shape[0]
        if n < self.batch_size:  # pad to the one input shape
            pad = np.zeros((self.batch_size - n, *batch_u8.shape[1:]), batch_u8.dtype)
            batch_u8 = np.concatenate([batch_u8, pad])
        return batch_u8

    # ---- weights ----------------------------------------------------------

    def load_variables(self, variables: Mapping) -> None:
        """Hot-swap the model weights. ``variables`` is either this
        package's state dict or the JAX package's ``{"params", ...}`` tree
        (numpy leaves), which is carried over by ``variables_from_jax``. Keys
        and shapes must match the model's exactly; the values are copied
        into the resident tensors, so nothing is reallocated."""
        if "params" in variables:
            variables = variables_from_jax(self.spec.name, variables)
        current = self.model.state_dict()
        missing = sorted(set(current) - set(variables))
        extra = sorted(set(variables) - set(current))
        if missing or extra:
            raise ValueError(f"variables mismatch: missing {missing[:8]}, unexpected {extra[:8]}")
        new = {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
               for k, v in variables.items()}
        for key, cur in current.items():
            if tuple(new[key].shape) != tuple(cur.shape):
                raise ValueError(
                    f"shape mismatch at {key}: got {tuple(new[key].shape)}, "
                    f"model has {tuple(cur.shape)}"
                )
        with torch.no_grad():
            for key, cur in current.items():
                cur.copy_(new[key])

    def warmup(self) -> float:
        """First run with a zero batch made on the device (builds the
        kernels, picks cuDNN algorithms); returns its seconds."""
        t0 = time.perf_counter()
        u8 = torch.zeros(
            (self.batch_size, self.input_size, self.input_size, 3),
            dtype=torch.uint8, device=self.device,
        )
        self._to_host(self._forward(u8))
        return time.perf_counter() - t0

    # ---- one batch --------------------------------------------------------

    def run_batch(self, batch_u8: np.ndarray) -> BatchResult:
        """Classify/embed up to ``batch_size`` images (uint8 NHWC)."""
        n = batch_u8.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        if n > self.batch_size:
            raise ValueError(f"batch {n} exceeds engine batch_size {self.batch_size}")
        batch_u8 = self._pad(np.ascontiguousarray(batch_u8, np.uint8))
        t0 = time.perf_counter()
        idx, top = self._to_host(self._forward(torch.from_numpy(batch_u8).to(self.device)))
        dt = time.perf_counter() - t0
        self._stats.record(dt)
        tracer.record("device/forward", dt, model=self.spec.name, batch=int(n))
        if self.device_work is not None:
            self.device_work(self.spec.name, int(n), dt)
        return BatchResult(idx[:n], top[:n], None, dt)

    def run_paths(self, paths: Sequence[str], workers: int | None = None) -> BatchResult:
        """Decode + resize on host threads, then one device batch."""
        with tracer.span("host/decode", n=len(paths)):
            batch = pp.load_batch(paths, size=self.input_size, workers=workers)
        return self.run_batch(batch)

    # ---- the stream pipeline ------------------------------------------------

    def _stage(self, slot: int, batch: np.ndarray):
        """Move one decoded batch toward the device. CUDA: copy it into
        pinned slot ``slot`` (after that slot's previous transfer finished)
        and start a non-blocking transfer on the copy stream; returns the
        device tensor and the event the compute stream must wait for. CPU:
        the batch itself, no event."""
        if not self._cuda:
            return torch.from_numpy(batch), None
        if not self._pinned:
            shape = (self.batch_size, self.input_size, self.input_size, 3)
            self._pinned = [
                torch.empty(shape, dtype=torch.uint8, pin_memory=True) for _ in range(_RING)
            ]
        done = self._slot_done[slot]
        if done is not None:
            done.synchronize()
        host = self._pinned[slot]
        host.numpy()[...] = batch
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        self._slot_done[slot] = ready
        return dev, ready

    @hot_path
    def run_paths_stream(
        self,
        paths: Sequence[str],
        workers: int | None = None,
        prefetch: int = 2,
        decode_source=None,
    ) -> BatchResult:
        """Decode overlapped with host->device transfer and device compute:
        the three-stage ingest pipeline.

        1. **decode** — up to ``prefetch`` batches decode concurrently on the
           persistent stage pool.
        2. **stage** — a two-deep ring of pinned host buffers feeds
           non-blocking copies on a copy stream, so the transfer of batch
           i+1 rides under batch i's compute.
        3. **dispatch/compute** — staged buffers feed the forward (kernels
           and model, asynchronous on the compute stream), and results are
           read back two batches behind.

        Equivalent results to calling ``run_paths`` per batch. Every stage
        records into ingest_summary() and the tracer.

        ``decode_source`` (optional) replaces the local per-batch decode with
        an external producer — ``decode_source(paths_chunk, size) -> uint8
        [n, size, size, 3]`` — which is how the fleet decode tier plugs in;
        only where the pixels come from changes.
        """
        if not paths:
            raise ValueError("empty path list")
        starts = list(range(0, len(paths), self.batch_size))
        prefetch = max(1, int(prefetch))
        pool = _stage_pool()

        def decode(s: int):
            chunk = paths[s : s + self.batch_size]
            t0 = time.perf_counter()
            with tracer.span("host/decode", n=len(chunk)):
                if decode_source is not None:
                    batch = decode_source(chunk, self.input_size)
                else:
                    batch = pp.load_batch(chunk, size=self.input_size, workers=workers)
            batch = self._pad(np.ascontiguousarray(batch, np.uint8))
            self._record_stage("decode", time.perf_counter() - t0, batch=len(chunk))
            return len(chunk), batch

        t_all = time.perf_counter()
        outs: list[tuple[int, Any]] = []
        futs: collections.deque = collections.deque()
        next_i = 0
        while next_i < len(starts) and len(futs) < prefetch:
            futs.append(pool.submit(decode, starts[next_i]))
            next_i += 1
        staged: collections.deque = collections.deque()
        inflight: collections.deque = collections.deque()
        slot = 0
        for _ in starts:
            # Fill the staging ring: block on decode only when the ring is
            # empty; stage a second batch when its decode already finished.
            while futs and len(staged) < _RING and (not staged or futs[0].done()):
                n, batch = futs.popleft().result()
                if next_i < len(starts):
                    futs.append(pool.submit(decode, starts[next_i]))
                    next_i += 1
                t0 = time.perf_counter()
                buf, ready = self._stage(slot, batch)
                slot = (slot + 1) % _RING
                self._record_stage("stage", time.perf_counter() - t0, batch=int(n))
                staged.append((n, buf, ready))
            n, buf, ready = staged.popleft()
            t0 = time.perf_counter()
            if ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                buf.record_stream(stream)  # allocated on the copy stream
            out = self._forward(buf)  # asynchronous on CUDA
            done = None
            if self._cuda:
                done = torch.cuda.Event()
                done.record()
            self._record_stage("dispatch", time.perf_counter() - t0, batch=int(n))
            inflight.append((n, out, done))
            if len(inflight) > 2:  # sync two batches behind
                outs.append(self._materialize(*inflight.popleft()))
        while inflight:
            outs.append(self._materialize(*inflight.popleft()))
        total_dt = time.perf_counter() - t_all
        with self._ingest_lock:
            self._ingest["pipeline"].record(total_dt)
        if self.device_work is not None:
            # Pipeline wall, not isolated device time: a decode-bound
            # pipeline SHOULD read low achieved FLOP/s.
            self.device_work(self.spec.name, len(paths), total_dt)

        idx = np.concatenate([o[0][:n] for n, o in outs])
        top = np.concatenate([o[1][:n] for n, o in outs])
        return BatchResult(idx, top, None, total_dt)

    def _materialize(self, n: int, out, done):
        """Block on one in-flight device result and bring it to the host.
        The recorded span is the SYNC WAIT — time the host stalls for the
        device — not the device's execution time: in a decode-bound pipeline
        it goes to ~0, the signal that the host is the bottleneck."""
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        host = self._to_host(out)
        dt = time.perf_counter() - t0
        with self._ingest_lock:
            self._ingest["sync"].record(dt)
        tracer.record("device/sync_wait", dt, model=self.spec.name, batch=int(n))
        return n, host

    # ---- ingest pipeline observability ---------------------------------

    def _record_stage(self, stage: str, dt: float, **attrs) -> None:
        with self._ingest_lock:
            self._ingest[stage].record(dt)
        tracer.record(f"ingest/{stage}", dt, model=self.spec.name, **attrs)

    def ingest_summary(self) -> dict[str, dict[str, float]]:
        """Per-stage pipeline counters since construction (or the last
        reset): count, total busy seconds, mean, and occupancy — the stage's
        busy time over the summed run_paths_stream wall time."""
        with self._ingest_lock:
            wall = self._ingest["pipeline"]
            wall_total = wall.mean * wall.n if wall.n else 0.0
            out: dict[str, dict[str, float]] = {}
            for name, st in self._ingest.items():
                total = st.mean * st.n if st.n else 0.0
                entry = {
                    "count": float(st.n),
                    "total_s": total,
                    "mean_s": st.mean if st.n else 0.0,
                }
                if name != "pipeline":
                    entry["occupancy"] = total / wall_total if wall_total > 0 else 0.0
                out[name] = entry
            return out

    def reset_ingest_stats(self) -> None:
        with self._ingest_lock:
            self._ingest = {k: LatencyStats() for k in INGEST_STAGES}

    def latency_summary(self) -> dict[str, float]:
        return self._stats.summary()

    def resident_bytes(self) -> int:
        """Device bytes of the model's parameters and buffers (the engine
        keeps no persistent activation state)."""
        return sum(
            t.numel() * t.element_size()
            for t in (*self.model.parameters(), *self.model.buffers())
        )
