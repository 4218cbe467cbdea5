"""Batched inference engine on one CUDA device.

Port of ``dmlc_tpu/parallel/inference.py``. The unit of work is a shard: a
fixed-size uint8 NHWC image batch that goes to the card as bytes, is
normalized there by the ``normalize_u8`` kernel straight into the model's
compute dtype, runs through the model (bfloat16, ``channels_last``), and a
classifier's logits are read out by the ``softmax_top1`` kernel, so only
two [B] arrays come back to the host. An embedding model
(``classifier=False``, the CLIP encoders) brings its float32 [B, D] output
back instead, and its ``BatchResult`` carries zeros for the top-1 fields,
as the JAX package's does. The kernels are the path: there is no switch to
a plain version, which the kernel wrappers take only for tensors on the
CPU.

Static shapes: partial shards are padded to ``batch_size`` and the pad rows
are dropped on the host.

With ``device_resize_from`` the host stages RAW [B, R, R, 3] uint8 pixels
and the card reaches the model's input size through the two matrix
products of ``ops/device_resize.py``; as in the JAX package, that path
normalizes the resized float32 pixels in plain tensor ops (the
``normalize_u8`` kernel takes uint8) and still reads a classifier out
through ``softmax_top1``.

``run_batch_global`` is the gang's batch over the processes of a
``torch.distributed`` group: each process runs its own share of the rows
on its own engine, and every process then enters one barrier (at world 1,
without a group, it is ``run_batch`` that also takes an empty batch). Not
ported here: the compile census.
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
from dmlc_tpu_torch.models.convert import load_into
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.ops import preprocess as pp
from dmlc_tpu_torch.parallel.mesh import process_index_count
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
    top1_index: np.ndarray      # [N] int32 class indices (zeros for embedding models)
    top1_prob: np.ndarray       # [N] float32 (zeros for embedding models)
    embeddings: np.ndarray | None  # [N, D] float32 for embedding models, else None
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
        device_resize_from: int | None = None,
        device_work=None,
    ):
        self.spec = get_model(model_name)
        self.device = resolve_device(device)
        # Device-plane telemetry hook: called with (model, items, seconds)
        # per device execution. None = off.
        self.device_work = device_work
        self.batch_size = int(batch_size)
        self.dtype = dtype
        # Optional device-side resize (ops/device_resize.py): the host ships
        # raw [B, R, R, 3] uint8 (R = device_resize_from, e.g. the corpus's
        # native size) and the card resizes to the model's input.
        self.device_resize_from = device_resize_from
        model = self.spec.init_params(seed, dtype=dtype)
        model.eval().requires_grad_(False)
        # channels_last: 4-D weights get NHWC strides, the layout the
        # model's permuted NHWC input already has.
        self.model = model.to(device=self.device, memory_format=torch.channels_last)
        if variables is not None:
            self.load_variables(variables)
        self._mean, self._std = pp.stats_for_model(model_name)
        self._mean_t = torch.as_tensor(self._mean, dtype=torch.float32, device=self.device)
        self._std_t = torch.as_tensor(self._std, dtype=torch.float32, device=self.device)
        self._stats = LatencyStats()
        self._cuda = self.device.type == "cuda"
        # Staging ring (CUDA only): pinned host slots, a copy stream so
        # host->device transfers overlap compute, and per-slot events that
        # guard a slot against reuse before its copy has finished.
        self._pinned: list[torch.Tensor] = []
        self._slot_done: list[torch.cuda.Event | None] = [None] * _RING
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        # The device decode's pinned coefficient arena (run_paths), built at
        # its first batch.
        self._jpeg_arena = None
        # Per-stage ingest pipeline counters (INGEST_STAGES): decode records
        # from pool threads too, hence the lock.
        self._ingest_lock = threading.Lock()
        self._ingest = {k: LatencyStats() for k in INGEST_STAGES}

    @property
    def input_size(self) -> int:
        """Host-side staging size: what decoded batches must be shaped as.
        With device resize active this is the RAW size; the model's input
        size is reached on the card."""
        return self.device_resize_from or self.spec.input_size

    # ---- the forward ------------------------------------------------------

    @torch.inference_mode()
    def _forward(self, u8: torch.Tensor):
        """uint8 NHWC on the device -> (top-1 index, top-1 prob) for a
        classifier, the float32 [B, D] output for an embedding model;
        asynchronous on CUDA."""
        resize_from = self.device_resize_from
        if resize_from is not None and resize_from != self.spec.input_size:
            from dmlc_tpu_torch.ops import device_resize

            x = device_resize.resize_batch(u8, self.spec.input_size) / 255.0
            x = ((x - self._mean_t) / self._std_t).to(self.dtype)
        else:
            x = kernels.normalize_u8(u8, self._mean, self._std, self.dtype)
        out = self.model(x)
        return kernels.softmax_top1(out) if self.spec.classifier else out

    def _to_host(self, out):
        if self.spec.classifier:
            return out[0].cpu().numpy(), out[1].cpu().numpy()
        return out.cpu().numpy()

    def _result(self, host, n: int, seconds: float) -> BatchResult:
        """The first ``n`` rows of a host result (``_to_host``'s form) as a
        BatchResult: a classifier's top-1, or an embedding model's output
        beside zero top-1 fields."""
        if self.spec.classifier:
            return BatchResult(host[0][:n], host[1][:n], None, seconds)
        return BatchResult(np.zeros(n, np.int32), np.zeros(n, np.float32), host[:n], seconds)

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
        load_into(self.model, self.spec.name, variables)

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

    def _check_batch(self, n: int) -> None:
        if n == 0:
            raise ValueError("empty batch")
        if n > self.batch_size:
            raise ValueError(f"batch {n} exceeds engine batch_size {self.batch_size}")

    def _run_device(self, u8: torch.Tensor, n: int, span: str = "device/forward",
                    procs: int = 1) -> BatchResult:
        """The forward of one padded uint8 NHWC batch whose first ``n`` rows
        are real, timed up to its host result (a host tensor's copy to the
        device included; with ``procs > 1`` up to the gang's barrier after
        it), with its stats, its span and ``device_work``."""
        t0 = time.perf_counter()
        host = self._to_host(self._forward(u8.to(self.device)))
        if procs > 1:
            import torch.distributed as dist

            dist.barrier()
        dt = time.perf_counter() - t0
        self._stats.record(dt)
        tracer.record(span, dt, model=self.spec.name, batch=int(n))
        if self.device_work is not None:
            self.device_work(self.spec.name, int(n), dt)
        return self._result(host, n, dt)

    def run_batch(self, batch_u8: np.ndarray) -> BatchResult:
        """Classify/embed up to ``batch_size`` images (uint8 NHWC)."""
        n = batch_u8.shape[0]
        self._check_batch(n)
        batch_u8 = self._pad(np.ascontiguousarray(batch_u8, np.uint8))
        return self._run_device(torch.from_numpy(batch_u8), n)

    def run_batch_global(self, local_u8: np.ndarray) -> BatchResult:
        """The gang's batch over the default process group: every process
        calls this with its OWN rows; together they form one global batch of
        ``batch_size`` rows, process 0's first. Each process pads its rows
        to its share, ``batch_size / world`` (so ``batch_size`` must divide
        by the world size), runs them — even an empty shard — and enters a
        barrier with the others, so the gang's ranks finish each batch
        together and a rank that defers an error still releases its peers.
        It gets back the results of the rows IT contributed. At world 1 it
        equals ``run_batch``."""
        _, procs = process_index_count()
        if self.batch_size % procs:
            raise ValueError(f"batch_size {self.batch_size} not divisible by {procs} processes")
        local_cap = self.batch_size // procs
        n = local_u8.shape[0]
        if n > local_cap:
            raise ValueError(f"local batch {n} exceeds per-process share {local_cap}")
        local = np.zeros((local_cap, *local_u8.shape[1:]), np.uint8)
        local[:n] = local_u8
        return self._run_device(torch.from_numpy(local), n, "device/forward_global", procs)

    def run_paths(self, paths: Sequence[str], workers: int | None = None) -> BatchResult:
        """One device batch of image files. A CUDA engine decodes them on
        the card (``_run_paths_device``); a CPU engine decodes and resizes
        on host threads (``load_batch``) and runs ``run_batch``."""
        if self._cuda:
            return self._run_paths_device(paths, workers)
        with tracer.span("host/decode", n=len(paths)):
            batch = pp.load_batch(paths, size=self.input_size, workers=workers)
        return self.run_batch(batch)

    def _run_paths_device(self, paths: Sequence[str], workers: int | None = None) -> BatchResult:
        """``pp.load_batch_device`` straight into the engine's input batch
        on the device (entropy decode on the host into the engine's pinned
        arena, one copy, the ``jpeg_idct`` kernel; spans ``host/decode`` and
        ``device/decode``, which ends when the card has decoded), the pad
        rows zeroed there, then the forward alone under ``device/forward``:
        no host pixel array and no pageable copy."""
        n = len(paths)
        self._check_batch(n)
        if self._jpeg_arena is None:
            from dmlc_tpu_torch.native.jpeg import JpegArena

            self._jpeg_arena = JpegArena(pin=self._cuda)
        size = self.input_size
        u8 = torch.empty((self.batch_size, size, size, 3), dtype=torch.uint8, device=self.device)
        u8[n:].zero_()
        pp.load_batch_device(paths, size, self.device, workers=workers, out=u8[:n],
                             arena=self._jpeg_arena)
        return self._run_device(u8, n)

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

        if self.spec.classifier:
            host = tuple(np.concatenate([o[j][:n] for n, o in outs]) for j in (0, 1))
        else:
            host = np.concatenate([o[:n] for n, o in outs])
        return self._result(host, len(paths), total_dt)

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

