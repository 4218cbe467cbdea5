#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dmlc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script exits
non-zero:

1. device  — the card's name, power limit and the TF32 settings in force.
2. build   — compiles every kernel in dmlc_tpu_torch/csrc with nvcc and,
   beside them, the native JPEG decoder (dmlc_tpu_torch/native) with g++
   where the machine has libjpeg (a failed build then fails the run;
   without libjpeg a line says why the decoder is unavailable); for
   each flash kernel instantiation (head dim 64, 128, 192 and 256, the
   forward's also 320, 384, 448 and 512, bf16 and float32), its registers,
   shared memory and spills (ptxas), and for the bf16 Hopper ones their
   wgmma and TMA instructions (SASS); the paged decode and page gather
   kernels' registers and spills, and the bulk gather's shared memory a
   block.
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes its path gives it, with its time, its bound, the plain
   version's time and one library call's (CUDA events, median over
   repeated runs after a warm-up), and each wrapper's host enqueue time
   (host_us); softmax_top1 in float32, bf16 and float16 at the serve
   shape with fixed tie, NaN and infinity rows, in a view one element into
   its storage and at ragged and long rows (softmax_cases), timed in
   float32 and bf16 beside the warp-a-row kernel it replaced and an empty
   kernel; gather_kv_pages's bulk-copy kernel beside the vec16 design it
   replaced, bit-equal to the plain version at both timed shapes (also
   under write pressure) and at its exact cases (pages of more than one
   chunk, ids outside the pool, the byte path); paged_decode_attention at
   lm_wide's and
   the decode bench's geometry, float32 and bf16, head dims 128, 64 and 96,
   also bit-identical run to run and in a contiguous layout, beside the
   parent's path (two page gathers and the eager attention); the public
   flash_attention at head dims 32 and 96 (zero-padded to the kernels' 64
   and 128), 160, 192, 200 and 256 (in both dtypes the three kernels of
   their own at 192 or 256, no wide one) against the plain versions with
   the kernel that ran each head dim, and a sweep of head dims up to 1024
   (past 256 the three kernels of their own in both dtypes); the kernels
   past 256 checked and timed at [4, 4, 1024, 320/384/512] and [8, 2,
   2048, 384], and past 512 at [4, 4, 1024, 640/1024] and [8, 1, 2048,
   768], beside the wide kernels they replaced there and SDPA.
4. serve   — job.predict through a TcpRpcServer on localhost (every
   request from a TcpRpc client) -> PredictWorker -> EngineBackend ->
   InferenceEngine for resnet18 and alexnet at batch 256, 224 px, bf16,
   seeded weights: multi-batch shards take seeded pixels from a decode
   tier, one shard decodes a small JPEG corpus (natively where the decoder
   built, its pixels equal to a direct decode_resize_batch; else PIL).
   Launch counters are zeroed just before the requests and must have
   risen just after; the TCP answers must equal the in-process ones, and
   are held against the same pixels sent through the plain versions. The
   machine's host numbers: the JPEG shard's decode, native against PIL,
   and one 256-image shard over TCP against in process.
   Then CUDA events time each engine's host-to-device copy and forward,
   which bound the device's idle share of run_batch and of one request
   from below; one traced run_batch per model and one traced request give
   the device time by kernel (torch.profiler).
   sdfs    — the weights loop on the port over TCP on localhost: a port
   SdfsLeader and three SdfsMembers (rf 3), one of which also serves
   job.predict and model.load for resnet18 (batch 256, 224 px, bf16) with
   no local corpus (an SdfsImageSource pulls its images from the store).
   The serve phase's JPEG corpus is published into the store and a shard
   of it must answer as the serve phase did from local files; a resnet18
   of another seed is published (publish_weights, about 47 MB) and
   hot-loaded by model.load, after which the shard must answer as an
   engine built from that module, and differently from before; 64
   concurrent single-synset requests through a DynamicBatcher must answer
   as the backend does unbatched, in fewer dispatches. normalize_u8 and
   softmax_top1 must launch. Its line has the blob's bytes, the put and
   get_bytes walls and MB/s, model.load's wall, the cold and warm shard
   walls and the dispatch count.
   cluster — the reference's predict job through the port's own entry
   points: three port ClusterNodes (localcluster) on localhost TCP and UDP,
   each with its own resnet18 and alexnet EngineBackends (batch 256, 224
   px, bf16, seed 0), run both 1000-query jobs (one seeded 256-px JPEG a
   synset, shards of 64) dispatched by the port's JobScheduler. Each job's
   finished must be 1000 and its correct equal to one in-process engine's
   over the same shards; every member must be assigned and serve;
   normalize_u8 and softmax_top1 must launch. Then a second fleet of new
   nodes over the same backends publishes a resnet18 of seed 2, train()
   pulls and hot-loads it on every member, and predict must give the
   correct count of an engine built from that module. Its line has each
   job's wall, images/s, shards and shard p50/p99, the assignments by
   member, and train()'s wall.
5. generate — job.generate for lm_wide through GenerateWorker, served
   from a TcpRpcServer on localhost, to 24 TcpRpc clients (one
   paged_decode_attention launch a layer a step, no gather;
   tokens equal a contiguous-cache engine's; one step's logits paged vs
   contiguous bit-identical and through the kernel vs the plain version);
   decode — the decode-bench geometry through SlotScheduler, with one
   step's device time beside the parent's path's.
6. train — the causal LM of bench.py's train leg (8 layers, hidden 768,
   6 heads x 128, vocab 32768, S 2048, batch 8, bf16 compute, AdamW 3e-4)
   through the flash kernels: the first step against the dense schedule,
   then 10 timed steps (launch counts, falling loss, tokens/s, step p50,
   6ND MFU, one traced step's device time by kernel, idle share);
   train_small — lm_small at its registry width (2 heads of 64) through
   the flash kernels in float32 and then bf16, each with its first step
   against dense, 10 steps, launch counts and a falling loss.
7. trainer — ResNet-18 through TrainingDriver with local checkpoints,
   restored by a second TrainingDriver.
8. the card's name and power limit as nvidia-smi prints them, the kernels
   line, and the final {"ok": true, ...} line.

It needs one CUDA device and exits non-zero, printing no result, without
one or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

BATCH = 256
SIZE = 224
NUM_CLASSES = 1000
# One ulp of the output at |y| < 4 (normalized ImageNet pixels lie in
# [-2.12, 2.64]): the licence for normalize_u8 against its plain version.
NORMALIZE_TOL = {torch.float32: 2.0**-22, torch.bfloat16: 2.0**-6}
# softmax_top1: indices exactly; probabilities sum exp() in another order.
PROB_RTOL = 1e-6
# Rows whose top-two probability gap is at most this are not compared on
# the serving path (bf16 logits can tie there).
GAP = 1e-3
# The kernels each path runs (ops/kernels.KERNELS holds every wrapper).
PREDICT_KERNELS = ("normalize_u8", "softmax_top1")
# Generation phase (lm_wide serving): the JAX worker's defaults.
GEN_SLOTS, GEN_PAGE, GEN_PAGES, GEN_PREFILL = 8, 16, 128, 64
GEN_REQUESTS, GEN_SAMPLED = 24, 4
# Over TCP every poll is a connection and a server thread: 24 clients
# polling every 5 ms starved the decode thread of the GIL until their
# generations ran past the 10 s budget job.generate binds by default. The
# clients poll every 20 ms and give each generation 120 s.
GEN_POLL_S, GEN_BUDGET_S = 0.02, 120.0
# Greedy steps whose top-two logit gap is at most this are counted as ties.
TIE_GAP = 1e-4
# Decode-bench geometry (bench.py:bench_lm_decode and its lm_bench_decode).
BENCH_LAYERS, BENCH_HEADS, BENCH_HIDDEN, BENCH_MLP = 8, 6, 768, 3072
BENCH_VOCAB, BENCH_MAX_LEN = 32768, 1024
BENCH_SLOTS, BENCH_REQUESTS, BENCH_PROMPT, BENCH_NEW, BENCH_PAGE = 8, 16, 128, 128, 64
# LM train leg (bench.py:957-1019): vocab 32768, 8 layers, 6 heads x 128,
# hidden 768, MLP 3072, S = max_len = 2048, batch 8, AdamW at 3e-4.
TRAIN_VOCAB, TRAIN_LAYERS, TRAIN_HEADS, TRAIN_HIDDEN, TRAIN_MLP = 32768, 8, 6, 768, 3072
TRAIN_S, TRAIN_BATCH, TRAIN_LR, TRAIN_STEPS = 2048, 8, 3e-4, 10
TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_HEADS, TRAIN_S, TRAIN_HIDDEN // TRAIN_HEADS)
# The train shape's FLOPs at head dim 64 (12 heads of 64, as ViT-B and
# CLIP B carry them; lm_small has heads of 64 too).
DH64_SHAPE = (TRAIN_BATCH, 12, TRAIN_S, 64)
# The flash forward past the JAX package's K/V-resident limit (its
# streamed schedule): bf16, Dh 128, S 16384.
STREAM_SHAPE = (1, 6, 16384, 128)
# Flash kernels against their plain versions, for each of out, dq, dk and
# dv: the relative L2 error ||got - want|| / ||want|| over the tensor, and
# the largest relative L2 error of one row (one query's out or dq, one
# key's dk or dv) over that row's own norm. The row measure holds late rows
# and tiles, whose values are small beside the first rows', to the same
# limit. A row's error is taken over the larger of its own norm and the
# tensor's RMS row norm (its norm over the square root of its rows): no row
# may carry more error than the tensor limit allows an average row. The
# rounding of a sum taken in another order scales with the operands, whose
# size the RMS row norm gives, not with the row's exact value: on a row
# whose exact value is zero (dq of a causal head's first query, which sees
# only its own key, so dS = p * (dP - delta) = 0) it is all there is, and
# against the earlier floor (1e-2 times the median row norm) it read 5.5e-4
# for a float32 dQ at 5.7e-7 over the tensor. float32 sums in another
# order; bf16 rounds P and dS to bf16 before their products and the
# outputs to bf16. Readings over the checks of flash_checks on an H100 run
# under this floor: bf16 at most 2.71e-3 over a tensor and 5.31e-3 over a
# row, float32 1.59e-6 and 4.67e-6; each fault that
# dmlc_tpu_torch/tools/flash_fault_check.py plants is caught under it
# (PERF.md, section 6, gives each reading beside its limit).
FLASH_REL_L2 = {torch.float32: 2e-5, torch.bfloat16: 4e-3}
FLASH_ROW_REL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}
LSE_TOL = 1e-4  # absolute; lse sums float32 p in both dtypes
# First train step, flash schedule against dense on the same params and
# batch: |loss difference| and per-tensor relative L2 gradient difference.
# Both run bf16 products; they differ in where bf16 rounds (dense rounds
# its attention output once, flash its P and dS tiles). The key
# projection's bias is left out of the relative bound: its exact gradient
# is zero (it adds the same q.b to every score of a query row, which the
# softmax ignores), so both schedules give rounding noise there and their
# ratio means nothing (41 on an H100 run); its norms are reported. The
# query and key projections get their gradient only through dS, which
# flash rounds to bf16 before the dq and dk products while dense keeps it
# in float32; with sum_k dS = 0 on every row those gradients are
# differences of nearly equal terms and the rounding weighs more (on an
# H100 run: 1.3% at block 0 rising to 4.0% at block 7, every other tensor
# at most 1.2%). They are held to DS_GRAD_REL_L2.
DENSE_LOSS_TOL, DENSE_GRAD_REL_L2, DS_GRAD_REL_L2 = 1e-2, 2e-2, 5e-2
ZERO_GRAD_SUFFIX = "attn.key.bias"
DS_GRAD_SUFFIXES = ("attn.query.weight", "attn.query.bias", "attn.key.weight")
# lm_small as the registry builds it (models/lm.py:lm_small: 2 layers,
# hidden 128, 2 heads of 64, MLP 256, vocab 1024), trained at S = its
# max_len (256) with batch 8, AdamW 3e-4, 10 timed steps, float32 (its
# default compute dtype) and then bf16.
SMALL_MODEL, SMALL_BATCH, SMALL_STEPS = "lm_small", 8, 10
# Its float32 first step, flash against dense: both run full float32 (TF32
# off), so they differ only in the order of float32 sums (the online
# softmax, the tiled products): |loss difference| and each gradient's
# relative L2 difference, the query and key projections included.
SMALL_F32_LOSS_TOL, SMALL_F32_GRAD_REL_L2 = 1e-5, 1e-4
# The wrappers of the flash kernels (ops/kernels.KERNELS names).
FLASH_WRAPPERS = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")
# Head dims the Hopper kernels are not built for, run through the public
# flash_attention at [batch, heads, S] = PADDED_BHS: 32 and 96 zero-padded
# to the next of KERNEL_HEAD_DIMS; past 128 (WIDE_HEAD_DIMS) both dtypes
# pad to 192 or 256 (the three kernels built for them; ops/flash.py). In
# (256, 512] both dtypes run at the next of FWD_WIDE_HEAD_DIMS the three
# kernels built for it; past 512 all three run their kernels that take
# the head dim at run time in both dtypes (the three sources). The
# kernels are also timed at [WIDE_TIMED_BHS, Dh] for Dh of
# WIDE_TIMED_HEAD_DIMS, where 160 runs the wide kernels through the
# wrappers, 320, 384 and 512 the kernels built for them, and 640 the
# kernels past 512.
# WIDE_SWEEP_HEAD_DIMS run forward and backward once each, past 512 too,
# causal; those past 256 also not causal.
PADDED_HEAD_DIMS, PADDED_BHS = (32, 96), (2, 3, 193)
WIDE_HEAD_DIMS = (160, 192, 200, 256)
WIDE_TIMED_HEAD_DIMS, WIDE_TIMED_BHS = (160, 192, 256, 320, 384, 512, 640), (4, 4, 1024)
WIDE_SWEEP_HEAD_DIMS = (129, 136, 200, 264, 328, 384, 448, 505, 512, 520, 640, 712, 776, 1024)
WIDE_SWEEP_BHS = (1, 2, 72)
# The LM train leg's FLOPs with wide heads, where the kernels built for
# head dims 256, 192 and (the forward) 384 are checked and timed: hidden
# 768 as 3 heads of 256, 4 of 192 and 2 of 384
# (dmlc_tpu_torch/tools/flash_levers.py).
WIDE256_SHAPE, WIDE192_SHAPE = (8, 3, 2048, 256), (8, 4, 2048, 192)
WIDE384_SHAPE = (8, 2, 2048, 384)
# The kernels past 512 that take the head dim at run time (all three in
# both dtypes): timed at [WIDE_TIMED_BHS, Dh] for Dh 640 and 1024 and at
# the train leg's FLOPs as one head of 768 (XL768_SHAPE), beside the wide
# kernel each replaced there. XL_CHECK_HEAD_DIMS are checked against the
# plain versions at S 193 and 1000, causal and not, in both dtypes: 520,
# 640 and 1024 of the sweep (two chunks of O in bf16 at each, in float32
# at 1024; the float32 dK/dV two at 520 and 640, three at 1024; its dQ two
# at 1024; the bf16 dQ one at 520 and 640, two at 1024, the bf16 dK/dV two
# at 520 and 640, four at 1024), 712 and 776 (in the float32 forward Q
# streamed just past where it stays resident; bf16 streams Q at every
# width; the bf16 dQ two chunks and dK/dV three, the last box partly past
# Dh), and 328 (one chunk of the bf16 forward and dQ, two of its dK/dV,
# through the wrappers: the public functions pad 328 to 384); those past
# 512 also through the public flash_attention (WIDE_SWEEP_HEAD_DIMS).
XL768_SHAPE = (8, 1, 2048, 768)
XL_CHECK_HEAD_DIMS = (328, 520, 640, 712, 776, 1024)
# Every head dim the kernels past 256 take, for the build phase: each
# instantiation is reported with the largest shared memory a block of it
# takes over these.
XL_SWEEP = tuple(dh for dh in range(264, 2049, 8) if dh not in (320, 384, 448, 512))
# The flash kernel sources: each holds a bf16 kernel built on wgmma and TMA
# (csrc/flash_sm90.cuh) and a float32 one, both at every head dim of
# KERNEL_HEAD_DIMS, SM90_WIDE_HEAD_DIMS and FWD_WIDE_HEAD_DIMS
# (ops/flash.py).
SM90_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# Dynamic shared memory a block may take on the H100 (227 KB).
SMEM_PER_BLOCK_MAX = 232448
# ResNet-18 through TrainingDriver: batch, steps, checkpoint interval.
TRAINER_BATCH, TRAINER_STEPS, TRAINER_EVERY = 32, 3, 2
# Published rates of the cards this runs on (NVIDIA data sheets):
# memory bytes/s, float32 (non-tensor) FLOP/s, bf16 dense tensor FLOP/s.
CARDS = {
    "H100 80GB HBM3": (3.35e12, 67e12, 989e12),   # H100 SXM
    "H100 SXM": (3.35e12, 67e12, 989e12),
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H200": (4.8e12, 67e12, 989e12),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_rates(name: str) -> tuple[float, float, float]:
    for key, rates in CARDS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no published rates for {name!r}: add it to CARDS")


def time_ms(fn, reps: int = 21, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    between CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def host_us(fn, calls: int = 2000, batch: int = 100) -> float:
    """The host's time for one call of ``fn``, in microseconds: the median
    over batches of ``batch`` back-to-back calls (time.perf_counter_ns, no
    synchronisation inside a batch) of the batch's mean, after a warm-up.
    The device is synchronised between batches, outside the timed window,
    so the launch queue never fills and a call that launches a kernel
    measures its enqueue, not the kernel."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(max(1, calls // batch)):
        t0 = time.perf_counter_ns()
        for _ in range(batch):
            fn()
        samples.append((time.perf_counter_ns() - t0) / batch / 1e3)
        torch.cuda.synchronize()
    return statistics.median(samples)


def device_records(prof) -> list[tuple[str, float, float]]:
    """(name, start us, duration us) of every device record of a finished
    torch.profiler run, from Kineto's raw results: the FunctionEvent view
    drops some of them (a pageable host-to-device copy, for one). Ranges a
    ``record_function`` marks on the device timeline (``Optimizer.step``)
    span other records and are left out."""
    return [(k.name(), k.start_ns() / 1e3, k.duration_ns() / 1e3)
            for k in prof.profiler.kineto_results.events()
            if k.device_type() == torch.autograd.DeviceType.CUDA and not k.is_user_annotation()]


def profile_call(fn, top: int = 8) -> dict:
    """One traced call of ``fn`` (torch.profiler, CPU and CUDA activity):
    host wall and device time by kernel. The trace can drop a copy's
    record, so its busy time (the union of the recorded intervals) is
    only a lower bound; idle shares come from CUDA events instead
    (``idle_share_at_least``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = device_records(prof)
    if not events:
        raise AssertionError("profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((begin, begin + dur) for _, begin, dur in events):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    by_name: dict[str, list] = {}
    for name, _, dur in events:
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += dur
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {
        "wall_ms": wall_us / 1e3, "traced_busy_ms_lower_bound": busy / 1e3,
        "top": [{"kernel": k[:80], "count": c, "ms": us / 1e3} for k, (c, us) in ranked[:top]],
    }


def kernel_device_ms(fn, name: str | tuple[str, ...], calls: int = 20,
                     flush: torch.Tensor | None = None) -> float:
    """Mean device time of kernel ``name`` over ``calls`` calls of ``fn``,
    from the profiler's kernel records (the host's call overhead excluded);
    for a tuple of names (a call that launches one kernel of each), the sum
    of their means. With ``flush`` (a buffer larger than the 50 MB L2), the
    buffer is overwritten before each call, so the kernel finds its inputs
    cold."""
    names = (name,) if isinstance(name, str) else name
    return sum(kernel_device_ms_each(fn, names, calls, flush).values())


def kernel_device_ms_each(fn, names: tuple[str, ...], calls: int = 20,
                          flush: torch.Tensor | None = None) -> dict[str, float]:
    """kernel_device_ms for a call that launches one kernel of each of
    ``names``: each kernel's mean device time, from one profiler run."""
    from torch.profiler import ProfilerActivity, profile

    # The trace can drop records (device_records); the mean is over those it
    # kept. A trace that kept too few is taken again, twice at most.
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        records = device_records(prof)
        times = {n: [dur for kernel, _, dur in records if n in kernel] for n in names}
        if all(calls // 2 <= len(t) <= calls for t in times.values()):
            return {n: statistics.fmean(t) / 1e3 for n, t in times.items()}
    seen = sorted({kernel[:60] for kernel, _, _ in records})
    raise AssertionError(f"{names}: profiler saw {[len(t) for t in times.values()]} launches of "
                         f"{calls}; records of {seen}")


def queued_us(fn, calls: int = 100, sleep_cycles: int = 20_000_000) -> float:
    """Device time a call of ``fn`` takes back to back with the launch
    queue full, in microseconds: a sleep kernel holds the device while
    ``calls`` calls are enqueued, and events around them time the kernels
    and the gaps between their launches, not the host's enqueue. Raises
    where the enqueue outlasted the sleep."""
    fn()
    torch.cuda.synchronize()
    held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    t0 = time.perf_counter()
    held.record()
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(calls):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    if enqueue_ms >= held.elapsed_time(start):
        raise AssertionError(f"queued_us: the enqueue ({enqueue_ms} ms) outlasted the sleep "
                             f"({held.elapsed_time(start)} ms)")
    return start.elapsed_time(end) / calls * 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw, fp32, bf16 = card_rates(name)
    info = {
        "phase": "device", "kind": name, "count": torch.cuda.device_count(),
        "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "allow_tf32": {"cudnn": False, "matmul": False},
        "mem_bytes_per_s": bw, "fp32_flops_per_s": fp32, "bf16_flops_per_s": bf16,
    }
    emit(info)
    return info


def ptxas_entries(log: str) -> dict[str, dict]:
    """Registers, spill bytes and static shared memory that ptxas reported
    (``-Xptxas -v``) for every kernel in ``log``, keyed by mangled name."""
    entries: dict[str, dict] = {}
    name = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "Function properties for" in ln:
            name = ln.split("Function properties for")[1].strip()
        elif name and "spill stores" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            entries.setdefault(name, {}).update(stack=nums[0], spill_stores=nums[1],
                                                spill_loads=nums[2])
        elif name and "Used" in ln and "registers" in ln:
            smem = re.search(r"(\d+) bytes smem", ln)
            entries.setdefault(name, {}).update(
                registers=int(re.search(r"Used (\d+) registers", ln).group(1)),
                static_smem=int(smem.group(1)) if smem else 0)
    return {n: e for n, e in entries.items() if "registers" in e}


def sass_counts(lib: Path, marker: str) -> dict:
    """How often wgmma (HGMMA) and TMA loads (UTMALDG) occur in the SASS of
    the kernel of ``lib`` whose mangled name holds ``marker`` (cuobjdump
    next to nvcc)."""
    from dmlc_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, inside = {"HGMMA": 0, "UTMALDG": 0}, False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = marker in ln
        elif inside:
            for op in counts:
                counts[op] += op in ln
    return counts


def flash_instance(mangled: str) -> tuple[str, str] | None:
    """(dtype, instantiation) of a flash kernel from its mangled name: the
    Hopper kernels are bf16, the others float32. A kernel built for a head
    dim is ``dh<D>`` (its template argument 64, 128, 192, 256, 320, 384, 448
    or 512); a forward past 256 that takes the head dim at run time
    (``flash_fwd_xl``) is ``xl<W>``, W the boxes of O its widest warpgroup
    or part holds; so are the dQ and dK/dV past 256 (``flash_bwd_dq_xl``,
    ``flash_bwd_dkv_xl``), W the boxes (bf16) or steps (float32) of their
    output the widest warpgroup, chunk or part holds."""
    dtype = "bfloat16" if "_sm90" in mangled else "float32"
    if "_xl_" in mangled:
        return dtype, "xl" + re.search(r"ILi(\d+)EE", mangled).group(1)
    dh = re.search(r"Li(64|128|192|256|320|384|448|512)E", mangled)
    if dh is None:
        return None
    return dtype, f"dh{dh.group(1)}"


def native_toolchain() -> str | None:
    """None when g++ compiles and links a program against libjpeg here
    (the native decoder's needs: jpeglib.h and libjpeg.so); else why not."""
    import shutil

    if shutil.which("g++") is None:
        return "no g++ on PATH"
    with tempfile.TemporaryDirectory(prefix="dmlc-jpeg-probe-") as td:
        done = subprocess.run(
            ["g++", "-x", "c++", "-", "-o", str(Path(td) / "probe"), "-ljpeg"],
            input="#include <cstdio>\n#include <jpeglib.h>\n"
                  "int main() { jpeg_decompress_struct d; (void)d; return 0; }\n",
            capture_output=True, text=True, timeout=120)
    if done.returncode:
        lines = [ln for ln in done.stderr.splitlines()
                 if "error" in ln or "cannot find" in ln] or done.stderr.splitlines()
        return f"g++ cannot build against libjpeg: {lines[0].strip() if lines else done.returncode}"
    return None


def build_native() -> dict:
    """Builds the native JPEG decoder (dmlc_tpu_torch/native) when this
    machine has libjpeg; a failed build there raises. Without libjpeg the
    decoder is unavailable, the reason is printed, and the serving path
    decodes through PIL."""
    from dmlc_tpu_torch import native

    reason = native_toolchain()
    if reason is not None:
        emit({"native_decode": "unavailable on this machine", "reason": reason})
        return {"available": False, "reason": reason, "seconds": None}
    t0 = time.perf_counter()
    native.build()
    seconds = time.perf_counter() - t0
    if not native.available():
        raise AssertionError("the native decoder built but does not load")
    return {"available": True, "reason": None, "seconds": seconds}


def phase_build() -> dict:
    """Builds every kernel, and the native JPEG decoder beside them (its
    build seconds, or why this machine cannot build it; returned). For the
    flash kernels, reports each
    instantiation's registers, shared memory a block and spills (ptxas):
    64, 128, 192, 256, 320, 384, 448 and 512 in both dtypes where
    ops/flash.py routes them to the source (and each instantiation of the
    kernels past 256
    that take the head dim at run time, all three in both dtypes, that
    the head dims of XL_SWEEP pick, with
    the most shared memory one of them takes), the Hopper
    ones also with their wgmma and TMA instructions (SASS). Fails on a
    spill, on a missing instantiation, on a Hopper kernel without wgmma or
    TMA, or on one past SMEM_PER_BLOCK_MAX."""
    from concurrent.futures import ThreadPoolExecutor

    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import flash as FL

    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(build_native)
        seconds = _build.build()
        native = native.result()
    regs = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for name, log in _build.build_log.items()
    }
    flash = {}
    for name in SM90_KERNELS:
        if name not in _build.build_log:  # built before this process: no report
            flash[name] = None
            continue
        lib = _build.load(name)
        smem_of = getattr(lib, f"dmlc_{name}_smem_bytes")
        smem_of.argtypes = [ctypes.c_int, ctypes.c_int]
        # The kernels past 256 that take the head dim at run time: the
        # instantiation each head dim of XL_SWEEP runs with, in each dtype
        # that has one (0: none).
        xl = {}
        width_of = getattr(lib, f"dmlc_{name}_xl_width")
        width_of.argtypes = [ctypes.c_int, ctypes.c_int]
        for dt in ("bfloat16", "float32"):
            for dh in XL_SWEEP:
                width = width_of(dh, int(dt == "bfloat16"))
                if width:
                    xl.setdefault(f"{dt} xl{width}", []).append(dh)
        report = {}
        for mangled, entry in ptxas_entries(_build.build_log[name]).items():
            inst = flash_instance(mangled)
            if inst is None:
                continue
            dtype, label = inst
            bf16 = int(dtype == "bfloat16")
            key = f"{dtype} {label}"
            if label.startswith("xl"):
                dhs = xl.get(key, [])
                widest = max(dhs, key=lambda d: smem_of(d, bf16)) if dhs else 0
                entry["head_dims"] = [dhs[0], dhs[-1]] if dhs else []
                entry["smem_at_head_dim"] = widest
                entry["smem_per_block"] = entry["static_smem"] + (smem_of(widest, bf16)
                                                                  if dhs else 0)
            else:
                entry["smem_per_block"] = entry["static_smem"] + smem_of(int(label[2:]), bf16)
            no_sm90_ops = False
            if dtype == "bfloat16":
                entry["sass"] = sass_counts(_build.library_path(name), mangled)
                no_sm90_ops = not all(entry["sass"].values())
            too_big = entry["smem_per_block"] > SMEM_PER_BLOCK_MAX
            if entry["spill_stores"] or entry["spill_loads"] or no_sm90_ops or too_big:
                raise AssertionError(f"{name} {key}: spills, no wgmma/TMA in its "
                                     f"SASS, or shared memory past {SMEM_PER_BLOCK_MAX}: {entry}")
            report[key] = entry
        want = {f"{dt} dh{dh}" for dt in ("bfloat16", "float32")
                for dh in FL.KERNEL_HEAD_DIMS + FL.SM90_WIDE_HEAD_DIMS + FL.FWD_WIDE_HEAD_DIMS
                if FL._entry_name(name, dh, getattr(torch, dt)) == name} | set(xl)
        if set(report) != want:
            raise AssertionError(f"{name}: instantiations {sorted(report)}, "
                                 f"expected {sorted(want)}")
        flash[name] = report
    # The paged decode kernels run on every decode step: none may spill.
    paged = ptxas_entries(_build.build_log.get("paged_decode", ""))
    spilled = {n: e for n, e in paged.items() if e["spill_stores"] or e["spill_loads"]}
    if spilled:
        raise AssertionError(f"paged_decode spills: {spilled}")
    # The page gather's kernels: none may spill, and the bulk kernel's ring
    # must fit a block.
    gather = ptxas_entries(_build.build_log.get("gather_pages", ""))
    if gather:
        from dmlc_tpu_torch.ops import kernels as K

        ring = int(K._entry("gather_pages_smem_bytes")[1]())
        for mangled, entry in gather.items():
            if "bulk" in mangled:
                entry["smem_per_block"] = entry["static_smem"] + ring
            if entry["spill_stores"] or entry["spill_loads"] or \
                    entry.get("smem_per_block", 0) > SMEM_PER_BLOCK_MAX:
                raise AssertionError(f"gather_pages {mangled}: spills or shared memory past "
                                     f"{SMEM_PER_BLOCK_MAX}: {entry}")
    # softmax_top1's kernels: none may spill.
    softmax = ptxas_entries(_build.build_log.get("softmax_top1", ""))
    spilled = {n: e for n, e in softmax.items() if e["spill_stores"] or e["spill_loads"]}
    if spilled:
        raise AssertionError(f"softmax_top1 spills: {spilled}")
    emit({"phase": "build", "seconds": seconds, "kernels": _build.kernel_names(),
          "native_decode": native, "ptxas": regs, "flash": flash, "paged_decode": paged,
          "gather_pages": gather, "softmax_top1": softmax})
    return native


def phase_kernels(dev: dict) -> dict:
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.ops import preprocess as pp

    bw, fp32 = dev["mem_bytes_per_s"], dev["fp32_flops_per_s"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    mean, std = pp.IMAGENET_MEAN, pp.IMAGENET_STD
    u8 = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                       device="cuda", generator=gen)
    # The one library call that computes the same function:
    # addcmul(bias, u8, scale) promotes u8 to float32 and casts to `out`.
    scale, bias = (torch.from_numpy(a).to("cuda") for a in K.affine_constants(mean, std, 3))
    norm = {}
    for dt in (torch.bfloat16, torch.float32):
        lib_out = torch.empty(u8.shape, dtype=dt, device="cuda")
        got = K.normalize_u8(u8, mean, std, dt)
        want = K.normalize_u8_reference(u8, mean, std, dt)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if err > NORMALIZE_TOL[dt]:
            raise AssertionError(f"normalize_u8 {dt}: max abs err {err} > {NORMALIZE_TOL[dt]}")
        n = u8.numel()
        nbytes = n + n * got.element_size()
        norm[dt] = {
            "max_abs_err": err, "tol": NORMALIZE_TOL[dt],
            "ms": time_ms(lambda dt=dt: K.normalize_u8(u8, mean, std, dt)),
            "host_us": host_us(lambda dt=dt: K.normalize_u8(u8, mean, std, dt), calls=500),
            "device_ms": kernel_device_ms(lambda dt=dt: K.normalize_u8(u8, mean, std, dt),
                                          "normalize_vec_kernel"),
            "plain_ms": time_ms(lambda dt=dt: K.normalize_u8_reference(u8, mean, std, dt)),
            "library_ms": time_ms(lambda o=lib_out: torch.addcmul(bias, u8, scale, out=o)),
            "library_max_abs_err": float((torch.addcmul(bias, u8, scale, out=lib_out).float()
                                          - want.float()).abs().max()),
            "bound_ms": max(nbytes / bw, 2 * n / fp32) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= 2 * n / fp32 else "operations",
        }
    # The scalar path: a ragged tail, and an input that is not 8-byte aligned.
    flat = u8.view(-1)
    for part in (flat[: 3 * 5 * 7 * 3].view(3, 5, 7, 3), flat[1 : 1 + 2 * 9 * 9 * 3].view(2, 9, 9, 3)):
        for dt in (torch.bfloat16, torch.float32):
            if not torch.equal(K.normalize_u8(part, mean, std, dt),
                               K.normalize_u8_reference(part, mean, std, dt)):
                raise AssertionError(f"normalize_u8 {dt} differs on {tuple(part.shape)}")
    del u8, flat

    soft = phase_kernels_softmax(dev)
    gather = phase_kernels_gather(bw)
    paged = phase_kernels_paged(dev)
    flash = phase_kernels_flash(dev)
    result = {"normalize_u8": norm, "softmax_top1": soft, "gather_kv_pages": gather,
              "paged_decode_attention": paged, **flash}
    emit({"phase": "kernels",
          "normalize_u8": {str(k).replace("torch.", ""): v for k, v in norm.items()},
          "softmax_top1": soft, "gather_kv_pages": gather, "paged_decode_attention": paged,
          **flash})
    return result


# softmax_top1's exact cases on the card: the logits dtypes it takes, and
# the columns where its kernel changes path (fewer than one 16-byte vector,
# a ragged tail, the serve shape's 1000 and its neighbours, and 8193 and
# 32768, past the registers of a row group in float32: the chunked loop).
SOFTMAX_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
SOFTMAX_COLS = (1, 3, 31, 33, 999, 1000, 1001, 4099, 8193, 32768)
# The rows softmax_cases fixes at the serve shape, and the index each must
# give: a tie (first wins); a whole row tied; extreme logits; an extreme
# tie; ties in three warps' columns of a 128-thread row group; the maximum
# alone in the last column; NaN first, last and twice in a row; a row of
# all -inf; ties at +inf; ties in two lanes' columns.
SOFTMAX_FIXED = [5, 0, 0, 500, 130, 999, 0, 999, 500, 0, 130, 3]


def softmax_serve_logits(gen: torch.Generator) -> torch.Tensor:
    """[BATCH, NUM_CLASSES] float32 logits with the rows of SOFTMAX_FIXED
    in front."""
    x = torch.randn(BATCH, NUM_CLASSES, device="cuda", generator=gen) * 4
    top = float(x.max()) + 8.0
    x[0, [5, 7]] = x[0].max() + 1.0
    x[1] = 0.25
    x[2, :4] = torch.tensor([1e4, -1e4, 0.0, 9.9e3])
    x[3] = -1e4
    x[3, [500, 999]] = 1e4
    x[4, [130, 600, 999]] = top
    x[5, NUM_CLASSES - 1] = top
    x[6, 0] = x[7, NUM_CLASSES - 1] = float("nan")
    x[8, [500, 501]] = float("nan")
    x[9] = float("-inf")
    x[10, [130, 131, 600, 999]] = float("inf")
    x[11, [3, 4, 64]] = top
    return x


def softmax_cases(gen: torch.Generator) -> list[tuple[str, torch.Tensor, list | None]]:
    """(name, logits, indices its first rows must give) of every exact case
    in each of SOFTMAX_DTYPES: the serve shape with the rows of
    SOFTMAX_FIXED, the same values in a view one element into its storage
    (no row on a 16-byte boundary), and 64 rows at each of SOFTMAX_COLS
    with the maximum tied at a third, a half and the last column in row 0
    and alone in the last column in row 1, at 1001 also in such a view."""
    serve = softmax_serve_logits(gen)
    cases = []
    for dt in SOFTMAX_DTYPES:
        tag = str(dt).replace("torch.", "")
        x = serve.to(dt)
        flat = torch.empty(x.numel() + 1, dtype=dt, device="cuda")
        view = flat[1:].view(x.shape)
        view.copy_(x)
        cases += [(f"{tag} {list(x.shape)}", x, SOFTMAX_FIXED),
                  (f"{tag} {list(x.shape)} offset 1", view, SOFTMAX_FIXED)]
        for cols in SOFTMAX_COLS:
            y = torch.randn(64, cols, device="cuda", generator=gen) * 4
            top = float(y.max()) + 8.0
            y[0, sorted({cols // 3, cols // 2, cols - 1})] = top
            y[1, cols - 1] = top
            want = [min(cols // 3, cols // 2, cols - 1), cols - 1]
            cases.append((f"{tag} [64, {cols}]", y.to(dt), want))
            if cols == 1001:
                flat = torch.empty(y.numel() + 1, dtype=dt, device="cuda")
                flat[1:].view(y.shape).copy_(y)
                cases.append((f"{tag} [64, {cols}] offset 1", flat[1:].view(y.shape), want))
    return cases


def softmax_check(x: torch.Tensor, name: str, want: list | None = None, call=None) -> float:
    """``call`` (softmax_top1) on ``x`` against the plain version: indices
    exactly (and ``want`` in the first rows), probabilities NaN where the
    plain version's are and else within PROB_RTOL. Returns the largest
    relative error; raises AssertionError naming the case."""
    from dmlc_tpu_torch.ops import kernels as K

    idx, prob = (call or K.softmax_top1)(x)
    ridx, rprob = K.softmax_top1_reference(x)
    torch.cuda.synchronize()
    if not torch.equal(idx, ridx):
        rows = (idx != ridx).nonzero().flatten()[:4].tolist()
        raise AssertionError(f"softmax_top1 {name}: indices differ from the plain version at rows "
                             f"{rows}: {idx[rows].tolist()} against {ridx[rows].tolist()}")
    if want is not None and idx[:len(want)].tolist() != want:
        raise AssertionError(f"softmax_top1 {name}: fixed rows gave {idx[:len(want)].tolist()}, "
                             f"expected {want}")
    nan = torch.isnan(rprob)
    if not torch.equal(torch.isnan(prob), nan):
        raise AssertionError(f"softmax_top1 {name}: NaN probabilities differ from the plain version")
    rel = float(((prob - rprob).abs() / rprob)[~nan].max())
    if not rel <= PROB_RTOL:
        raise AssertionError(f"softmax_top1 {name}: probability rel err {rel} > {PROB_RTOL}")
    return rel


def softmax_via(entry: str, logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """softmax_top1's work on float32 logits through one of its timing
    entry points (``softmax_top1_warp``: the warp-a-row design the vector
    kernel replaced; ``softmax_top1_nopdl``: the vector kernel without the
    programmatic launch), with the wrapper's arguments. Not counted: it is
    only checked and timed beside the wrapper."""
    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import kernels as K

    b, c = logits.shape
    idx = logits.new_empty(b, dtype=torch.int32)
    prob = logits.new_empty(b, dtype=torch.float32)
    lib, fn = K._entry(entry)
    _build.check(lib, K._launch(logits, fn, logits.data_ptr(), b, c, idx.data_ptr(),
                                prob.data_ptr()), entry)
    return idx, prob


def launch_floor() -> None:
    """One launch of an empty kernel of one warp on the current stream:
    the device time and the queue slot any launch pays."""
    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import kernels as K

    lib, fn = K._entry("launch_floor")
    _build.check(lib, fn(K._raw_stream(torch.cuda.current_device())), "launch_floor")


def phase_kernels_softmax(dev: dict) -> dict:
    """softmax_top1 on the card: every case of softmax_cases against the
    plain version (and the float32 serve cases through both timing entry
    points, softmax_via), then at the serve shape in float32 and bf16 the
    call, its host enqueue time, the vector kernel's device time beside the
    warp kernel's (on the float32 values) and an empty kernel's in one
    profiler run, each one's time back to back with the queue full
    (queued_us), the plain version, softmax + max, and the bound; last, the
    programmatic launch against the plain one in turns."""
    from dmlc_tpu_torch.ops import kernels as K

    bw, fp32 = dev["mem_bytes_per_s"], dev["fp32_flops_per_s"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = softmax_cases(gen)
    worst = max(softmax_check(x, name, want) for name, x, want in cases)
    for entry in ("softmax_top1_warp", "softmax_top1_nopdl"):
        for name, x, want in cases[:2]:
            softmax_check(x, f"{name} ({entry})", want, lambda v, e=entry: softmax_via(e, v))
    del cases
    x32 = torch.randn(BATCH, NUM_CLASSES, device="cuda", generator=gen) * 4
    report = {"cases": len(SOFTMAX_DTYPES) * (3 + len(SOFTMAX_COLS)), "cases_max_rel_err": worst}
    for dt in (torch.float32, torch.bfloat16):
        x = x32.to(dt)
        xf = x.float()
        rel = softmax_check(x, f"{dt} timed")
        prob, rprob = K.softmax_top1(x)[1], K.softmax_top1_reference(x)[1]
        call = lambda x=x: K.softmax_top1(x)  # noqa: E731
        old = lambda xf=xf: softmax_via("softmax_top1_warp", xf)  # noqa: E731
        each = kernel_device_ms_each(lambda: (call(), old(), launch_floor()),
                                     ("softmax_top1_vec", "softmax_top1_warp", "launch_floor"))
        n = x.numel()
        nbytes = n * x.element_size() + BATCH * 8
        ops = 4 * n  # compare, subtract, exp, add per logit
        report[str(dt).replace("torch.", "")] = {
            "max_abs_err": float((prob - rprob).abs().max()), "max_rel_err": rel, "tol": PROB_RTOL,
            "ms": time_ms(call), "host_us": host_us(call),
            "device_ms": each["softmax_top1_vec"], "warp_device_ms": each["softmax_top1_warp"],
            "floor_device_ms": each["launch_floor"],
            "queued_us": queued_us(call), "warp_queued_us": queued_us(old),
            "floor_queued_us": queued_us(launch_floor), "warp_ms": time_ms(old),
            "plain_ms": time_ms(lambda x=x: K.softmax_top1_reference(x)),
            "library_ms": time_ms(lambda x=x: torch.softmax(x, -1).max(-1)),
            "bound_ms": max(nbytes / bw, ops / fp32) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= ops / fp32 else "operations",
        }
    # The programmatic launch against the same kernel launched plainly, in
    # turns (plain, programmatic, programmatic, plain), each back to back
    # with the queue full: the kernel alone on float32 logits, and the serve
    # path's pair, bf16 logits cast to float32 and then softmax_top1.
    x16 = x32.to(torch.bfloat16)
    runs = {"alone": {"pdl": lambda: K.softmax_top1(x32),
                      "nopdl": lambda: softmax_via("softmax_top1_nopdl", x32)},
            "cast_pair": {"pdl": lambda: K.softmax_top1(x16.float()),
                          "nopdl": lambda: softmax_via("softmax_top1_nopdl", x16.float())}}
    ab: dict = {}
    for what, pair in runs.items():
        ab[what] = {"nopdl": [], "pdl": []}
        for turn in ("nopdl", "pdl", "pdl", "nopdl"):
            ab[what][turn].append(queued_us(pair[turn]))
    report["launch_ab_queued_us"] = ab
    emit({"phase": "kernels_softmax", **report})
    return report


def full_cache_table(slots: int, pages_per_slot: int, usable: int, in_use: int,
                     rng: np.random.Generator) -> np.ndarray:
    """A page table as the engine holds it: each slot's first ``in_use``
    entries are distinct pages drawn from the ``usable`` allocatable ones
    (1..usable), the rest point at the scratch page 0."""
    table = np.zeros((slots, pages_per_slot), np.int32)
    ids = rng.permutation(np.arange(1, usable + 1))[: slots * in_use].astype(np.int32)
    table[:, :in_use] = ids.reshape(slots, in_use)
    return table


def gather_vec16(pool: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """gather_kv_pages's work through the entry point of the design the bulk
    kernel replaced (dmlc_gather_pages_vec16: the 16-byte vector kernel on
    the aligned path), with the wrapper's arguments. Not counted: it is only
    checked and timed beside the bulk kernel."""
    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import kernels as K

    b, max_pages = ids.shape
    _, page_size, heads, head_dim = pool.shape
    out = torch.empty((b, max_pages * page_size, heads, head_dim), dtype=pool.dtype,
                      device=pool.device)
    lib, fn = K._entry("gather_pages_vec16")
    _build.check(lib, K._launch(pool, fn, pool.data_ptr(), pool.shape[0],
                                page_size * heads * head_dim * pool.element_size(),
                                ids.data_ptr(), b * max_pages, out.data_ptr()),
                 "gather_pages_vec16")
    return out


def gather_exact(pool: torch.Tensor, table: np.ndarray, flush: torch.Tensor | None = None) -> None:
    """gather_kv_pages (the bulk kernel on the aligned path, the byte loop
    off it) and the vec16 entry point, each bit-equal to the plain version,
    where an id outside the pool maps to a page of zeros. The block each
    output gets from the allocator is first filled with NaN, so a chunk
    the kernel leaves unwritten cannot pass. With ``flush`` (a buffer
    larger than the L2), each is also called three times under write
    pressure: the L2 first filled with dirty lines and then with the pool,
    so that loads land fast while stores wait on the writes back, which is
    where a stage loaded again before its store has read it shows. Raises
    AssertionError."""
    from dmlc_tpu_torch.ops import ragged_decode as RD

    n = pool.shape[0]
    ids = torch.from_numpy(table).to(pool.device)
    inside = np.where((table < 0) | (table >= n), n, table).astype(np.int32)
    want = RD.gather_kv_pages_reference(torch.cat([pool, torch.zeros_like(pool[:1])]),
                                        torch.from_numpy(inside).to(pool.device))
    for name, fn in (("bulk", RD.gather_kv_pages), ("vec16", gather_vec16)):
        for pressure in [False] + [True] * (3 if flush is not None else 0):
            poison = torch.full(want.shape, float("nan"), dtype=want.dtype, device=want.device)
            del poison
            if pressure:
                flush.zero_()
                pool.sum()
            got = fn(pool, ids)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"gather_kv_pages ({name}{', under write pressure' if pressure else ''}) "
                    f"differs from its plain version on {pool.dtype} {tuple(pool.shape)}, "
                    f"table {tuple(table.shape)}")


# What the kernels line carries of each gather timing.
GATHER_KEYS = ("max_abs_err", "ms", "host_us", "device_ms", "device_ms_cold_l2", "vec16_ms",
               "vec16_device_ms", "vec16_device_ms_cold_l2", "plain_ms", "library_ms",
               "library_host_us", "bound_ms", "bound_by")


def gather_timing(pool: torch.Tensor, table: np.ndarray, bw: float) -> dict:
    """The page gather against its plain version at one shape, with its
    times: the call and its host enqueue time, the bulk kernel's device
    time warm and with a cold L2, the same for the vec16 design it
    replaced (through its own entry point), the plain version and
    index_select. The bound counts what this table needs: each distinct
    page it names read once, the table read once, the output written
    once."""
    from dmlc_tpu_torch.ops import ragged_decode as RD

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=pool.device)
    gather_exact(pool, table, flush)
    ids = torch.from_numpy(table).to(pool.device)
    got = RD.gather_kv_pages(pool, ids)
    page_bytes = pool[0].numel() * pool.element_size()
    nbytes = len(np.unique(table)) * page_bytes + table.nbytes + got.numel() * got.element_size()
    flat = ids.reshape(-1)
    call = lambda: RD.gather_kv_pages(pool, ids)  # noqa: E731
    vec16 = lambda: gather_vec16(pool, ids)  # noqa: E731
    return {
        "pool": list(pool.shape), "table": list(table.shape), "dtype": str(pool.dtype),
        "distinct_pages": int(len(np.unique(table))), "max_abs_err": 0.0,
        "ms": time_ms(call), "host_us": host_us(call),
        "device_ms": kernel_device_ms(call, "gather_pages_bulk_kernel"),
        "device_ms_cold_l2": kernel_device_ms(call, "gather_pages_bulk_kernel", flush=flush),
        "vec16_ms": time_ms(vec16),
        "vec16_device_ms": kernel_device_ms(vec16, "gather_pages_vec16_kernel"),
        "vec16_device_ms_cold_l2": kernel_device_ms(vec16, "gather_pages_vec16_kernel",
                                                    flush=flush),
        "plain_ms": time_ms(lambda: RD.gather_kv_pages_reference(pool, ids)),
        "library_ms": time_ms(lambda: torch.index_select(pool, 0, flat)),
        "library_host_us": host_us(lambda: torch.index_select(pool, 0, flat)),
        "bound_ms": nbytes / bw * 1e3, "bound_by": "bytes",
    }


def gather_shapes(gen: torch.Generator, rng: np.random.Generator) -> dict:
    """The two timed gathers: lm_wide's serving shape (its pool, a full
    engine table of 8 slots x 8 pages) and the decode bench's (128 pages of
    64 x 6 x 128 float32, 8 slots x 16 table columns)."""
    wide_pool = torch.randn(GEN_PAGES, GEN_PAGE, 4, 128, device="cuda", generator=gen)
    wide_table = full_cache_table(GEN_SLOTS, 128 // GEN_PAGE, GEN_PAGES - 1, 128 // GEN_PAGE, rng)
    bench_pages = BENCH_REQUESTS * -(-(BENCH_PROMPT + BENCH_NEW + 1) // BENCH_PAGE) + BENCH_SLOTS + 1
    bench_pool = torch.randn(bench_pages, BENCH_PAGE, BENCH_HEADS, 128, device="cuda",
                             generator=gen)
    in_use = -(-(BENCH_PROMPT + BENCH_NEW) // BENCH_PAGE)
    bench_table = full_cache_table(BENCH_SLOTS, BENCH_MAX_LEN // BENCH_PAGE, bench_pages - 1,
                                   in_use, rng)
    return {"lm_wide": (wide_pool, wide_table), "bench_decode": (bench_pool, bench_table)}


def gather_cases(gen: torch.Generator, wide_pool: torch.Tensor) -> list:
    """The exact cases of phase_kernels_gather beside the two timed shapes:
    bf16, repeated and scratch ids; pages of more than one bulk chunk
    whose length is not a multiple of it (16896 and 49920 bytes against
    16384); 16-byte pages under a 9000-entry table (more items a block than
    one 32-id window); ids outside the pool (-1 and num_pages, which read
    the neighbouring pages of the tensor the pool is a slice of, were they
    read: the expected page is zeros); and the byte path (36-byte pages,
    and a pool 4 bytes off 16-byte alignment)."""
    rng = np.random.default_rng(2)
    repeats = np.array([[3, 3, 0, 0, 7, 127, 0, 3]] * 2 + [[0] * 8], np.int32)
    flat = torch.randn(7 * 3 * 1 * 3 + 1, device="cuda", generator=gen)
    around = torch.randn(GEN_PAGES + 2, GEN_PAGE, 4, 128, device="cuda", generator=gen)
    outside = np.array([[5, -1, 0, GEN_PAGES], [GEN_PAGES, 1, -1, 9]], np.int32)
    return [
        (wide_pool.to(torch.bfloat16), full_cache_table(GEN_SLOTS, 8, GEN_PAGES - 1, 8, rng)),
        (wide_pool.to(torch.bfloat16), repeats),
        (wide_pool, repeats),
        (torch.randn(6, 3, 11, 128, device="cuda", generator=gen),
         np.array([[5, 0, 2], [1, 4, 3]], np.int32)),
        (torch.randn(7, 24, 5, 104, device="cuda", generator=gen),
         rng.integers(0, 7, (3, 5)).astype(np.int32)),
        (torch.randn(64, 1, 1, 4, device="cuda", generator=gen),
         rng.integers(0, 64, (90, 100)).astype(np.int32)),
        (around[1:GEN_PAGES + 1], outside),
        (around.to(torch.bfloat16)[1:GEN_PAGES + 1], outside),
        (flat[:-1].view(7, 3, 1, 3), np.array([[6, 0, 2], [2, 2, 5]], np.int32)),  # 36-byte pages
        (flat[1:].view(7, 3, 1, 3), np.array([[1, 4, 0]], np.int32)),  # pool 4 bytes off 16
    ]


def phase_kernels_gather(bw: float) -> dict:
    """gather_kv_pages on the card: the bulk kernel and the vec16 design it
    replaced, each bit-equal to the plain version (gather_exact) at
    lm_wide's serving shape and at the decode-bench shape (both timed,
    gather_timing, and held under write pressure too) and at each case of
    gather_cases."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(1)
    shapes = gather_shapes(gen, rng)
    report = {name: gather_timing(pool, table, bw) for name, (pool, table) in shapes.items()}
    cases = gather_cases(gen, shapes["lm_wide"][0])
    del shapes
    for pool, table in cases:
        gather_exact(pool, table)
    torch.cuda.synchronize()
    return {**report, "exact_cases": len(cases) + 2}


# The paged decode attention's geometries: (slots, page size, pool pages,
# heads, table columns, pages in use a slot). lm_wide's is the generate
# phase's engine; bench_decode the decode phase's (BENCH_* above).
PAGED_GEOMETRIES = {
    "lm_wide": (GEN_SLOTS, GEN_PAGE, GEN_PAGES, 4, 128 // GEN_PAGE, 128 // GEN_PAGE),
    "bench_decode": (BENCH_SLOTS, BENCH_PAGE,
                     BENCH_REQUESTS * -(-(BENCH_PROMPT + BENCH_NEW + 1) // BENCH_PAGE)
                     + BENCH_SLOTS + 1, BENCH_HEADS, BENCH_MAX_LEN // BENCH_PAGE,
                     -(-(BENCH_PROMPT + BENCH_NEW) // BENCH_PAGE)),
}
# Head dims the paged kernel is held at: the registry LMs' 128 and 64 (its
# instantiations) and 96 (its generic path).
PAGED_HEAD_DIMS = (128, 64, 96)
# The decode phase's one-step state: every slot at this kv length.
PAGED_BENCH_LENGTH = BENCH_PROMPT + BENCH_NEW // 2 + 1
# The paged kernel against its plain version (gather + ragged attention):
# relative L2 error over the output and over its worst row (one slot and
# head), as hold_flash measures them. Both sum float32 products, in
# another order, over at most 256 positions; bf16 then rounds the output
# to bf16 (half an ulp, 2^-9 relative, where the two round apart).
PAGED_REL_L2 = {torch.float32: 2e-6, torch.bfloat16: 4e-3}
PAGED_ROW_REL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# One decode step's logits through the kernel against the same state
# through the plain version (generate phase): relative L2 over [slots,
# vocab], float32. The attention's float32 rounding passes through 2
# layers and the head.
STEP_LOGITS_REL_L2 = 1e-5
# The decode phase on the gather path (two page gathers and the eager
# attention a layer), as PERF.md section 5 records it on an H100 80GB HBM3
# at 700 W: printed beside this run's.
GATHER_PATH_DECODE = {"tokens_per_s": 812.275206034469, "step_ms_p50": 9.03676299999745,
                      "step_ms_p99": 14.016815999994492, "traced_busy_ms": 1.96925}


def paged_inputs(geometry: str, dtype: torch.dtype, dh: int, lengths: np.ndarray | None = None,
                 seed: int = 0) -> dict:
    """q, pools, an engine-like table (``full_cache_table``) and kv lengths
    on the card for ``geometry``, N(0, 1) from ``seed``; by default ragged
    lengths with 1 and a full slot among them."""
    slots, page, pages, heads, cols, in_use = PAGED_GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    full = in_use * page
    if lengths is None:
        lengths = rng.integers(1, full + 1, slots)
        lengths[0], lengths[1] = 1, full
    table = full_cache_table(slots, cols, pages - 1, in_use, rng)
    pool = (pages, page, heads, dh)
    return {
        "q": torch.randn(slots, heads, dh, device="cuda", generator=gen).to(dtype),
        "k": torch.randn(pool, device="cuda", generator=gen).to(dtype),
        "v": torch.randn(pool, device="cuda", generator=gen).to(dtype),
        "table": torch.from_numpy(table).to("cuda"),
        "lengths": torch.from_numpy(np.asarray(lengths, np.int32)).to("cuda"),
    }


def paged_check(case: tuple, dtype: torch.dtype, lengths: np.ndarray | None = None) -> dict:
    """paged_decode_attention at ``case`` = (geometry, head dim) against
    its plain version, within PAGED_REL_L2 and PAGED_ROW_REL; the same call
    again must give the same bits, and so must the same state laid out as
    a contiguous cache of one page a slot (the engine's contiguous mode).
    Raises AssertionError."""
    from dmlc_tpu_torch.ops import ragged_decode as RD

    geometry, dh = case
    x = paged_inputs(geometry, dtype, dh, lengths)
    args = (x["q"], x["k"], x["v"], x["table"], x["lengths"])
    got = RD.paged_decode_attention(*args)
    want = RD.paged_decode_attention_reference(*args)
    again = RD.paged_decode_attention(*args)
    slots = x["q"].shape[0]
    k_rows = RD.gather_kv_pages_reference(x["k"], x["table"])
    v_rows = RD.gather_kv_pages_reference(x["v"], x["table"])
    one_page = torch.arange(slots, dtype=torch.int32, device="cuda").view(-1, 1)
    contiguous = RD.paged_decode_attention(x["q"], k_rows, v_rows, one_page, x["lengths"])
    torch.cuda.synchronize()
    where = f"paged_decode_attention {geometry} Dh {dh} {dtype}"
    if got.dtype != dtype or tuple(got.shape) != tuple(x["q"].shape) or \
            not torch.isfinite(got).all():
        raise AssertionError(f"{where}: {got.dtype} {tuple(got.shape)} or non-finite")
    r = {"max_abs_err": max_abs_err(got, want), **l2_errors(got, want),
         "lengths": x["lengths"].tolist()}
    if r["rel_l2"] > PAGED_REL_L2[dtype] or r["row_rel_max"] > PAGED_ROW_REL[dtype]:
        raise AssertionError(
            f"{where}: relative L2 {r['rel_l2']} (limit {PAGED_REL_L2[dtype]}), worst row "
            f"{r['worst_row']} {r['row_rel_max']} (limit {PAGED_ROW_REL[dtype]})")
    if not torch.equal(got, again):
        raise AssertionError(f"{where}: two calls on the same inputs differ")
    if not torch.equal(got, contiguous):
        raise AssertionError(f"{where}: the contiguous layout gives other bits "
                             f"(max diff {max_abs_err(got, contiguous)})")
    return r


def paged_timing(dev: dict, case: tuple, dtype: torch.dtype, lengths: np.ndarray | None) -> dict:
    """paged_decode_attention at ``case`` with its call and device time
    (both of its kernels), its bound, the plain version's time, the
    parent's path (two gather_kv_pages launches and ragged_decode_attention)
    and, as the library yardstick, F.scaled_dot_product_attention over the
    pre-gathered head-major view with a boolean length mask (timed only:
    the port never calls it). The bound counts the live K and V rows, q,
    the table, the lengths and the output, each once."""
    import torch.nn.functional as F
    from dmlc_tpu_torch.ops import ragged_decode as RD

    geometry, dh = case
    x = paged_inputs(geometry, dtype, dh, lengths, seed=1)
    q, k, v, table, lens = x["q"], x["k"], x["v"], x["table"], x["lengths"]
    args = (q, k, v, table, lens)
    slots, heads, _ = q.shape
    s_max = table.shape[1] * k.shape[1]
    live = int(lens.clamp(max=s_max).sum())
    item = q.element_size()
    nbytes = (2 * live * heads * dh + 2 * q.numel()) * item + table.numel() * 4 + lens.numel() * 4
    ops = 4 * live * heads * dh
    t_bytes, t_ops = nbytes / dev["mem_bytes_per_s"], ops / dev["fp32_flops_per_s"]
    k4 = RD.gather_kv_pages_reference(k, table).transpose(1, 2).contiguous()
    v4 = RD.gather_kv_pages_reference(v, table).transpose(1, 2).contiguous()
    mask = (torch.arange(s_max, device="cuda")[None, :] < lens[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
    got = RD.paged_decode_attention(*args)

    def parent():
        return RD.ragged_decode_attention(q, RD.gather_kv_pages(k, table),
                                          RD.gather_kv_pages(v, table), lens)

    return {
        "geometry": geometry, "head_dim": dh, "dtype": str(dtype).replace("torch.", ""),
        "pool": list(k.shape), "table": list(table.shape), "lengths": lens.tolist(),
        "max_abs_err": max_abs_err(got, RD.paged_decode_attention_reference(*args)),
        "library_max_abs_err": max_abs_err(lib[:, :, 0], got),
        "ms": time_ms(lambda: RD.paged_decode_attention(*args)),
        "host_us": host_us(lambda: RD.paged_decode_attention(*args)),
        "device_ms": kernel_device_ms(lambda: RD.paged_decode_attention(*args),
                                      ("paged_decode", "paged_combine")),
        "plain_ms": time_ms(lambda: RD.paged_decode_attention_reference(*args)),
        "parent_path_ms": time_ms(parent),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                     attn_mask=mask)),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def phase_kernels_paged(dev: dict) -> dict:
    """paged_decode_attention on the card: held against its plain version
    (paged_check) at both geometries, in float32 and bf16, at each of
    PAGED_HEAD_DIMS, at ragged lengths and at the decode phase's one-step
    lengths; then timed at each (paged_timing): lm_wide at ragged lengths,
    the decode bench at PAGED_BENCH_LENGTH."""
    checks, timings = [], {}
    for geometry in PAGED_GEOMETRIES:
        slots = PAGED_GEOMETRIES[geometry][0]
        uniform = np.full(slots, PAGED_BENCH_LENGTH)
        for dh in PAGED_HEAD_DIMS:
            for dt in (torch.float32, torch.bfloat16):
                case = (geometry, dh)
                checks.append({"case": list(case), "dtype": str(dt).replace("torch.", ""),
                               **paged_check(case, dt)})
                if geometry == "bench_decode":
                    checks.append({"case": list(case), "dtype": str(dt).replace("torch.", ""),
                                   **paged_check(case, dt, uniform)})
                timings[f"{geometry}_dh{dh}_{str(dt).replace('torch.', '')}"] = paged_timing(
                    dev, case, dt, uniform if geometry == "bench_decode" else None)
    torch.cuda.synchronize()
    return {"checks": checks, "timings": timings}


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def l2_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The relative L2 error over the whole tensor and the largest one over
    a row (the last axis; the row's norm floored at the tensor's RMS row
    norm), with that row's index."""
    diff, w = got.float() - want.float(), want.float()
    norms = w.norm(dim=-1)
    rms = float(w.norm()) / max(norms.numel(), 1) ** 0.5
    rows = diff.norm(dim=-1) / norms.clamp_min(max(rms, 1e-30))
    worst = np.unravel_index(int(rows.argmax()), tuple(rows.shape))
    return {"rel_l2": float(diff.norm() / w.norm().clamp_min(1e-30)),
            "row_rel_max": float(rows.max()), "worst_row": [int(i) for i in worst]}


def hold_flash(name: str, where: str, got: torch.Tensor, want: torch.Tensor,
               dtype: torch.dtype) -> dict:
    """max_abs_err and l2_errors of ``got`` against its plain version;
    raises on another dtype, a non-finite value, or an error past
    FLASH_REL_L2 or FLASH_ROW_REL."""
    if got.dtype != want.dtype or not torch.isfinite(got).all():
        raise AssertionError(f"flash {name} {where}: dtype {got.dtype} or non-finite")
    r = {"max_abs_err": max_abs_err(got, want), **l2_errors(got, want)}
    if r["rel_l2"] > FLASH_REL_L2[dtype] or r["row_rel_max"] > FLASH_ROW_REL[dtype]:
        raise AssertionError(
            f"flash {name} {where}: relative L2 {r['rel_l2']} (limit {FLASH_REL_L2[dtype]}), "
            f"worst row {r['worst_row']} {r['row_rel_max']} (limit {FLASH_ROW_REL[dtype]})")
    return r


def flash_operands(shape, dtype: torch.dtype, seed: int) -> list[torch.Tensor]:
    """q, k, v, dO as [B*H, S, Dh] on the card, N(0, 1) from ``seed``."""
    b, h, s, dh = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b * h, s, dh, device="cuda", generator=gen).to(dtype) for _ in range(4)]


def flash_check(shape, dtype: torch.dtype, causal: bool, seed: int = 0) -> dict:
    """The three flash kernels against their plain versions on one input:
    the forward's out and lse, then dq and dkv against the kernel's own
    lse and delta = rowsum(dO * out). Raises past FLASH_REL_L2,
    FLASH_ROW_REL or LSE_TOL."""
    from dmlc_tpu_torch.ops import flash as FL

    q, k, v, do = flash_operands(shape, dtype, seed)
    kw = {"causal": causal, "scale": shape[3] ** -0.5}
    out, lse = FL.flash_forward(q, k, v, **kw)
    want_out, want_lse = FL.flash_forward_reference(q, k, v, **kw)
    delta = (out.float() * do.float()).sum(-1, keepdim=True)
    dq = FL.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FL.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    want_dq = FL.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    want_dk, want_dv = FL.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    report = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "causal": causal,
              "lse_max_abs_err": float((lse - want_lse).abs().max())}
    for name, got, want in (("out", out, want_out), ("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        report[name] = hold_flash(name, f"{shape} {dtype} causal={causal}", got, want, dtype)
    if report["lse_max_abs_err"] > LSE_TOL:
        raise AssertionError(f"flash lse {shape} {dtype}: {report['lse_max_abs_err']} > {LSE_TOL}")
    return report


def small_lm_shape() -> tuple:
    """The attention shape [batch, heads, S, Dh] that phase_train_small
    gives the flash kernels: lm_small as the registry builds it, at S = its
    max_len and batch SMALL_BATCH."""
    from dmlc_tpu_torch.models.registry import get_model

    spec = get_model(SMALL_MODEL)
    model = spec.module(dtype=torch.float32)
    return SMALL_BATCH, model.num_heads, spec.input_size, model.hidden // model.num_heads


def flash_checks() -> list[dict]:
    """Every flash kernel against its plain version at both head dims: the
    train shape and its Dh-64 twin in both dtypes, ragged lengths (193,
    1000), causal and not, where the kernels mask a partial tile, the
    shape of phase_train_small in both dtypes, at head dims 256 and
    192 (every kernel built for them, in both dtypes) the train leg's
    FLOPs (WIDE256_SHAPE, WIDE192_SHAPE), [WIDE_TIMED_BHS, Dh]
    and the ragged lengths, in both dtypes, causal and not, and so at the
    kernels built past 256 (WIDE384_SHAPE, [WIDE_TIMED_BHS, Dh] for Dh 320,
    384 and 512, the ragged lengths at each of FWD_WIDE_HEAD_DIMS), all
    three in both dtypes; and the three past 256 that take the head dim at
    run time at the ragged lengths at each of XL_CHECK_HEAD_DIMS, in both
    dtypes, causal and not, and at the timed shapes past 512."""
    from dmlc_tpu_torch.ops import flash as FL

    cases = []
    for big in (TRAIN_SHAPE, DH64_SHAPE):
        cases += [(big, dt, True) for dt in (torch.bfloat16, torch.float32)]
    for dh in (128, 64, 256, 192, *FL.FWD_WIDE_HEAD_DIMS):
        for dt in (torch.bfloat16, torch.float32):
            for causal in (False, True):
                cases += [((2, 3, 193, dh), dt, causal), ((1, 2, 1000, dh), dt, causal)]
    cases += [(small_lm_shape(), dt, True) for dt in (torch.bfloat16, torch.float32)]
    # The kernels built for 192 and 256 and past 256 (bf16 Hopper designs,
    # float32 FMA).
    for shape in (WIDE256_SHAPE, WIDE192_SHAPE, WIDE384_SHAPE,
                  *((*WIDE_TIMED_BHS, dh) for dh in (192, 256, 320, 384, 512))):
        cases += [(shape, dt, causal) for dt in (torch.bfloat16, torch.float32)
                  for causal in (True, False)]
    for dh in XL_CHECK_HEAD_DIMS:
        for dt in (torch.bfloat16, torch.float32):
            for causal in (False, True):
                cases += [((2, 3, 193, dh), dt, causal), ((1, 2, 1000, dh), dt, causal)]
    for shape in ((*WIDE_TIMED_BHS, 640), (*WIDE_TIMED_BHS, 1024), XL768_SHAPE):
        cases += [(shape, dt, True) for dt in (torch.bfloat16, torch.float32)]
    return [flash_check(shape, dt, causal, seed=i) for i, (shape, dt, causal) in enumerate(cases)]


def flash_public_check(dh: int, dtype: torch.dtype, causal: bool, seed: int,
                       bhs: tuple = PADDED_BHS) -> dict:
    """The public flash_attention at head dim ``dh``, which the Hopper
    kernels are not built for, at [batch, heads, S] = ``bhs``: out and the
    q, k and v gradients (autograd through the padded or wide kernels)
    against the plain versions at ``dh`` itself, with the limits of
    flash_check. As there, the plain backward takes the kernels'
    own lse (from flash_attention_with_lse, which must give the same out)
    and delta = rowsum(dO * out) as the kernels got it: summed over the
    padded head dim. (Summed over ``dh`` alone, the float32 sum's other
    order put the dq row of a causal head's first query, whose exact value
    is 0, past FLASH_ROW_REL on an H100 at Dh 96.) Each flash kernel must
    launch once in flash_attention's forward and backward, each through
    the entry point ops/flash._entry_name names for the padded head dim
    in that dtype (which kernel ran: the Hopper design or the wide one)."""
    from dmlc_tpu_torch.ops import flash as FL
    from dmlc_tpu_torch.ops import kernels as K

    b, h, s = bhs
    shape = (b, h, s, dh)
    q, k, v, do = flash_operands(shape, dtype, seed)
    kw = {"causal": causal, "scale": dh ** -0.5}
    q4, k4, v4 = (x.view(shape).clone().requires_grad_() for x in (q, k, v))
    run_dh = FL._run_head_dim(dh)
    dt_name = str(dtype).replace("torch.", "")
    K.reset_launch_counts()
    out = FL.flash_attention(q4, k4, v4, causal=causal)
    out.backward(do.view(shape))
    torch.cuda.synchronize()
    launches = {n: K.launch_counts()[n] for n in FLASH_WRAPPERS}
    by_entry = K.entry_launch_counts()
    entries = {(FL._entry_name(n, run_dh, dtype), run_dh, dtype): 1 for n in SM90_KERNELS}
    if set(launches.values()) != {1} or by_entry != entries:
        raise AssertionError(f"flash_attention Dh {dh} {dtype}: launches {launches} by entry "
                             f"{dict(by_entry)}, expected one of each of {entries}")
    out3 = out.detach().view(b * h, s, dh)
    out_lse, lse = FL.flash_attention_with_lse(q4.detach(), k4.detach(), v4.detach(),
                                               causal=causal)
    lse = lse.view(b * h, s, 1)
    if not torch.equal(out_lse.view(out3.shape), out3):
        raise AssertionError(f"flash_attention_with_lse Dh {dh} {dtype}: another out")
    want_out, want_lse = FL.flash_forward_reference(q, k, v, **kw)
    delta = FL._delta(FL._as_heads(out.detach(), run_dh), FL._as_heads(do.view(shape), run_dh))
    want_dq = FL.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    want_dk, want_dv = FL.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
    report = {"shape": list(shape), "dtype": dt_name, "causal": causal, "run_dh": run_dh,
              "launches": launches, "entries": [e for e, _, _ in entries],
              "lse_max_abs_err": float((lse - want_lse).abs().max())}
    if report["lse_max_abs_err"] > LSE_TOL:
        raise AssertionError(f"flash lse Dh {dh} {dtype}: {report['lse_max_abs_err']} > {LSE_TOL}")
    where = f"{shape} {dtype} causal={causal} through flash_attention"
    for name, got, want in (("out", out3, want_out), ("dq", q4.grad, want_dq),
                            ("dk", k4.grad, want_dk), ("dv", v4.grad, want_dv)):
        report[name] = hold_flash(name, where, got.reshape(want.shape), want, dtype)
    return report


def flash_public_checks() -> dict:
    """flash_public_check at each of PADDED_HEAD_DIMS and WIDE_HEAD_DIMS in
    both dtypes, causal and not, and at each of WIDE_SWEEP_HEAD_DIMS
    (causal, both dtypes; those past 256 also not causal): no head dim
    is refused. In (128, 256] both dtypes must run the three kernels built
    for 192 or 256 (each once, flash_public_check) and no wide one; in
    (256, 512], at the next of FWD_WIDE_HEAD_DIMS, the three built for it
    in both dtypes; past 512 the three's own in both dtypes (the kernels
    that take the head dim at run time)."""
    from dmlc_tpu_torch.ops import flash as FL

    cases = [(dh, dt, causal) for dh in PADDED_HEAD_DIMS + WIDE_HEAD_DIMS
             for dt in (torch.bfloat16, torch.float32) for causal in (False, True)]
    checks = [flash_public_check(*case, seed=100 + i) for i, case in enumerate(cases)]
    sweep_cases = [(dh, dt, True) for dh in WIDE_SWEEP_HEAD_DIMS
                   for dt in (torch.bfloat16, torch.float32)]
    sweep_cases += [(dh, dt, False) for dh in WIDE_SWEEP_HEAD_DIMS if dh > 256
                    for dt in (torch.bfloat16, torch.float32)]
    sweep = [flash_public_check(*case, seed=200 + i, bhs=WIDE_SWEEP_BHS)
             for i, case in enumerate(sweep_cases)]
    for c in checks + sweep:
        dh = c["shape"][3]
        own = c["run_dh"] in FL.SM90_WIDE_HEAD_DIMS and c["entries"] == list(SM90_KERNELS)
        fwd_own = c["run_dh"] in FL.FWD_WIDE_HEAD_DIMS and c["entries"] == list(SM90_KERNELS)
        xl_own = (c["entries"] == list(SM90_KERNELS)
                  and c["run_dh"] not in FL.FWD_WIDE_HEAD_DIMS)
        if ((128 < dh <= 256 and not own) or (256 < dh <= 512 and not fwd_own)
                or (dh > 512 and not xl_own)):
            raise AssertionError(f"flash_attention Dh {dh} {c['dtype']}: ran {c['entries']} "
                                 f"at {c['run_dh']}")
    return {"checks": checks,
            "sweep": [{k: c[k] for k in ("shape", "dtype", "causal", "run_dh", "entries")}
                      | {n: c[n]["rel_l2"] for n in ("out", "dq", "dk", "dv")} for c in sweep]}


def flash_flops(shape, products: int, causal: bool = True) -> float:
    """2 FLOPs per multiply-add over the [S, S] score tiles, half of them
    when causal: ``products`` * 2 * BH * S^2 * Dh (/ 2)."""
    b, h, s, dh = shape
    return products * 2.0 * b * h * s * s * dh / (2 if causal else 1)


def flash_bound(dev: dict, shape, dtype: torch.dtype, products: int, nbytes: int) -> tuple:
    peak = dev["bf16_flops_per_s"] if dtype == torch.bfloat16 else dev["fp32_flops_per_s"]
    t_ops, t_bytes = flash_flops(shape, products) / peak, nbytes / dev["mem_bytes_per_s"]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# Which backend of F.scaled_dot_product_attention ran, by the names of the
# kernels it launched: each name counts for the first of these markers it
# holds (cuDNN's attention kernels hold "flash" too).
SDPA_BACKENDS = (("cudnn", "cudnn"), ("fmha_cutlass", "efficient"),
                 ("efficient_attention", "efficient"), ("flash", "flash"))


def sdpa_backend(fn) -> str:
    """The SDPA backend that one traced call of ``fn`` ran: flash,
    efficient (CUTLASS's memory-efficient kernels), cudnn, or math (the
    composite of GEMMs and a softmax) when no kernel name holds a marker
    of SDPA_BACKENDS."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found = {next((backend for marker, backend in SDPA_BACKENDS if marker in name.lower()), None)
             for name, _, _ in device_records(prof)}
    return "+".join(sorted(found - {None})) or "math"


def flash_forward_timing(dev: dict, shape, dtype: torch.dtype, plain_reps: int,
                         host: bool = False) -> dict:
    """flash_forward at ``shape`` (causal): call and device time, bound,
    plain version, and F.scaled_dot_product_attention(is_causal=True) on
    the same q, k, v as the library's yardstick (never called by the
    port); with ``host``, also the call's host enqueue time."""
    import torch.nn.functional as F
    from dmlc_tpu_torch.ops import flash as FL

    b, h, s, dh = shape
    q, k, v, _ = flash_operands(shape, dtype, seed=11)
    kw = {"causal": True, "scale": dh ** -0.5}
    fwd = FL.flash_forward
    kernel = FL._entry_name("flash_fwd", dh, dtype)
    q4, k4, v4 = (x.view(b, h, s, dh) for x in (q, k, v))
    out, _ = fwd(q, k, v, **kw)
    lib = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    item = q.element_size()
    nbytes = 4 * q.numel() * item + b * h * s * 4  # q, k, v in; out, lse out
    bound_ms, bound_by = flash_bound(dev, shape, dtype, 2, nbytes)
    extra = {"host_us": host_us(lambda: fwd(q, k, v, **kw), calls=200, batch=20)} if host else {}
    return {
        "shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "kernel": kernel,
        **extra,
        "max_abs_err": max_abs_err(out, FL.flash_forward_reference(q, k, v, **kw)[0]),
        "library_max_abs_err": max_abs_err(lib.reshape(out.shape), out),
        "ms": time_ms(lambda: fwd(q, k, v, **kw), reps=11, inner=5),
        "device_ms": kernel_device_ms(lambda: fwd(q, k, v, **kw), kernel, calls=10),
        "plain_ms": time_ms(lambda: FL.flash_forward_reference(q, k, v, **kw),
                            reps=plain_reps, inner=1),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
                              reps=11, inner=5),
        "library_backend": sdpa_backend(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def flash_backward_timing(dev: dict, shape, dtype: torch.dtype, host: bool = False) -> dict:
    """flash_bwd_dq and flash_bwd_dkv at ``shape`` (causal), each with call
    and device time, bound and plain time (with ``host``, also the call's
    host enqueue time); the library yardstick is the autograd backward of
    F.scaled_dot_product_attention(is_causal=True), which computes dq, dk
    and dv together."""
    import torch.nn.functional as F
    from dmlc_tpu_torch.ops import flash as FL

    b, h, s, dh = shape
    q, k, v, do = flash_operands(shape, dtype, seed=12)
    kw = {"causal": True, "scale": dh ** -0.5}
    out, lse = FL.flash_forward(q, k, v, **kw)
    delta = (out.float() * do.float()).sum(-1, keepdim=True)
    q4, k4, v4 = (x.view(b, h, s, dh).detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    g4 = do.view(b, h, s, dh)
    library_ms = time_ms(lambda: torch.autograd.grad(lib_out, (q4, k4, v4), g4, retain_graph=True),
                         reps=11, inner=5)
    library_backend = sdpa_backend(
        lambda: torch.autograd.grad(lib_out, (q4, k4, v4), g4, retain_graph=True))
    item = q.element_size()
    rows = b * h * s * 4 * 2  # lse and delta
    report = {}
    for name, fn, ref, products, outs in (
        ("flash_bwd_dq", FL.flash_bwd_dq, FL.flash_bwd_dq_reference, 3, 1),
        ("flash_bwd_dkv", FL.flash_bwd_dkv, FL.flash_bwd_dkv_reference, 4, 2),
    ):
        kernel = FL._entry_name(name, dh, dtype)
        args = (q, k, v, do, lse, delta)
        got, want = fn(*args, **kw), ref(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        nbytes = (4 + outs) * q.numel() * item + rows
        bound_ms, bound_by = flash_bound(dev, shape, dtype, products, nbytes)
        report[name] = {
            "shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "kernel": kernel,
            **({"host_us": host_us(lambda fn=fn: fn(*args, **kw), calls=200, batch=20)}
               if host else {}),
            "max_abs_err": max(max_abs_err(g, w) for g, w in zip(got, want)),
            "ms": time_ms(lambda fn=fn: fn(*args, **kw), reps=11, inner=5),
            "device_ms": kernel_device_ms(lambda fn=fn: fn(*args, **kw), kernel, calls=10),
            "plain_ms": time_ms(lambda ref=ref: ref(*args, **kw), reps=5, inner=1),
            "library_ms": library_ms, "library_computes": "dq, dk and dv together",
            "library_backend": library_backend,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    return report


def launch_wide(entry: str, q, k, v, do, lse, delta) -> None:
    """One launch of wide kernel ``entry`` (csrc/flash_wide.cu) through its
    own entry point, whatever the wrappers pick for the head dim: the FMA
    kernel that a kernel built for a head dim replaced there."""
    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import kernels as K

    bh, s, dh = q.shape
    o, o2 = torch.empty_like(q), torch.empty_like(q)
    lse_out = torch.empty(bh, s, 1, dtype=torch.float32, device=q.device)
    ptrs = {"flash_wide_fwd": (q, k, v, o, lse_out),
            "flash_wide_bwd_dq": (q, k, v, do, lse, delta, o),
            "flash_wide_bwd_dkv": (q, k, v, do, lse, delta, o, o2)}[entry]
    lib, fn = K._entry(entry)
    _build.check(lib, K._launch(q, fn, *(x.data_ptr() for x in ptrs), bh, s, dh, 1,
                                dh ** -0.5, int(q.dtype == torch.bfloat16)), entry)


# The wide kernels that the kernels built for head dims 256 and 192, and
# those past 256, replaced there, timed through their entry points: key of
# WIDE_TIMINGS or XL_TIMINGS -> [(entry point, products), ...]. At 256 and
# 192 (the train leg's FLOPs) bf16 the dQ's, float32 all three; at 320,
# 384 and 512 (and the train leg's FLOPs at 384), and past 512, all three
# in both dtypes.
_ALL_REPLACED = [("flash_wide_fwd", 2), ("flash_wide_bwd_dq", 3), ("flash_wide_bwd_dkv", 4)]
REPLACED_WIDE = {"w256_bf16": [("flash_wide_bwd_dq", 3)], "w192_bf16": [("flash_wide_bwd_dq", 3)],
                 "w256_f32": _ALL_REPLACED, "w192_f32": _ALL_REPLACED,
                 **{f"{key}_{tag}": _ALL_REPLACED for key in ("dh320", "dh384", "dh512", "w384")
                    for tag in ("bf16", "f32")},
                 **{f"{key}_{tag}": _ALL_REPLACED for key in ("dh640", "dh1024", "w768")
                    for tag in ("bf16", "f32")}}


# The wide timings of phase_kernels_flash, through the wrappers: key ->
# (shape, dtype). [WIDE_TIMED_BHS, Dh] at each of WIDE_TIMED_HEAD_DIMS and
# the train leg's FLOPs at 256, 192 and 384 (w256, w192, w384), in both
# dtypes. The three kernels run their own designs at 192, 256, 320, 384
# and 512 (the Hopper ones in bf16, FMA in float32) and the wide kernels at
# 160; at 640 the kernels past 512.
WIDE_TIMINGS = {
    **{f"dh{dh}_{tag}": ((*WIDE_TIMED_BHS, dh), dt) for dh in WIDE_TIMED_HEAD_DIMS
       for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))},
    **{f"w{shape[3]}_{tag}": (shape, dt) for shape in (WIDE256_SHAPE, WIDE192_SHAPE, WIDE384_SHAPE)
       for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))},
}
# The kernels past 512 at [WIDE_TIMED_BHS, 1024] and XL768_SHAPE, all
# three in both dtypes.
XL_TIMINGS = {
    **{f"dh1024_{tag}": ((*WIDE_TIMED_BHS, 1024), dt)
       for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))},
    **{f"w768_{tag}": (XL768_SHAPE, dt)
       for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))},
}


def phase_kernels_flash(dev: dict) -> dict:
    """The flash kernels on the card: checked against their plain versions
    (flash_checks), the public flash_attention at head dims the Hopper
    kernels are not built for (flash_public_checks), then timed at the
    train shape and at its Dh-64 twin (forward and backward, bf16 and
    float32), at the streamed-forward shape (bf16), past Dh 128 at each
    shape of WIDE_TIMINGS and XL_TIMINGS, and the wide kernels of
    REPLACED_WIDE at their shapes through their own entry points."""
    from dmlc_tpu_torch.ops import flash as FL

    checks = flash_checks()
    public = flash_public_checks()
    fwd = {
        "train_bf16": flash_forward_timing(dev, TRAIN_SHAPE, torch.bfloat16, plain_reps=5,
                                           host=True),
        "train_f32": flash_forward_timing(dev, TRAIN_SHAPE, torch.float32, plain_reps=5,
                                          host=True),
        "dh64_bf16": flash_forward_timing(dev, DH64_SHAPE, torch.bfloat16, plain_reps=3),
        "dh64_f32": flash_forward_timing(dev, DH64_SHAPE, torch.float32, plain_reps=3),
        "stream_bf16": flash_forward_timing(dev, STREAM_SHAPE, torch.bfloat16, plain_reps=3),
    }
    for key, (shape, dt) in {**WIDE_TIMINGS, **XL_TIMINGS}.items():
        fwd[key] = flash_forward_timing(dev, shape, dt, plain_reps=3)
    for entry in fwd.values():
        entry["tflops"] = flash_flops(entry["shape"], 2) / (entry["device_ms"] * 1e-3) / 1e12
    bwd = {key: flash_backward_timing(dev, shape, dt, host=key.startswith("train"))
           for key, (shape, dt) in {
               "train_bf16": (TRAIN_SHAPE, torch.bfloat16),
               "train_f32": (TRAIN_SHAPE, torch.float32),
               "dh64_bf16": (DH64_SHAPE, torch.bfloat16),
               "dh64_f32": (DH64_SHAPE, torch.float32), **WIDE_TIMINGS,
               **XL_TIMINGS}.items()}
    for report in bwd.values():
        for name, products in (("flash_bwd_dq", 3), ("flash_bwd_dkv", 4)):
            device_s = report[name]["device_ms"] * 1e-3
            report[name]["tflops"] = flash_flops(report[name]["shape"], products) / device_s / 1e12
    replaced = {}
    for key, entries in REPLACED_WIDE.items():
        shape, dt = {**WIDE_TIMINGS, **XL_TIMINGS}[key]
        q, k, v, do = flash_operands(shape, dt, seed=12)
        kw = {"causal": True, "scale": shape[3] ** -0.5}
        out, lse = FL.flash_forward(q, k, v, **kw)
        delta = FL._delta(out, do)
        replaced[key] = {}
        for entry, products in entries:
            ms = kernel_device_ms(lambda entry=entry: launch_wide(entry, q, k, v, do, lse, delta),
                                  entry, calls=5)
            replaced[key][entry] = {"entry": entry, "shape": list(shape), "device_ms": ms,
                                    "tflops": flash_flops(shape, products) / (ms * 1e-3) / 1e12}
    torch.cuda.synchronize()
    return {"checks": checks, "padded_head_dims": public, "flash_forward": fwd,
            "replaced_wide": replaced,
            **bwd["train_bf16"], "backward_f32": bwd["train_f32"],
            **{f"backward_{key}": report for key, report in bwd.items()
               if key not in ("train_bf16", "train_f32")}}


class SeededImages:
    """Stands in for the fleet decode tier and the SDFS image source:
    synset ids ``seed_<k>`` map to paths named after them, and
    ``decode_paths`` makes each one's pixels from its seed (a coarse 8x8
    colour field plus noise). Corpus synsets map to their JPEG files."""

    def __init__(self, data_dir: Path):
        self.data_dir = data_dir

    def __call__(self, synsets):
        from dmlc_tpu_torch.ops import preprocess as pp

        return [s if s.startswith("seed_") else pp.class_image_path(self.data_dir, s)
                for s in synsets]

    def decode_paths(self, paths, size):
        out = np.empty((len(paths), size, size, 3), np.uint8)
        for i, p in enumerate(paths):
            rng = np.random.default_rng(int(str(p).split("_")[1]))
            coarse = rng.integers(0, 256, (8, 8, 3), np.uint8)
            field = np.repeat(np.repeat(coarse, -(-size // 8), 0), -(-size // 8), 1)[:size, :size]
            out[i] = field // 2 + rng.integers(0, 128, (size, size, 3), np.uint8)
        return out


def plain_top1(engine, u8: np.ndarray):
    """The same pixels through the plain versions on the card:
    normalize_u8_reference -> model -> softmax_top1_reference, plus each
    row's top-two probability gap."""
    from dmlc_tpu_torch.ops import kernels as K

    idx, gaps = [], []
    with torch.inference_mode():
        for s in range(0, len(u8), engine.batch_size):
            x = torch.from_numpy(u8[s:s + engine.batch_size]).to(engine.device)
            x = K.normalize_u8_reference(x, engine._mean, engine._std, engine.dtype)
            logits = engine.model(x)
            i, _ = K.softmax_top1_reference(logits)
            top2 = torch.softmax(logits, -1).topk(2, dim=-1).values
            idx.append(i.cpu().numpy())
            gaps.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
    return np.concatenate(idx), np.concatenate(gaps)


class NativeRecorder:
    """Wraps ``native.decode_resize_batch`` while installed: each call's
    paths, pixels and status, so the serving path's own decode can be held
    against a direct call."""

    def __init__(self, native):
        self.native = native
        self.real = native.decode_resize_batch
        self.calls: list[tuple[list, np.ndarray, np.ndarray]] = []

    def __call__(self, paths, *args, **kw):
        out, status = self.real(paths, *args, **kw)
        self.calls.append((list(paths), out.copy(), status.copy()))
        return out, status

    def __enter__(self):
        self.native.decode_resize_batch = self
        return self

    def __exit__(self, *exc):
        self.native.decode_resize_batch = self.real


def timed(fn) -> float:
    """Seconds one call of ``fn`` takes on the host's clock."""
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def alternate_ms(fns: dict, rounds: int = 4) -> tuple[dict, dict]:
    """Median wall ms of each callable, and every reading, run in turns
    a, b, b, a (rounds times) in this process."""
    names = list(fns)
    walls: dict[str, list[float]] = {n: [] for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            walls[n].append(1e3 * timed(fns[n]))
    return {n: statistics.median(w) for n, w in walls.items()}, walls


def phase_serve(dev: dict, native_build: dict) -> dict:
    """job.predict served from a TcpRpcServer on localhost: every request
    goes through a TcpRpc client and must equal the in-process methods()
    answer for the same shard exactly, and the plain path's under the gap
    rule. The JPEG shard is decoded by the native library where this
    machine could build it (its pixels equal a direct decode_resize_batch),
    else by PIL."""
    from dmlc_tpu_torch import native
    from dmlc_tpu_torch.cluster.rpc import TcpRpc, TcpRpcServer
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.ops import preprocess as pp
    from dmlc_tpu_torch.scheduler.worker import EngineBackend, PredictWorker
    from dmlc_tpu_torch.utils import corpus

    jpeg_backend = "native" if native_build["available"] else "pil"
    with tempfile.TemporaryDirectory(prefix="dmlc-torch-smoke-") as td:
        data_dir, synset_path = corpus.generate(Path(td), **SERVE_CORPUS)
        jpeg_digest = corpus_sha256(data_dir)
        jpeg_synsets = [s for s, _ in pp.load_synset_words(synset_path)]
        source = SeededImages(data_dir)
        backends = {}
        t0 = time.perf_counter()
        for name in ("resnet18", "alexnet"):
            b = EngineBackend(name, data_dir, batch_size=BATCH, image_source=source)
            b.decode_tier = source
            b.warmup()
            backends[name] = b
        build_s = time.perf_counter() - t0
        if native.available() != native_build["available"]:
            raise AssertionError(f"native decoder available: {native.available()}, "
                                 f"built: {native_build}")
        worker = PredictWorker(backends)
        predict = worker.methods()["job.predict"]
        server = TcpRpcServer("127.0.0.1", 0, worker.methods())
        rpc = TcpRpc()

        def predict_tcp(req: dict) -> dict:
            return rpc.call(server.address, "job.predict", req, timeout=600.0)

        requests = [
            ("resnet18", [f"seed_{k}" for k in range(600)], "decode_tier"),
            ("alexnet", [f"seed_{k}" for k in range(1000, 1300)], "decode_tier"),
            ("resnet18", [f"seed_{k}" for k in range(2000, 2257)], "decode_tier"),
            ("resnet18", jpeg_synsets, "jpeg"),
        ]
        try:
            K.reset_launch_counts()
            answers = []
            with NativeRecorder(native) as recorder:
                for model, synsets, source_kind in requests:
                    t = time.perf_counter()
                    preds = predict_tcp({"model": model, "synsets": synsets})["predictions"]
                    answers.append((model, synsets, source_kind, preds,
                                    time.perf_counter() - t))
            launches = {k: K.launch_counts()[k] for k in PREDICT_KERNELS}
            for name, count in launches.items():
                if count == 0:
                    raise AssertionError(f"{name}: no launch on the serving path")
            for model, synsets, _, preds, _ in answers:
                local = predict({"model": model, "synsets": synsets})["predictions"]
                if local != preds:
                    raise AssertionError(f"{model}: the TCP answers differ from the in-process "
                                         f"ones for the same {len(synsets)} synsets")

            jpeg_paths = source(jpeg_synsets)
            if jpeg_backend == "native":
                if len(recorder.calls) != 1:
                    raise AssertionError(f"native decode calls on the path: "
                                         f"{[len(c[0]) for c in recorder.calls]}")
                paths, served, status = recorder.calls[0]
                direct, direct_status = native.decode_resize_batch(jpeg_paths, SIZE)
                if ([str(x) for x in paths] != [str(x) for x in jpeg_paths] or status.any()
                        or direct_status.any() or not np.array_equal(served, direct)):
                    raise AssertionError("the served JPEG shard's native pixels differ from a "
                                         "direct decode_resize_batch")
            elif recorder.calls:
                raise AssertionError("native decode ran where it is unavailable")

            reports = []
            for model, synsets, source_kind, preds, wall in answers:
                engine = backends[model].engine
                paths = source(synsets)
                pixels = (source.decode_paths(paths, SIZE) if source_kind == "decode_tier"
                          else pp.load_batch(paths, size=SIZE, backend=jpeg_backend))
                want, gaps = plain_top1(engine, pixels)
                preds = np.asarray(preds)
                if len(preds) != len(synsets):
                    raise AssertionError(f"{model}: {len(preds)} answers for {len(synsets)}")
                mask = gaps > GAP
                bad = int((preds[mask] != want[mask]).sum())
                if bad:
                    raise AssertionError(f"{model}: {bad} compared rows differ from the plain path")
                reports.append({
                    "model": model, "synsets": len(synsets), "source": source_kind,
                    "decode": jpeg_backend if source_kind == "jpeg" else "decode_tier",
                    "batches": -(-len(synsets) // BATCH), "wall_s": wall,
                    "img_per_s": len(synsets) / wall, "rows": len(preds),
                    "compared_rows": int(mask.sum()),
                    "distinct_classes": int(len(set(preds.tolist()))),
                    "tcp_equals_in_process": True,
                })

            # Host numbers of the card's machine: the JPEG shard's decode,
            # native against PIL, and one 256-image JPEG shard over TCP
            # against in process; each the median of turns in this process.
            decoders = {"pil": lambda: pp.load_batch(jpeg_paths, size=SIZE, backend="pil")}
            if jpeg_backend == "native":
                decoders["native"] = lambda: pp.load_batch(jpeg_paths, size=SIZE,
                                                           backend="native")
            decode_ms, decode_walls = alternate_ms(decoders)
            # One batch: a shard of at most BATCH images decodes its JPEGs
            # itself (the decode tier feeds only multi-batch shards).
            shard256 = {"model": "resnet18", "synsets": (jpeg_synsets * 2)[:BATCH]}

            def on_new_thread() -> None:
                # What the server does besides the fabric: the method runs
                # on a thread started for the connection.
                t = threading.Thread(target=predict, args=(shard256,))
                t.start()
                t.join()

            wall_ms, walls = alternate_ms({"tcp": lambda: predict_tcp(shard256),
                                           "in_process": lambda: predict(shard256),
                                           "in_process_new_thread": on_new_thread})
            # The fabric alone: the same request echoed by a method that
            # does nothing, one connection a call.
            echo = TcpRpcServer("127.0.0.1", 0, {"echo": lambda p: p})
            try:
                echo_ms = [1e3 * t for t in (
                    timed(lambda: rpc.call(echo.address, "echo", shard256, timeout=60.0))
                    for _ in range(200))]
            finally:
                echo.close()
            host = {
                "phase": "serve_host", "nvidia_smi": dev["nvidia_smi"],
                "jpeg_decode": {
                    "images": len(jpeg_paths), "size": SIZE, "source_px": 256,
                    "pil_img_per_s": len(jpeg_paths) / (decode_ms["pil"] / 1e3),
                    "native_img_per_s": (len(jpeg_paths) / (decode_ms["native"] / 1e3)
                                         if "native" in decode_ms else None),
                    "native_unavailable": native_build["reason"],
                    "ms": decode_ms, "readings_ms": decode_walls,
                },
                "predict_256": {"model": "resnet18", "source": "jpeg", "decode": jpeg_backend,
                                "tcp_ms": wall_ms["tcp"], "in_process_ms": wall_ms["in_process"],
                                "new_thread_ms": wall_ms["in_process_new_thread"],
                                "tcp_minus_in_process_ms": wall_ms["tcp"] - wall_ms["in_process"],
                                "readings_ms": walls},
                "echo_256_synsets_ms": {"p50": statistics.median(echo_ms),
                                        "min": min(echo_ms), "max": max(echo_ms),
                                        "calls": len(echo_ms)},
            }
            emit(host)
        finally:
            server.close()

        throughput = {}
        gen = np.random.default_rng(7)
        batch = gen.integers(0, 256, (BATCH, SIZE, SIZE, 3), np.uint8)
        pinned = torch.from_numpy(batch).pin_memory()
        for model, backend in backends.items():
            engine = backend.engine
            dts = []
            for _ in range(12):
                t = time.perf_counter()
                engine.run_batch(batch)
                dts.append(time.perf_counter() - t)
            u8 = torch.from_numpy(batch).to(engine.device)
            x = K.normalize_u8(u8, engine._mean, engine._std, engine.dtype)
            with torch.inference_mode():
                logits = engine.model(x)
            run_batch_ms = 1e3 * statistics.median(dts[2:])
            forward_ms = time_ms(lambda e=engine, u=u8: e._forward(u), reps=11, inner=5)
            pageable_ms = time_ms(lambda d=engine.device: torch.from_numpy(batch).to(d),
                                  reps=11, inner=5)
            # run_batch copies from pageable memory and then runs the forward
            # on one stream; what is left of its wall the device sat idle.
            throughput[model] = {
                "run_batch_img_per_s": BATCH / statistics.median(dts[2:]),
                "run_batch_ms": run_batch_ms,
                "h2d_pageable_ms": pageable_ms,
                "h2d_pinned_ms": time_ms(lambda d=engine.device: pinned.to(d, non_blocking=True),
                                         reps=11, inner=5),
                "run_batch_idle_share_at_least": 1.0 - (pageable_ms + forward_ms) / run_batch_ms,
                "device_forward_ms": forward_ms,
                "normalize_ms": time_ms(lambda e=engine, u=u8: K.normalize_u8(
                    u, e._mean, e._std, e.dtype), reps=11, inner=5),
                "model_ms": time_ms(lambda e=engine, v=x: e.model(v), reps=11, inner=5),
                "softmax_ms": time_ms(lambda v=logits: K.softmax_top1(v), reps=11, inner=5),
                "ingest": engine.ingest_summary(),
                "profile_run_batch": profile_call(lambda e=engine: e.run_batch(batch)),
            }
        # The device's share of one 600-image request, from CUDA-event times:
        # three batches, each a pinned copy (on the copy stream, which may
        # overlap the forward) and a forward, against the untraced wall.
        shard = {"model": "resnet18", "synsets": [f"seed_{k}" for k in range(600)]}
        t = time.perf_counter()
        predict(shard)
        shard_ms = 1e3 * (time.perf_counter() - t)
        r18 = throughput["resnet18"]
        device_ms = -(-600 // BATCH) * (r18["h2d_pinned_ms"] + r18["device_forward_ms"])
        traced = {
            "request": "resnet18 x 600 through the decode tier",
            "wall_ms": shard_ms, "device_ms_at_most": device_ms,
            "idle_share_at_least": 1.0 - device_ms / shard_ms,
            "profile": profile_call(lambda: predict(shard)),
        }
    serve = {"phase": "serve", "nvidia_smi": dev["nvidia_smi"], "engines_build_s": build_s,
             "transport": "TcpRpcServer on 127.0.0.1", "launches": launches, "requests": reports,
             "throughput": throughput, "traced_request": traced}
    emit(serve)
    jpeg = answers[-1]
    return {**serve, "jpeg_answer": {"model": jpeg[0], "synsets": jpeg[1], "predictions": jpeg[3],
                                     "corpus_sha256": jpeg_digest}}


#: The serve phase's JPEG corpus (utils/corpus.generate): the sdfs phase
#: makes it again and holds its bytes to the serve phase's digest.
SERVE_CORPUS = {"n_classes": 200, "images_per_class": 1, "size": 256, "seed": 0}
#: The sdfs phase's store: three members, every blob on all three.
SDFS_MEMBERS = 3
#: Seed of the weights published in the sdfs phase (the serve phase's
#: engines use seed 0).
PUBLISHED_SEED = 1
#: Concurrent single-synset requests through the DynamicBatcher.
BATCHED_REQUESTS = 64


def corpus_sha256(data_dir: Path) -> str:
    """One digest over every file of a corpus, by relative path."""
    import hashlib

    h = hashlib.sha256()
    for path in sorted(p for p in Path(data_dir).rglob("*") if p.is_file()):
        h.update(str(path.relative_to(data_dir)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def phase_sdfs(dev: dict, serve: dict) -> dict:
    """The member side of the weights loop on the port, over TCP on
    localhost: a port SdfsLeader and three port SdfsMembers (rf 3), one of
    which also serves job.predict and model.load from its server, with an
    EngineBackend that has no local corpus (its images come from the store
    through an SdfsImageSource).

    1. The serve phase's JPEG corpus is published into the store; a shard of
       all its synsets, pulled through the store (cold) and then from the
       member's cache (warm), must answer what the serve phase answered from
       local files with the same weights.
    2. A resnet18 of another seed is published as a weights blob
       (publish_weights of its to_jax tree) and hot-loaded by model.load;
       the shard must then answer what an engine built from that module
       answers, and differ from step 1 on at least one row.
    3. BATCHED_REQUESTS concurrent single-synset requests through a
       DynamicBatcher around the backend must answer as the backend does
       unbatched, in fewer dispatches than requests.

    normalize_u8 and softmax_top1 must launch in the requests of steps 1-3
    (counts set to 0 just before each step's requests and read just after)."""
    from dmlc_tpu_torch.cluster.rpc import TcpRpc, TcpRpcServer
    from dmlc_tpu_torch.cluster.sdfs import (
        DEFAULT_CHUNK_BYTES,
        MemberStore,
        SdfsClient,
        SdfsLeader,
        SdfsMember,
    )
    from dmlc_tpu_torch.models import weights as W
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.ops import preprocess as pp
    from dmlc_tpu_torch.parallel.inference import InferenceEngine
    from dmlc_tpu_torch.scheduler.dataset import SdfsImageSource, publish_corpus
    from dmlc_tpu_torch.scheduler.worker import (
        DynamicBatcher,
        EngineBackend,
        ModelLoader,
        PredictWorker,
    )
    from dmlc_tpu_torch.utils import corpus

    want = serve["jpeg_answer"]
    model = want["model"]
    launches: Counter = Counter()

    def counted(fn):
        K.reset_launch_counts()
        out = fn()
        launches.update({k: K.launch_counts()[k] for k in PREDICT_KERNELS})
        return out

    with tempfile.TemporaryDirectory(prefix="dmlc-torch-sdfs-") as td:
        root = Path(td)
        data_dir, synset_path = corpus.generate(root / "corpus", **SERVE_CORPUS)
        if corpus_sha256(data_dir) != want["corpus_sha256"]:
            raise AssertionError("the corpus made again differs from the serve phase's")
        synsets = [s for s, _ in pp.load_synset_words(synset_path)]
        if synsets != want["synsets"]:
            raise AssertionError("the corpus's synsets differ from the serve phase's shard")
        rpc = TcpRpc()
        addrs: list[str] = []
        servers = []
        batcher = None
        try:
            leader = SdfsLeader(rpc, lambda: list(addrs), replication_factor=SDFS_MEMBERS)
            servers.append(TcpRpcServer("127.0.0.1", 0, leader.methods()))
            laddr = servers[0].address
            stores = [MemberStore(root / f"member{i}") for i in range(SDFS_MEMBERS)]
            # Member 0 serves the store, job.predict and model.load from one
            # server; its image source pulls through its own SdfsClient.
            # (The server reads its table at each call: filled once the
            # image source knows the server's address.)
            methods: dict = {}
            serving = TcpRpcServer("127.0.0.1", 0, methods)
            servers.append(serving)
            own = SdfsClient(rpc, laddr, stores[0], serving.address)
            backend = EngineBackend(model, root / "empty_data_dir", batch_size=BATCH,
                                    image_source=SdfsImageSource(own, root / "data_cache"))
            methods.update({**SdfsMember(stores[0], rpc).methods(),
                            **PredictWorker({model: backend}).methods(),
                            **ModelLoader(stores[0], {model: backend}).methods()})
            addrs.append(serving.address)
            for store in stores[1:]:
                servers.append(TcpRpcServer("127.0.0.1", 0, SdfsMember(store, rpc).methods()))
                addrs.append(servers[-1].address)
            build_t = time.perf_counter()
            backend.warmup()
            build_s = time.perf_counter() - build_t
            publisher = SdfsClient(rpc, laddr, stores[1], addrs[1])
            publish_corpus(publisher, data_dir, synsets)

            def shard(names) -> list[int]:
                reply = rpc.call(serving.address, "job.predict",
                                 {"model": model, "synsets": list(names)}, timeout=600.0)
                return reply["predictions"]

            # Step 1: images from the store.
            t = time.perf_counter()
            cold = counted(lambda: shard(synsets))
            cold_s = time.perf_counter() - t
            t = time.perf_counter()
            warm = counted(lambda: shard(synsets))
            warm_s = time.perf_counter() - t
            cached = sorted(p.stem for p in (root / "data_cache").glob("*.img"))
            if cached != sorted(synsets):
                raise AssertionError(f"{len(cached)} of {len(synsets)} images pulled into the cache")
            if cold != want["predictions"] or warm != cold:
                raise AssertionError("the shard served from store-pulled images differs from the "
                                     "serve phase's answer from local files")

            # Step 2: published weights, hot-loaded by model.load.
            module = get_model(model).init_params(PUBLISHED_SEED, dtype=torch.float32)
            variables = get_model(model).to_jax(module.state_dict())
            t = time.perf_counter()
            blob = W.weights_to_bytes(model, variables)
            serialize_s = time.perf_counter() - t
            t = time.perf_counter()
            version = W.publish_weights(publisher, model, variables)
            publish_s = time.perf_counter() - t
            name = W.sdfs_weights_name(model)
            t = time.perf_counter()
            got_version, fetched = publisher.get_bytes(name)
            get_s = time.perf_counter() - t
            if (got_version, fetched) != (version, blob):
                raise AssertionError("get_bytes returned other bytes than were published")
            if stores[0].read(name, version) != blob:
                raise AssertionError("the serving member's replica differs from the blob")
            t = time.perf_counter()
            reply = rpc.call(serving.address, "model.load", {"model": model, "version": version},
                             timeout=600.0)
            load_s = time.perf_counter() - t
            if reply != {"model": model, "version": version}:
                raise AssertionError(f"model.load replied {reply}")
            loaded = counted(lambda: shard(synsets))
            direct = InferenceEngine(model, device=backend.device, batch_size=BATCH,
                                     variables=module.state_dict())
            paths = backend.image_source(synsets)
            direct_top1 = [int(x) for x in direct.run_paths(paths).top1_index]
            if loaded != direct_top1:
                bad = sum(a != b for a, b in zip(loaded, direct_top1))
                raise AssertionError(f"{bad} rows after model.load differ from an engine built "
                                     f"from the published module")
            changed = sum(a != b for a, b in zip(loaded, cold))
            if changed == 0:
                raise AssertionError("model.load left every answer as it was")

            # Step 3: the batcher.
            picks = synsets[:BATCHED_REQUESTS]
            unbatched = backend(picks)
            batcher = DynamicBatcher(backend, batch_size=BATCH, max_wait_s=0.05)
            batched = TcpRpcServer("127.0.0.1", 0, PredictWorker({model: batcher}).methods())
            servers.append(batched)
            answers: dict[int, int] = {}

            def one(i: int) -> None:
                answers[i] = rpc.call(batched.address, "job.predict",
                                      {"model": model, "synsets": [picks[i]]},
                                      timeout=600.0)["predictions"][0]

            def burst() -> None:
                threads = [threading.Thread(target=one, args=(i,)) for i in range(len(picks))]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()

            t = time.perf_counter()
            counted(burst)
            burst_s = time.perf_counter() - t
            summary = batcher.summary()
            if [answers.get(i) for i in range(len(picks))] != unbatched:
                raise AssertionError("batched answers differ from the unbatched backend's")
            if not summary["dispatches"] < len(picks):
                raise AssertionError(f"{summary['dispatches']} dispatches for {len(picks)} "
                                     f"requests")
        finally:
            if batcher is not None:
                batcher.stop()
            for server in servers:
                server.close()
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name}: no launch on the sdfs path")
    mb = len(blob) / 1e6
    report = {
        "phase": "sdfs", "nvidia_smi": dev["nvidia_smi"], "model": model, "batch": BATCH,
        "members": SDFS_MEMBERS, "replication_factor": SDFS_MEMBERS,
        "transport": "TcpRpcServer on 127.0.0.1", "chunk_bytes": DEFAULT_CHUNK_BYTES,
        "engine_build_s": build_s, "images": len(synsets),
        "shard_cold_s": cold_s, "shard_warm_s": warm_s,
        "shard_equals_serve_phase": True,
        "blob_bytes": len(blob), "blob_version": version, "serialize_s": serialize_s,
        "publish_s": publish_s, "put_s": publish_s - serialize_s,
        "put_mb_per_s": mb / max(publish_s - serialize_s, 1e-9),
        "get_bytes_s": get_s, "get_mb_per_s": mb / get_s, "model_load_s": load_s,
        "rows_changed_by_load": changed, "loaded_equals_direct_engine": True,
        "batched_requests": len(picks), "dispatches": summary["dispatches"],
        "mean_fill": summary["mean_fill"], "burst_s": burst_s,
        "batched_equals_unbatched": True, "launches": dict(launches),
    }
    emit(report)
    return report


#: The cluster phase's corpus: one 256-px JPEG for each of the reference's
#: 1000 synsets, written at the start of the phase.
CLUSTER_CORPUS = {"n_classes": 1000, "images_per_class": 1, "size": 256, "seed": 3}
#: The cluster phase's fleet: three port nodes, the first two leader candidates.
CLUSTER_NODES = 3
#: Seed of the resnet18 that the cluster phase publishes and train() loads.
CLUSTER_TRAIN_SEED = 2
#: The config's dispatch shard size (utils/config.py), one job.predict each.
CLUSTER_SHARD = 64
#: Interval scale of localcluster's fleet: 0.5 s heartbeats, 1.5 s failure
#: timeout, so threads busy with decode and dispatch hold no false verdict.
CLUSTER_SCALE = 2.5


def cluster_synsets(path: Path, first_top1: np.ndarray) -> list[str]:
    """The job's synset file: the 1000 synsets ``n{i:08d}`` in an order
    that puts, wherever it can, a synset whose image the seed-0 resnet18
    labels ``c`` on line ``c`` (the job's truth is the line), so that its
    ``correct`` counts every class the engine gives to some image rather
    than about one in a thousand. Written in make_synsets' line format;
    returns the synsets in line order."""
    n = len(first_top1)
    line: list[int | None] = [None] * n
    rest = []
    for k, c in enumerate(int(x) for x in first_top1):
        if 0 <= c < n and line[c] is None:
            line[c] = k
        else:
            rest.append(k)
    fill = iter(rest)
    order = [k if k is not None else next(fill) for k in line]
    synsets = [f"n{k:08d}" for k in order]
    path.write_text("".join(f"{s} label {i}\n" for i, s in enumerate(synsets)))
    return synsets


def shard_top1(engine, u8: np.ndarray) -> np.ndarray:
    """The engine's top-1 over ``u8`` in the job's shards (CLUSTER_SHARD rows,
    each one run_batch, as a member runs a job.predict shard)."""
    return np.concatenate([engine.run_batch(u8[s:s + CLUSTER_SHARD]).top1_index
                           for s in range(0, len(u8), CLUSTER_SHARD)])


def run_predict(nodes, want: dict) -> dict:
    """``predict`` from a non-leader; waits for both jobs and holds each
    job's ``finished`` and ``correct`` against ``want`` (job -> correct),
    every member assigned and every member serving shards. Returns the
    run's numbers; normalize_u8 and softmax_top1 must have launched (counts
    set to 0 just before predict, read once both jobs are done)."""
    from dmlc_tpu_torch.ops import kernels as K

    leader = nodes[0].scheduler
    members = sorted(n.self_member_addr for n in nodes)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    nodes[1].predict()
    assigned = nodes[1].assignments()
    walls: dict[str, float] = {}
    while len(walls) < len(leader.jobs):
        for name, job in leader.jobs.items():
            if job.done and name not in walls:
                walls[name] = time.perf_counter() - t0
        if time.perf_counter() - t0 > 300:
            raise AssertionError(f"jobs not done in 300 s: {sorted(walls)} done")
        time.sleep(0.005)
    launches = {k: K.launch_counts()[k] for k in PREDICT_KERNELS}
    report = nodes[2].jobs_report()
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name}: no launch on the cluster path")
    if sorted({m for ms in assigned.values() for m in ms}) != members:
        raise AssertionError(f"assignments {assigned} leave out a member of {members}")
    jobs = {}
    served: Counter = Counter()
    for name, r in sorted(report.items()):
        if r["finished"] != len(leader.jobs[name].queries) or r["correct"] != want[name]:
            raise AssertionError(f"{name}: finished {r['finished']}, correct {r['correct']}; "
                                 f"the in-process engine gives {want[name]} correct")
        by_member = {m: int(s["count"]) for m, s in r["member_latency"].items()}
        served.update(by_member)
        jobs[name] = {
            "finished": r["finished"], "correct": r["correct"], "wall_s": walls[name],
            "images_per_s": r["finished"] / walls[name],
            "throughput_qps": r["throughput_qps"], "shards": sum(by_member.values()),
            "shard_p50_ms": 1e3 * r["shard_latency"]["median"],
            "shard_p99_ms": 1e3 * r["shard_latency"]["p99"], "shards_by_member": by_member,
        }
    if sorted(served) != members:
        raise AssertionError(f"members that served shards: {sorted(served)} of {members}")
    by_member: dict[str, list[str]] = {m: [] for m in members}
    for name, ms in assigned.items():
        for m in ms:
            by_member[m].append(name)
    return {"jobs": jobs, "wall_s": max(walls.values()), "assigned": by_member,
            "launches": launches}


class NodeDeviceWork:
    """``device_work`` of a backend built before its fleet: forwards each
    (model, items, seconds) to the device monitor of the node that serves
    the backend, once ``monitor`` is set (the nodes own their monitors, and
    a backend the caller hands a node carries no ``device_work`` of its
    own)."""

    def __init__(self):
        self.monitor = None

    def __call__(self, model: str, items: int, seconds: float) -> None:
        if self.monitor is not None:
            self.monitor.device_work(model, items, seconds)


#: The device monitor's gauges of one member that phase cluster reads.
DEVICE_GAUGES = ("hbm_bytes_in_use", "hbm_peak_bytes", "hbm_limit_bytes", "jit_compiles",
                 "jit_compile_seconds", "jit_steady_recompiles", "device_peak_flops")


def fleet_obs(nodes, backends, first: dict, models, timeout_s: float = 60.0) -> dict:
    """The observability plane after a predict, through the leader's verbs
    over the port's TcpRpc: ``obs.fleet`` once the leader's scrape loop has
    seen every member's MFU, and ``obs.critpath`` once its fold holds both
    models. Checks for each member: the three HBM gauges non-null and
    positive, ``hbm_limit_bytes`` the card's total memory; each model's
    ``resident_bytes_<model>`` its engine's ``resident_bytes()``; the
    ``mfu_<model>`` of each model the member served shards of in (0, 1],
    and of the others None (a member runs only its assigned jobs);
    ``jit_compiles``/``jit_compile_seconds`` this process's kernel builds;
    ``device_peak_flops`` the H100's dense bf16 peak. Also times one
    ``obs.fleet`` call and one scrape pass of the kind the leader's loop
    makes (``observe.scrape_fleet_metrics`` over every member)."""
    from dmlc_tpu_torch.cluster import observe
    from dmlc_tpu_torch.cluster.devicemon import CENSUS, PEAK_FLOPS
    from dmlc_tpu_torch.cluster.rpc import TcpRpc

    rpc = TcpRpc()
    leader = nodes[0].self_leader_addr
    members = sorted(n.self_member_addr for n in nodes)
    served = {m: sorted(name for name, job in first["jobs"].items()
                        if m in job["shards_by_member"]) for m in members}

    def gauges_of(fleet: dict, member: str) -> dict:
        return ((fleet.get(member) or {}).get("metrics") or {}).get("gauges") or {}

    t0 = time.perf_counter()
    while True:
        fleet = rpc.call(leader, "obs.fleet", {}, timeout=10.0)["fleet"]
        if sorted(fleet) == members and all(
                gauges_of(fleet, m).get(f"mfu_{name}") is not None
                for m in members for name in served[m]):
            break
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"obs.fleet lacks members or MFU after {timeout_s} s: "
                                 f"{sorted(fleet)}")
        time.sleep(0.2)
    scraped_after_s = time.perf_counter() - t0
    while True:
        crit = rpc.call(leader, "obs.critpath", {}, timeout=10.0)["critpath"]
        if set(models) <= set(crit.get("models") or {}):
            break
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"obs.critpath has lanes of {sorted(crit.get('models') or {})}"
                                 f" only, not of every model of {list(models)}")
        time.sleep(0.2)
    t = time.perf_counter()
    rpc.call(leader, "obs.fleet", {}, timeout=10.0)
    obs_fleet_ms = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    scraped = observe.scrape_fleet_metrics(
        rpc, members, timeout=10.0, concurrency=nodes[0].config.scrape_concurrency)
    scrape_pass_ms = 1e3 * (time.perf_counter() - t)
    if sorted(scraped) != members:
        raise AssertionError(f"a scrape pass reached {sorted(scraped)} of {members}")

    total = torch.cuda.get_device_properties(0).total_memory
    per_member = {}
    for i, node in enumerate(nodes):
        m = node.self_member_addr
        g = gauges_of(fleet, m)
        row = {k: g.get(k) for k in DEVICE_GAUGES}
        for k in ("hbm_bytes_in_use", "hbm_peak_bytes", "hbm_limit_bytes"):
            if not (g.get(k) is not None and g[k] > 0):
                raise AssertionError(f"{m}: {k} = {g.get(k)}, not a positive byte count")
        if g["hbm_limit_bytes"] != total:
            raise AssertionError(f"{m}: hbm_limit_bytes {g['hbm_limit_bytes']} is not the "
                                 f"card's total memory {total}")
        for name in models:
            resident = g.get(f"resident_bytes_{name}")
            want = backends[i][name].engine.resident_bytes()
            if resident != want:
                raise AssertionError(f"{m}: resident_bytes_{name} {resident}, the engine "
                                     f"holds {want}")
            mfu = g.get(f"mfu_{name}")
            if name in served[m]:
                if not (mfu is not None and 0.0 < mfu <= 1.0):
                    raise AssertionError(f"{m}: mfu_{name} = {mfu}, not in (0, 1]")
            elif mfu is not None:
                raise AssertionError(f"{m}: mfu_{name} = {mfu} on a member that served "
                                     f"no {name} shard")
            row[f"resident_bytes_{name}"] = resident
            row[f"mfu_{name}"] = mfu
        if g["jit_compiles"] != CENSUS.compiles() or g["jit_compile_seconds"] != \
                CENSUS.compile_seconds():
            raise AssertionError(f"{m}: jit_compiles {g['jit_compiles']} / "
                                 f"{g['jit_compile_seconds']} s, this process built "
                                 f"{CENSUS.compiles()} / {CENSUS.compile_seconds()} s")
        if g["device_peak_flops"] != PEAK_FLOPS["gpu"] or PEAK_FLOPS["gpu"] != 989e12:
            raise AssertionError(f"{m}: device_peak_flops {g['device_peak_flops']}")
        per_member[m] = {"served": served[m], **row}
    lanes = {name: [[ln["stage"], ln["member"], ln["share"]] for ln in body["lanes"]]
             for name, body in sorted(crit["models"].items())}
    return {"members": per_member, "card_total_memory": total,
            "kernel_builds": CENSUS.snapshot()["labels"],
            "scraped_after_s": scraped_after_s, "obs_fleet_ms": obs_fleet_ms,
            "scrape_pass_ms": scrape_pass_ms, "critpath_lanes": lanes,
            "critpath_members_reporting": crit.get("members_reporting")}


def fleet_trace(nodes, path: Path) -> dict:
    """``trace fleet`` through the port's CLI on a non-leader: one Perfetto
    document with a lane for each member, in which a dispatch's trace holds
    spans of all three members (the leader's ``scheduler/dispatch``, the
    member's ``rpc/job.predict`` and the store's pulls from a third)."""
    from dmlc_tpu_torch.cli import Cli

    out = Cli(nodes[1]).run_command(f"trace fleet {path}")
    if "wrote merged fleet trace" not in out:
        raise AssertionError(f"trace fleet: {out}")
    doc = json.loads(path.read_text())
    lanes = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"] if e.get("ph") == "M"}
    members = sorted(n.self_member_addr for n in nodes)
    if sorted(lanes.values()) != members:
        raise AssertionError(f"trace fleet lanes {sorted(lanes.values())}, members {members}")
    by_trace: dict[str, list] = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e["args"].get("trace"):
            by_trace.setdefault(e["args"]["trace"], []).append(e)
    spanning = [evs for evs in by_trace.values()
                if {"scheduler/dispatch", "rpc/job.predict"} <= {e["name"] for e in evs}
                and len({e["pid"] for e in evs}) == len(members)]
    if not spanning:
        raise AssertionError(f"no predict trace of {len(by_trace)} spans all {len(members)} "
                             f"members")
    example: dict[str, Counter] = {}
    for e in spanning[0]:
        example.setdefault(lanes[e["pid"]], Counter())[e["name"]] += 1
    return {"cli": out, "spans": sum(len(v) for v in by_trace.values()),
            "traces": len(by_trace), "traces_across_all_members": len(spanning),
            "example": {"trace": spanning[0][0]["args"]["trace"],
                        "spans_by_member": {m: dict(c) for m, c in sorted(example.items())}},
            "max_skew_s": max((float(v.get("max_skew_s") or 0.0)
                               for v in doc["otherData"].get("nodes", {}).values()),
                              default=0.0)}


def phase_cluster(dev: dict) -> dict:
    """The reference's job on the card through the port's own entry points:
    three port ClusterNodes (cluster/localcluster.py) on localhost TCP and
    UDP in this process, each with its own EngineBackends for resnet18 and
    alexnet (batch 256, 224 px, bf16, seed-0 weights, device "cuda"), run
    ``predict`` over 1000 synsets, one seeded JPEG each, in shards of 64.

    1. predict from a non-leader: both jobs finish all 1000 queries, each
       job's ``correct`` equals that of one in-process engine of the same
       seed over the same images in the same shards, every member is
       assigned and serves, normalize_u8 and softmax_top1 launch.
    2. A resnet18 of CLUSTER_TRAIN_SEED is published to models/resnet18 and
       ``train()`` pulls it to every member and hot-loads it (model.load).
       A job that finished does not run again under the same leader
       history, so the second predict runs on a second fleet (new nodes, a
       new leader, new stores) whose members serve from the same backends:
       the publish and train() run there, and then resnet18's ``correct``
       must equal that of an engine built from the published module, and
       alexnet's stay as in step 1.

    The observability plane rides both: the backends report their device
    work to their node's device monitor (NodeDeviceWork), and the tracer is
    on for both predicts. After step 1 the leader's ``obs.fleet`` and
    ``obs.critpath`` are held to the device monitor's contract
    (``fleet_obs``). The second fleet pulls its images through the store
    (``data_from_sdfs``, the corpus published to it first), so that a
    dispatch's trace reaches a third member, and ``trace fleet`` after its
    predict must hold such a trace (``fleet_trace``)."""
    from dmlc_tpu_torch.cluster.localcluster import start_local_cluster, stop_local_cluster
    from dmlc_tpu_torch.models import weights as W
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.ops import preprocess as pp
    from dmlc_tpu_torch.parallel.inference import InferenceEngine
    from dmlc_tpu_torch.scheduler.dataset import publish_corpus
    from dmlc_tpu_torch.scheduler.worker import EngineBackend
    from dmlc_tpu_torch.utils import corpus
    from dmlc_tpu_torch.utils.tracing import tracer

    models = ("resnet18", "alexnet")
    with tempfile.TemporaryDirectory(prefix="dmlc-torch-cluster-") as td:
        root = Path(td)
        t = time.perf_counter()
        data_dir, _ = corpus.generate(root / "corpus", **CLUSTER_CORPUS)
        corpus_s = time.perf_counter() - t
        t = time.perf_counter()
        natural = [f"n{k:08d}" for k in range(CLUSTER_CORPUS["n_classes"])]
        pixels = pp.load_batch([pp.class_image_path(data_dir, s) for s in natural], size=SIZE)
        decode_s = time.perf_counter() - t
        direct = {m: InferenceEngine(m, device="cuda", batch_size=BATCH) for m in models}
        synsets = cluster_synsets(root / "synsets.txt", shard_top1(direct["resnet18"], pixels))
        u8 = pixels[[int(s[1:]) for s in synsets]]

        def correct(engine) -> int:
            top1 = shard_top1(engine, u8)
            return int((top1 == np.arange(len(top1))).sum())

        want = {m: correct(direct[m]) for m in models}
        published = get_model("resnet18").init_params(CLUSTER_TRAIN_SEED, dtype=torch.float32)
        trained = InferenceEngine("resnet18", device="cuda", batch_size=BATCH,
                                  variables=published.state_dict())
        want_trained = {"resnet18": correct(trained), "alexnet": want["alexnet"]}
        del direct, trained
        hooks = [NodeDeviceWork() for _ in range(CLUSTER_NODES)]
        backends = [{m: EngineBackend(m, data_dir, batch_size=BATCH, device="cuda",
                                      device_work=hook)
                     for m in models} for hook in hooks]
        fleet = dict(n_nodes=CLUSTER_NODES, backends=lambda i: backends[i],
                     synset_path=root / "synsets.txt", scale=CLUSTER_SCALE, device="cuda",
                     data_dir=str(data_dir), batch_size=BATCH, job_models=list(models),
                     dispatch_shard_size=CLUSTER_SHARD)
        nodes = []
        try:
            tracer.reset()
            tracer.enabled = True
            t = time.perf_counter()
            nodes = start_local_cluster(root / "fleet1", **fleet)
            start_s = time.perf_counter() - t
            for hook, node in zip(hooks, nodes):
                hook.monitor = node.devicemon
            first = run_predict(nodes, want)
            obs = fleet_obs(nodes, backends, first, models)
            emit({"phase": "cluster_obs", "nvidia_smi": dev["nvidia_smi"], **obs})
            stop_local_cluster(nodes)
            tracer.reset()
            nodes = start_local_cluster(root / "fleet2", **fleet, data_from_sdfs=True)
            for hook, node in zip(hooks, nodes):
                hook.monitor = node.devicemon
            t = time.perf_counter()
            corpus_blobs = publish_corpus(nodes[2].sdfs, data_dir)
            corpus_publish_s = time.perf_counter() - t
            variables = get_model("resnet18").to_jax(published.state_dict())
            t = time.perf_counter()
            version = W.publish_weights(nodes[2].sdfs, "resnet18", variables)
            publish_s = time.perf_counter() - t
            t = time.perf_counter()
            results = nodes[1].train()
            train_s = time.perf_counter() - t
            loaded = sorted(results[W.sdfs_weights_name("resnet18")]["loaded"])
            if loaded != sorted(n.self_member_addr for n in nodes):
                raise AssertionError(f"train() loaded resnet18 v{version} into {loaded} only")
            second = run_predict(nodes, want_trained)
            trace = fleet_trace(nodes, root / "fleet.json")
            emit({"phase": "cluster_trace", **trace})
        finally:
            tracer.enabled = False
            tracer.reset()
            stop_local_cluster(nodes)
    report = {
        "phase": "cluster", "nvidia_smi": dev["nvidia_smi"], "nodes": CLUSTER_NODES,
        "leader_candidates": 2, "transport": "TcpRpc and UdpTransport on 127.0.0.1",
        "models": list(models), "batch": BATCH, "dtype": "bfloat16",
        "queries_per_job": len(synsets), "shard": CLUSTER_SHARD,
        "corpus_s": corpus_s, "reference_decode_s": decode_s, "fleet_start_s": start_s,
        "want_correct": want, "predict": first, "publish_s": publish_s,
        "blob_version": version, "train_s": train_s, "train_loaded": len(loaded),
        "want_correct_after_train": want_trained, "predict_after_train": second,
        "fleet2_images_from_sdfs": True, "corpus_blobs": corpus_blobs,
        "corpus_publish_s": corpus_publish_s, "tracing": True, "obs": obs, "trace": trace,
        "launches": {k: first["launches"][k] + second["launches"][k] for k in PREDICT_KERNELS},
    }
    emit(report)
    return report


class FlightNotes:
    """Collects the slot scheduler's flight notes (slot_admit, slot_exit,
    shed, slot_evict)."""

    def __init__(self):
        self.events: list[dict] = []
        self._lock = threading.Lock()

    def note(self, kind: str, **fields) -> None:
        with self._lock:
            self.events.append({"kind": kind, **fields})


def gen_requests(vocab: int, seed: int = 0) -> list[tuple[list[int], int, float, int | None]]:
    """(prompt, max_new_tokens, temperature, seed) for the generate phase:
    prompts of 8-64 tokens, 16-64 new tokens, prompt + new <= 128; the last
    GEN_SAMPLED sample at temperature 0.8 with fixed seeds. Drawn again
    until every request's whole run fits the pool at once, so no request
    can be shed or evicted for pages."""
    rng = np.random.default_rng(seed)
    while True:
        reqs = []
        for i in range(GEN_REQUESTS):
            p = int(rng.integers(8, GEN_PREFILL + 1))
            n = int(rng.integers(16, min(64, 128 - p) + 1))
            sampled = i >= GEN_REQUESTS - GEN_SAMPLED
            reqs.append((rng.integers(0, vocab, size=p).tolist(), n,
                         0.8 if sampled else 0.0, 1000 + i if sampled else None))
        if sum(-(-(len(r[0]) + r[1]) // GEN_PAGE) for r in reqs) <= GEN_PAGES - 1:
            return reqs


def run_clients(rpc, addr: str, model: str, reqs) -> tuple[dict, dict, float]:
    """One generate_stream client thread per request, all started together,
    each calling the member at ``addr`` through ``rpc``."""
    from dmlc_tpu_torch.generate.worker import generate

    results: dict[int, list[int]] = {}
    errors: dict[int, str] = {}

    def run(i: int) -> None:
        prompt, n, temp, seed = reqs[i]
        try:
            results[i] = generate(rpc, addr, model, prompt, max_new_tokens=n,
                                  temperature=temp, seed=seed, poll_interval_s=GEN_POLL_S,
                                  poll_timeout=GEN_BUDGET_S)
        except Exception as e:  # every client's failure is reported below
            errors[i] = f"{type(e).__name__}: {e}"

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a generate client did not finish")
    return results, errors, wall


def top2_gaps(model, prompt: list[int], tokens: list[int]) -> np.ndarray:
    """Top-two logit gap at every generated position, from one
    full-sequence forward over prompt + tokens[:-1]."""
    seq = torch.tensor([prompt + tokens[:-1]], device=model.head.weight.device)
    with torch.no_grad():
        logits = model(seq)[0, len(prompt) - 1:].float()
    top2 = logits.topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).cpu().numpy()


def phase_generate(dev: dict) -> dict:
    from dmlc_tpu_torch.cluster.rpc import TcpRpc, TcpRpcServer
    from dmlc_tpu_torch.generate.engine import GenerationEngine
    from dmlc_tpu_torch.generate.slots import SlotScheduler
    from dmlc_tpu_torch.generate.worker import GenerateWorker, GenerationBackend
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.ops import kernels as K

    model_name = "lm_wide"
    flight = FlightNotes()
    t0 = time.perf_counter()
    backend = GenerationBackend(model_name, max_slots=GEN_SLOTS, page_size=GEN_PAGE,
                                num_pages=GEN_PAGES, max_prefill=GEN_PREFILL,
                                max_waiting=GEN_REQUESTS - GEN_SLOTS, flight=flight)
    backend.warmup()
    build_s = time.perf_counter() - t0
    worker = GenerateWorker({model_name: backend})
    engine = backend._scheduler.engine
    reqs = gen_requests(get_model(model_name).num_outputs)
    server = TcpRpcServer("127.0.0.1", 0, worker.methods())
    try:
        K.reset_launch_counts()
        results, errors, wall = run_clients(TcpRpc(), server.address, model_name, reqs)
        launches = K.launch_counts()
        steps = engine.steps
        stream_errors = [s.stream.error for s in worker._sessions.values()]
        summary = backend.summary()
    finally:
        server.close()
        backend.stop()
    if errors:
        raise AssertionError(f"generate clients failed: {errors}")
    if len(stream_errors) != GEN_REQUESTS or any(e is not None for e in stream_errors):
        raise AssertionError(f"stream errors: {stream_errors}")
    for i, (_, n, _, _) in enumerate(reqs):
        if len(results[i]) != n or not all(0 <= t < engine.vocab for t in results[i]):
            raise AssertionError(f"request {i}: {len(results[i])} tokens of {n}, or out of vocab")
    want_launches = engine.num_layers * steps
    if (steps == 0 or launches["paged_decode_attention"] != want_launches
            or launches["gather_kv_pages"]):
        raise AssertionError(
            f"paged_decode_attention launched {launches['paged_decode_attention']} times, "
            f"expected {engine.num_layers} layers x {steps} steps; gather_kv_pages "
            f"{launches['gather_kv_pages']} times, expected 0")
    if summary["sheds"] or summary["evictions"]:
        raise AssertionError(f"sheds/evictions in the generate phase: {summary}")

    # The same requests on a contiguous-cache engine (one page a slot).
    ref = GenerationEngine(model_name, cache="contiguous", max_slots=GEN_SLOTS,
                           max_prefill=GEN_PREFILL, variables=engine.model.state_dict())
    sched = SlotScheduler(ref, max_waiting=GEN_REQUESTS)
    try:
        streams = [sched.submit(p, max_new_tokens=n, temperature=t, seed=sd)
                   for p, n, t, sd in reqs]
        ref_tokens = [st.result(timeout=600) for st in streams]
    finally:
        sched.stop()
    greedy = [i for i, r in enumerate(reqs) if r[2] == 0.0]
    differ = [i for i in greedy if results[i] != ref_tokens[i]]
    gaps = np.concatenate([top2_gaps(engine.model, reqs[i][0], results[i]) for i in greedy])
    ties = int((gaps <= TIE_GAP).sum())
    if differ:
        raise AssertionError(f"greedy requests {differ} differ from the contiguous engine "
                             f"({ties} steps with a top-two gap <= {TIE_GAP})")
    sampled = [i for i, r in enumerate(reqs) if r[2] > 0.0]
    tokens = sum(len(r) for r in results.values())
    report = {
        "phase": "generate", "model": model_name, "nvidia_smi": dev["nvidia_smi"],
        "transport": "TcpRpcServer on 127.0.0.1",
        "slots": GEN_SLOTS, "page_size": GEN_PAGE, "num_pages": GEN_PAGES,
        "max_prefill": GEN_PREFILL, "engine_build_s": build_s,
        "requests": len(reqs), "greedy": len(greedy), "sampled": len(sampled),
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall, "steps": steps,
        "paged_launches": launches["paged_decode_attention"],
        "paged_launches_per_step": engine.num_layers,
        "gather_launches": launches["gather_kv_pages"],
        "one_step": engine_step_checks(model_name, engine.model.state_dict(),
                                       [r[0] for r in reqs[:GEN_SLOTS]]),
        "admits_mid_decode": sum(e["kind"] == "slot_admit" and e["step"] > 0
                                 for e in flight.events),
        "step_ms_p50": summary["step_ms_p50"], "step_ms_p99": summary["step_ms_p99"],
        "greedy_equal_contiguous": len(greedy) - len(differ),
        "top2_gap_ties": ties, "top2_gap_min": float(gaps.min()),
        "sampled_equal_contiguous": sum(results[i] == ref_tokens[i] for i in sampled),
        "stream_errors": sum(e is not None for e in stream_errors),
    }
    emit(report)
    return report


@contextlib.contextmanager
def engine_attention(fn):
    """The generation engine's per-layer attention replaced by ``fn`` (a
    function of paged_decode_attention's arguments) inside the block."""
    from dmlc_tpu_torch.generate import engine as E

    kept = E.paged_decode_attention
    E.paged_decode_attention = fn
    try:
        yield
    finally:
        E.paged_decode_attention = kept


def parent_attention(q, k_pages, v_pages, page_table, kv_lengths):
    """The parent's per-layer decode path: the page gather kernel on each
    pool, then ragged_decode_attention's eager ops over the padded view."""
    from dmlc_tpu_torch.ops import ragged_decode as RD

    return RD.ragged_decode_attention(q, RD.gather_kv_pages(k_pages, page_table),
                                      RD.gather_kv_pages(v_pages, page_table), kv_lengths)


def engine_step_checks(model_name: str, weights: dict, prompts: list) -> dict:
    """One decode step of paged and contiguous engines (the generate
    phase's geometry and weights) after joining ``prompts``, one a slot:
    their logits must be bit-identical. Then the paged engine's step replayed
    through the kernel and through the plain version
    (paged_decode_attention_reference) on the same state: relative L2 of
    the logits within STEP_LOGITS_REL_L2."""
    from dmlc_tpu_torch.generate import engine as E
    from dmlc_tpu_torch.ops import ragged_decode as RD

    kw = {"max_slots": GEN_SLOTS, "max_prefill": GEN_PREFILL, "variables": weights,
          "return_logits": True}
    paged = E.GenerationEngine(model_name, page_size=GEN_PAGE, num_pages=GEN_PAGES, **kw)
    contiguous = E.GenerationEngine(model_name, cache="contiguous", **kw)
    for eng in (paged, contiguous):
        for slot, prompt in enumerate(prompts):
            eng.join(slot, prompt)
            eng.ensure_capacity(slot)
        eng.step()
    if not np.array_equal(paged.last_logits, contiguous.last_logits):
        diff = float(np.abs(paged.last_logits - contiguous.last_logits).max())
        raise AssertionError(f"paged and contiguous logits differ after one step (max {diff})")
    regs = torch.from_numpy(np.stack([paged.last_tokens, paged.lengths, paged.active])
                            .astype(np.int64)).to(paged.device)
    table = torch.from_numpy(paged.cache.page_table).to(paged.device)
    with torch.no_grad():
        got = paged._decode(regs[0], regs[1], regs[2].bool(), table)
        with engine_attention(RD.paged_decode_attention_reference):
            want = paged._decode(regs[0], regs[1], regs[2].bool(), table)
    rel = float((got - want).norm() / want.norm())
    if not torch.isfinite(got).all() or rel > STEP_LOGITS_REL_L2:
        raise AssertionError(f"one step's logits through the kernel vs the plain version: "
                             f"relative L2 {rel} (limit {STEP_LOGITS_REL_L2})")
    return {"slots": len(prompts), "paged_equal_contiguous": True,
            "kernel_vs_plain_rel_l2": rel, "kernel_vs_plain_max_abs": max_abs_err(got, want),
            "tol": STEP_LOGITS_REL_L2}


def register_bench_lm() -> str:
    """The decode-bench LM, registered under bench.py's name for it."""
    from dmlc_tpu_torch.models.lm import TransformerLM
    from dmlc_tpu_torch.models.registry import ModelSpec, list_models, register

    name = "lm_bench_decode"
    if name not in list_models():
        def build(dtype=torch.float32):
            return TransformerLM(vocab=BENCH_VOCAB, num_layers=BENCH_LAYERS,
                                 num_heads=BENCH_HEADS, hidden=BENCH_HIDDEN,
                                 mlp_dim=BENCH_MLP, max_len=BENCH_MAX_LEN, dtype=dtype)

        register(ModelSpec(name, build, BENCH_MAX_LEN, BENCH_VOCAB, classifier=False, kind="lm"))
    return name


def phase_decode(dev: dict) -> dict:
    from dmlc_tpu_torch.generate.engine import GenerationEngine
    from dmlc_tpu_torch.generate.slots import SlotScheduler
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.utils.metrics import LatencyStats

    name = register_bench_lm()
    pages_per_req = -(-(BENCH_PROMPT + BENCH_NEW + 1) // BENCH_PAGE)
    num_pages = BENCH_REQUESTS * pages_per_req + BENCH_SLOTS + 1
    t0 = time.perf_counter()
    engine = GenerationEngine(name, max_slots=BENCH_SLOTS, page_size=BENCH_PAGE,
                              num_pages=num_pages, max_prefill=BENCH_PROMPT)
    build_s = time.perf_counter() - t0
    sched = SlotScheduler(engine, max_waiting=BENCH_REQUESTS)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, BENCH_VOCAB, size=BENCH_PROMPT).tolist()
               for _ in range(BENCH_REQUESTS)]
    try:
        sched.submit([1] * BENCH_PROMPT, max_new_tokens=2).result(timeout=600)  # warm-up
        sched.step_stats = LatencyStats()
        steps0 = engine.steps
        K.reset_launch_counts()
        t0 = time.perf_counter()
        streams = [sched.submit(p, max_new_tokens=BENCH_NEW) for p in prompts]
        outs = [st.result(timeout=600) for st in streams]
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        launches, gathers = counts["paged_decode_attention"], counts["gather_kv_pages"]
        steps = engine.steps - steps0
        stats = sched.step_stats
    finally:
        sched.stop()
    if any(len(o) != BENCH_NEW for o in outs):
        raise AssertionError("a decode-bench request came back short")
    if launches != BENCH_LAYERS * steps or gathers:
        raise AssertionError(f"paged_decode_attention launched {launches} times and "
                             f"gather_kv_pages {gathers} times in {steps} steps")

    # One step at a representative state: 8 slots joined with the bench
    # prompts and half their new tokens into the decode (length 192).
    for slot in range(BENCH_SLOTS):
        engine.join(slot, prompts[slot])

    def one_step():
        for slot in range(BENCH_SLOTS):
            engine.ensure_capacity(slot)
        return engine.step()

    for _ in range(BENCH_NEW // 2):
        one_step()
    walls = []
    for _ in range(11):
        t = time.perf_counter()
        one_step()
        walls.append(time.perf_counter() - t)
    step_wall_ms = 1e3 * statistics.median(walls)
    for slot in range(BENCH_SLOTS):
        engine.ensure_capacity(slot)
    regs = torch.from_numpy(np.stack([engine.last_tokens, engine.lengths, engine.active])
                            .astype(np.int64)).to(engine.device)
    table = torch.from_numpy(engine.cache.page_table).to(engine.device)
    # Back-to-back replays of the step's device work (same state, same
    # writes): an upper bound on one step's device time; in turns with the
    # parent's path (two gathers and the eager attention a layer).
    def replay():
        return engine._decode(regs[0], regs[1], regs[2].bool(), table)

    replays = {"paged": [], "parent": []}
    for path in ("paged", "parent", "parent", "paged"):
        with engine_attention(parent_attention if path == "parent"
                              else K.KERNELS["paged_decode_attention"]):
            replays[path].append(time_ms(replay, reps=11, inner=5))
    device_ms = statistics.fmean(replays["paged"])
    kv_lengths = (regs[1] + 1).clamp(min=1)
    q = torch.randn(BENCH_SLOTS, BENCH_HEADS, BENCH_HIDDEN // BENCH_HEADS, device="cuda")
    pools = (engine.cache.k_pages[0], engine.cache.v_pages[0])
    paged_ms = time_ms(lambda: K.KERNELS["paged_decode_attention"](q, *pools, table, kv_lengths),
                       reps=11, inner=5)
    paged_host = host_us(lambda: K.KERNELS["paged_decode_attention"](q, *pools, table, kv_lengths))
    profile = profile_call(one_step)
    tokens = sum(len(o) for o in outs)
    report = {
        "phase": "decode", "model": name, "nvidia_smi": dev["nvidia_smi"],
        "geometry": {"layers": BENCH_LAYERS, "heads": BENCH_HEADS, "hidden": BENCH_HIDDEN,
                     "mlp": BENCH_MLP, "vocab": BENCH_VOCAB, "max_len": BENCH_MAX_LEN},
        "slots": BENCH_SLOTS, "requests": BENCH_REQUESTS, "prompt": BENCH_PROMPT,
        "new_tokens": BENCH_NEW, "page_size": BENCH_PAGE, "num_pages": num_pages,
        "engine_build_s": build_s, "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "steps": steps, "paged_launches": launches,
        "gather_launches": gathers,
        "step_ms_p50": stats.percentile(50) * 1e3, "step_ms_p99": stats.percentile(99) * 1e3,
        "one_step": {
            "lengths": int(engine.lengths[0]), "wall_ms": step_wall_ms,
            "device_ms_at_most": device_ms, "device_ms_readings": replays["paged"],
            "parent_path_device_ms_readings": replays["parent"],
            "idle_share_at_least": 1.0 - device_ms / step_wall_ms,
            "paged_call_ms": paged_ms, "paged_host_us": paged_host, "paged_calls": BENCH_LAYERS,
            "profile": profile,
        },
        "gather_path": GATHER_PATH_DECODE,
    }
    emit(report)
    return report


def train_lm(schedule: str):
    """The LM train leg's model (bench.py:960-970): f32 parameters
    computing in bf16, attention by ``schedule``."""
    from dmlc_tpu_torch.models.lm import TransformerLM

    return TransformerLM(vocab=TRAIN_VOCAB, num_layers=TRAIN_LAYERS, num_heads=TRAIN_HEADS,
                         hidden=TRAIN_HIDDEN, mlp_dim=TRAIN_MLP, max_len=TRAIN_S,
                         dtype=torch.bfloat16, schedule=schedule)


def seeded_lm_weights(seed: int) -> dict:
    """flax-style initial weights of ``train_lm`` from ``seed`` (registry
    ModelSpec.init_params for kind="lm"), as a state dict."""
    from dmlc_tpu_torch.models.registry import ModelSpec

    spec = ModelSpec("lm_flash_train", lambda dtype: train_lm("flash"), TRAIN_S, TRAIN_VOCAB,
                     classifier=False, kind="lm")
    return spec.init_params(seed, dtype=torch.bfloat16).state_dict()


def loss_and_grads(model, tokens) -> tuple[float, dict]:
    from dmlc_tpu_torch.parallel.train import lm_loss

    model.zero_grad(set_to_none=True)
    loss = lm_loss(model, tokens)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def dense_parity(model, dense, tokens, loss_tol: float, grad_tol: float, ds_tol: float) -> dict:
    """The first step of ``model`` (flash schedule) against ``dense`` on the
    same weights and batch: |loss difference| within ``loss_tol``, each
    gradient's relative L2 difference within ``grad_tol`` (``ds_tol`` for
    the query and key projections; the key bias, whose exact gradient is
    zero, by its norms only). Raises past a bound."""
    flash_loss, flash_grads = loss_and_grads(model, tokens)
    dense_loss, dense_grads = loss_and_grads(dense, tokens)
    rel = {n: float((flash_grads[n] - g).norm() / g.norm().clamp_min(1e-30))
           for n, g in dense_grads.items() if not n.endswith(ZERO_GRAD_SUFFIX)}
    worst = max(rel, key=rel.get)
    zero_grad_norms = {
        n: {"flash": float(flash_grads[n].norm()), "dense": float(g.norm()),
            "query_bias_dense": float(dense_grads[n.replace("key.bias", "query.bias")].norm())}
        for n, g in dense_grads.items() if n.endswith(ZERO_GRAD_SUFFIX)}
    del flash_grads, dense_grads
    torch.cuda.empty_cache()
    over = {n: r for n, r in rel.items()
            if r > (ds_tol if n.endswith(DS_GRAD_SUFFIXES) else grad_tol)}
    if abs(flash_loss - dense_loss) > loss_tol or over:
        raise AssertionError(f"flash vs dense: loss {flash_loss} vs {dense_loss}, gradients "
                             f"past their bound: {over}")
    others = {n: r for n, r in rel.items() if not n.endswith(DS_GRAD_SUFFIXES)}
    worst_other = max(others, key=others.get)
    return {"flash_loss": flash_loss, "dense_loss": dense_loss,
            "loss_abs_diff": abs(flash_loss - dense_loss),
            "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst": worst,
            "grad_rel_l2_max_not_through_ds": others[worst_other],
            "grad_rel_l2_worst_not_through_ds": worst_other,
            "grad_rel_l2_median": statistics.median(rel.values()),
            "tensors_compared": len(rel), "zero_gradient_norms": zero_grad_norms,
            "tol": {"loss": loss_tol, "grad_rel_l2": grad_tol, "grad_rel_l2_query_key": ds_tol}}


def timed_steps(model, opt, tokens, steps: int, layers: int) -> dict:
    """One warm-up lm_train_step, then ``steps`` timed ones with the launch
    counts zeroed just before them and read just after, in all and by
    entry point: each flash kernel must launch ``layers`` x ``steps`` times
    and the loss must fall."""
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.parallel.train import lm_loss, lm_train_step

    first_loss = float(lm_train_step(model, opt, tokens))  # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    losses, walls, event_ms = [], [], []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        losses.append(lm_train_step(model, opt, tokens))
        end.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        event_ms.append(start.elapsed_time(end))
    counts, by_entry = K.launch_counts(), K.entry_launch_counts()
    launches = {k: counts[k] for k in FLASH_WRAPPERS}
    losses = [float(x) for x in losses]
    with torch.no_grad():
        final_loss = float(lm_loss(model, tokens))
    for name, count in launches.items():
        if count != layers * steps:
            raise AssertionError(f"{name} launched {count} times in {steps} steps, expected "
                                 f"{layers * steps}")
    if not all(np.isfinite(losses + [final_loss])) or not final_loss < first_loss:
        raise AssertionError(f"loss not finite or not falling: {first_loss} -> {losses} "
                             f"-> {final_loss}")
    return {"launches": launches, "entry_launches": entry_launch_report(by_entry),
            "loss_first": first_loss, "losses": losses, "loss_after": final_loss, "walls": walls,
            "event_ms": event_ms}


def entry_launch_report(by_entry) -> dict:
    """ops/kernels.entry_launch_counts() as JSON: "entry dh dtype" -> n."""
    return {f"{e} {dh} {str(dt).replace('torch.', '')}": n for (e, dh, dt), n in by_entry.items()}


def device_classes(events) -> dict:
    """Device ms of a traced run by kernel class: the flash kernels, the
    matrix products (cuBLAS/CUTLASS GEMMs) and the rest."""
    out = {"flash": 0.0, "gemm": 0.0, "other": 0.0}
    for name, _, dur in events:
        low = name.lower()
        key = ("flash" if "flash_" in low
               else "gemm" if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "nvjet"))
               else "other")
        out[key] += dur / 1e3
    return out


def phase_train(dev: dict) -> dict:
    """The causal LM trained through the flash kernels at full width
    (bench.py's LM train leg): the first step against the dense schedule on
    the same weights and batch, then 1 warm-up and TRAIN_STEPS timed
    lm_train_step calls with launch counts, loss, tokens/s, step p50, 6ND
    MFU, one traced step's device time by kernel and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    from dmlc_tpu_torch.parallel.train import default_optimizer, lm_train_step

    t0 = time.perf_counter()
    weights = seeded_lm_weights(seed=4)
    model = train_lm("flash")
    model.load_state_dict(weights)
    model.to("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, TRAIN_VOCAB, (TRAIN_BATCH, TRAIN_S + 1), device="cuda",
                           generator=gen)
    build_s = time.perf_counter() - t0

    # Flash against dense on the first step: same weights, same batch.
    dense = train_lm("dense")
    dense.load_state_dict(weights)
    dense.to("cuda")
    parity = dense_parity(model, dense, tokens, DENSE_LOSS_TOL, DENSE_GRAD_REL_L2, DS_GRAD_REL_L2)
    del dense
    torch.cuda.empty_cache()

    opt = default_optimizer(model.parameters(), lr=TRAIN_LR, weight_decay=1e-4)
    run = timed_steps(model, opt, tokens, TRAIN_STEPS, TRAIN_LAYERS)
    walls, event_ms = run["walls"], run["event_ms"]

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lm_train_step(model, opt, tokens)
        torch.cuda.synchronize()
    events = device_records(prof)
    classes = device_classes(events)
    traced_ms = sum(classes.values())
    by_name: dict[str, list] = {}
    for name, _, dur in events:
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += dur / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    step_s = statistics.fmean(walls)
    tokens_per_s = TRAIN_BATCH * TRAIN_S / step_s
    report = {
        "phase": "train", "nvidia_smi": dev["nvidia_smi"],
        "geometry": {"vocab": TRAIN_VOCAB, "layers": TRAIN_LAYERS, "heads": TRAIN_HEADS,
                     "hidden": TRAIN_HIDDEN, "mlp": TRAIN_MLP, "seq": TRAIN_S,
                     "batch": TRAIN_BATCH, "schedule": "flash", "compute": "bfloat16",
                     "params": "float32", "optimizer": f"AdamW lr {TRAIN_LR} wd 1e-4"},
        "params": n_params, "build_s": build_s, "dense_parity": parity,
        "launches": run["launches"], "entry_launches": run["entry_launches"],
        "loss_first": run["loss_first"], "losses": run["losses"], "loss_after": run["loss_after"],
        "steps": TRAIN_STEPS, "step_ms_p50": 1e3 * statistics.median(walls),
        "step_ms_mean": 1e3 * step_s, "step_ms_max": 1e3 * max(walls),
        "tokens_per_s": tokens_per_s,
        "mfu_6nd": 6.0 * n_params * tokens_per_s / dev["bf16_flops_per_s"],
        "step_event_ms_p50": statistics.median(event_ms),
        # Each step starts after a sync; the events bracket its stream work,
        # so the rest of the step's wall the device sat idle (a lower bound).
        "idle_share_at_least": 1.0 - statistics.median(event_ms) / (1e3 * statistics.median(walls)),
        "traced_step": {"device_ms_by_class": classes, "traced_busy_ms": traced_ms,
                        "share_flash": classes["flash"] / traced_ms,
                        "share_gemm": classes["gemm"] / traced_ms,
                        "top": [{"kernel": k[:80], "count": c, "ms": ms}
                                for k, (c, ms) in top]},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    del model, opt
    torch.cuda.empty_cache()
    emit(report)
    return report


def phase_train_small(dev: dict) -> dict:
    """lm_small, as the registry builds it (heads of 64), trained through
    the flash kernels at S = its max_len, in float32 (its default compute
    dtype) and then in bf16: each run's first step against the dense
    schedule on the registry's seeded weights and one batch, then
    SMALL_STEPS timed steps with the launch counts zeroed just before them
    (each flash kernel layers x SMALL_STEPS launches) and a falling loss."""
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.parallel.train import default_optimizer

    spec = get_model(SMALL_MODEL)
    s, vocab = spec.input_size, spec.num_outputs
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, vocab, (SMALL_BATCH, s + 1), device="cuda", generator=gen)
    report = {"phase": "train_small", "nvidia_smi": dev["nvidia_smi"]}
    tols = {torch.float32: (SMALL_F32_LOSS_TOL, SMALL_F32_GRAD_REL_L2, SMALL_F32_GRAD_REL_L2),
            torch.bfloat16: (DENSE_LOSS_TOL, DENSE_GRAD_REL_L2, DS_GRAD_REL_L2)}
    for dtype, tol in tols.items():
        weights = spec.init_params(seed=7, dtype=dtype).state_dict()
        model, dense = (spec.build(dtype=dtype, schedule=sch) for sch in ("flash", "dense"))
        report["geometry"] = {
            "model": SMALL_MODEL, "vocab": model.vocab, "layers": model.num_layers,
            "heads": model.num_heads, "head_dim": model.hidden // model.num_heads,
            "hidden": model.hidden, "mlp": model.mlp_dim, "seq": s, "batch": SMALL_BATCH,
            "schedule": "flash", "params": "float32",
            "optimizer": f"AdamW lr {TRAIN_LR} wd 1e-4"}
        for m in (model, dense):
            m.load_state_dict(weights)
            m.to("cuda")
        parity = dense_parity(model, dense, tokens, *tol)
        del dense
        opt = default_optimizer(model.parameters(), lr=TRAIN_LR, weight_decay=1e-4)
        run = timed_steps(model, opt, tokens, SMALL_STEPS, model.num_layers)
        report[str(dtype).replace("torch.", "")] = {
            "dense_parity": parity, "launches": run["launches"],
            "entry_launches": run["entry_launches"],
            "loss_first": run["loss_first"], "losses": run["losses"],
            "loss_after": run["loss_after"], "steps": SMALL_STEPS,
            "step_ms_p50": 1e3 * statistics.median(run["walls"]),
            "step_event_ms_p50": statistics.median(run["event_ms"]),
            "tokens_per_s": SMALL_BATCH * s / statistics.fmean(run["walls"]),
        }
        del model, opt
        torch.cuda.empty_cache()
    emit(report)
    return report


def phase_trainer(dev: dict) -> dict:
    """ResNet-18 through TrainingDriver at batch TRAINER_BATCH: TRAINER_STEPS
    steps checkpointed every TRAINER_EVERY into a temporary directory, then
    a second TrainingDriver over other weights restores the last checkpoint
    and must hold the first one's weights, statistics and moments exactly,
    and take one more step."""
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.parallel.train import create_train_state
    from dmlc_tpu_torch.parallel.trainer import TrainingDriver
    from dmlc_tpu_torch.utils.checkpoint import LocalCheckpointer

    def fresh(seed: int):
        model = get_model("resnet18").init_params(seed, dtype=torch.bfloat16).to("cuda")
        return create_train_state(model)

    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.standard_normal((TRAINER_STEPS + 1, TRAINER_BATCH, SIZE, SIZE, 3),
                                                  np.float32)).to("cuda")
    labels = torch.from_numpy(
        rng.integers(0, NUM_CLASSES, (TRAINER_STEPS + 1, TRAINER_BATCH))).to("cuda")

    def data_fn(step: int):
        return images[step % len(images)], labels[step % len(labels)]

    with tempfile.TemporaryDirectory(prefix="dmlc-torch-ckpt-") as td:
        ckpt = LocalCheckpointer(td)
        first = TrainingDriver(fresh(0), data_fn, ckpt, checkpoint_every=TRAINER_EVERY)
        t = time.perf_counter()
        first.run(TRAINER_STEPS)
        wall = time.perf_counter() - t
        files = sorted(p.name for p in Path(td).iterdir())
        second = TrainingDriver(fresh(1), data_fn, ckpt, checkpoint_every=TRAINER_EVERY)
        if second.start_step != TRAINER_STEPS or second.state.step != TRAINER_STEPS:
            raise AssertionError(f"restored at step {second.start_step}, expected {TRAINER_STEPS}")
        mine, theirs = first.state.model.state_dict(), second.state.model.state_dict()
        differ = [k for k in mine if not torch.equal(mine[k], theirs[k])]
        m1 = first.state.optimizer.state_dict()["state"]
        m2 = second.state.optimizer.state_dict()["state"]
        differ += [f"adam {i}" for i in m1
                   if not torch.equal(m1[i]["exp_avg_sq"], m2[i]["exp_avg_sq"])]
        if differ:
            raise AssertionError(f"restored state differs at {differ[:5]}")
        restored_step = second.start_step
        second.run(1)
    history = first.history + second.history
    if not all(np.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"non-finite loss in {history}")
    report = {"phase": "trainer", "model": "resnet18", "batch": TRAINER_BATCH,
              "checkpoint_every": TRAINER_EVERY, "checkpoints": files, "history": history,
              "steps_wall_s": wall, "restored_step": restored_step,
              "resumed_to_step": second.start_step}
    emit(report)
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "dmlc_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    from dmlc_tpu_torch.ops import flash as FL

    dev = phase_device()
    native_build = phase_build()
    kern = phase_kernels(dev)
    serve = phase_serve(dev, native_build)
    sdfs = phase_sdfs(dev, serve)
    cluster = phase_cluster(dev)
    gen = phase_generate(dev)
    decode = phase_decode(dev)
    train = phase_train(dev)
    small = phase_train_small(dev)
    phase_trainer(dev)
    norm = kern["normalize_u8"][torch.bfloat16]
    soft = kern["softmax_top1"]["float32"]
    gather = kern["gather_kv_pages"]["lm_wide"]
    rows = [
        {"name": "normalize_u8", "route": "cuda", "source": "dmlc_tpu_torch/csrc/normalize_u8.cu",
         "replaces": "dmlc_tpu/ops/pallas_kernels.py:50",
         "launches": serve["launches"]["normalize_u8"],
         "sdfs_launches": sdfs["launches"]["normalize_u8"],
         "cluster_launches": cluster["launches"]["normalize_u8"],
         "max_abs_err": norm["max_abs_err"], "max_err": norm["max_abs_err"],
         "ms": norm["ms"], "device_ms": norm["device_ms"], "host_us": norm["host_us"],
         "plain_ms": norm["plain_ms"], "bound_ms": norm["bound_ms"],
         "bound_by": norm["bound_by"], "library_ms": norm["library_ms"],
         "shape": [BATCH, SIZE, SIZE, 3], "out": "bfloat16",
         "f32_out": {k: kern["normalize_u8"][torch.float32][k]
                     for k in ("max_abs_err", "ms", "device_ms", "host_us", "plain_ms",
                               "library_ms", "bound_ms")}},
        {"name": "softmax_top1", "route": "cuda", "source": "dmlc_tpu_torch/csrc/softmax_top1.cu",
         "replaces": "dmlc_tpu/ops/pallas_kernels.py:97",
         "launches": serve["launches"]["softmax_top1"],
         "sdfs_launches": sdfs["launches"]["softmax_top1"],
         "cluster_launches": cluster["launches"]["softmax_top1"],
         "max_abs_err": soft["max_abs_err"], "max_err": soft["max_abs_err"],
         "ms": soft["ms"], "device_ms": soft["device_ms"], "host_us": soft["host_us"],
         "plain_ms": soft["plain_ms"], "bound_ms": soft["bound_ms"],
         "bound_by": soft["bound_by"], "library_ms": soft["library_ms"],
         "shape": [BATCH, NUM_CLASSES],
         **{k: soft[k] for k in ("warp_device_ms", "floor_device_ms", "queued_us",
                                 "warp_queued_us", "floor_queued_us", "warp_ms")},
         "launch_ab_queued_us": kern["softmax_top1"]["launch_ab_queued_us"],
         "bf16": kern["softmax_top1"]["bfloat16"], "cases": kern["softmax_top1"]["cases"],
         "cases_max_rel_err": kern["softmax_top1"]["cases_max_rel_err"]},
        # The engine's decode no longer gathers (paged_decode_attention reads
        # the pages): its main-path launches are 0 by design.
        {"name": "gather_kv_pages", "route": "cuda", "source": "dmlc_tpu_torch/csrc/gather_pages.cu",
         "replaces": "dmlc_tpu/ops/ragged_decode.py:49",
         "launches": gen["gather_launches"], "on_main_path": False,
         **{k: gather[k] for k in GATHER_KEYS}, "max_err": gather["max_abs_err"],
         "shape": [gather["pool"], gather["table"]],
         "bench_decode": {k: kern["gather_kv_pages"]["bench_decode"][k]
                          for k in ("pool", "table", "distinct_pages", *GATHER_KEYS)}},
    ]
    paged = kern["paged_decode_attention"]["timings"]
    paged_keys = ("max_abs_err", "ms", "device_ms", "host_us", "plain_ms", "parent_path_ms",
                  "library_ms", "bound_ms", "bound_by", "lengths")
    on_path = paged["lm_wide_dh128_float32"]
    rows.append({"name": "paged_decode_attention", "route": "cuda",
                 "source": "dmlc_tpu_torch/csrc/paged_decode.cu",
                 "replaces": "dmlc_tpu/ops/ragged_decode.py:49",
                 "replaces_also": "the XLA attention of dmlc_tpu/ops/ragged_decode.py:94",
                 "launches": gen["paged_launches"], "decode_launches": decode["paged_launches"],
                 **{k: on_path[k] for k in paged_keys}, "max_err": on_path["max_abs_err"],
                 "library": "scaled_dot_product_attention over the gathered view, length mask",
                 "shape": [on_path["pool"], on_path["table"]], "dtype": "float32",
                 **{key: {k: t[k] for k in paged_keys} for key, t in paged.items()
                    if key != "lm_wide_dh128_float32"}})
    timed = ("max_abs_err", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "tflops")
    timed_shape = ("shape", "kernel", *timed, "library_backend")
    fwd = kern["flash_forward"]
    # Launches: the train leg's (Dh 128, bf16); lm_small's legs (Dh 64)
    # beside them.
    small_launches = {dt: small[dt]["launches"] for dt in ("float32", "bfloat16")}
    rows.append({"name": "flash_forward", "route": "cuda",
                 "source": "dmlc_tpu_torch/csrc/flash_fwd.cu",
                 "replaces": "dmlc_tpu/ops/pallas_kernels.py:157 and :215",
                 "launches": train["launches"]["flash_forward"],
                 **{k: fwd["train_bf16"][k] for k in (*timed, "host_us")},
                 "max_err": fwd["train_bf16"]["max_abs_err"],
                 "shape": fwd["train_bf16"]["shape"], "dtype": "bfloat16",
                 "f32": {k: fwd["train_f32"][k] for k in (*timed, "host_us")},
                 "dh64_bf16": {k: fwd["dh64_bf16"][k] for k in timed_shape},
                 "dh64_f32": {k: fwd["dh64_f32"][k] for k in timed_shape},
                 "lm_small_launches": {dt: n["flash_forward"] for dt, n in small_launches.items()},
                 "streamed": {"shape": fwd["stream_bf16"]["shape"],
                              **{k: fwd["stream_bf16"][k] for k in timed}}})
    for name, line in (("flash_bwd_dq", 271), ("flash_bwd_dkv", 320)):
        rows.append({"name": name, "route": "cuda", "source": f"dmlc_tpu_torch/csrc/{name}.cu",
                     "replaces": f"dmlc_tpu/ops/pallas_kernels.py:{line}",
                     "launches": train["launches"][name],
                     **{k: kern[name][k] for k in (*timed, "host_us")},
                     "max_err": kern[name]["max_abs_err"],
                     "library_computes": kern[name]["library_computes"],
                     "shape": kern[name]["shape"], "dtype": "bfloat16",
                     "f32": {k: kern["backward_f32"][name][k] for k in (*timed, "host_us")},
                     "dh64_bf16": {k: kern["backward_dh64_bf16"][name][k] for k in timed_shape},
                     "dh64_f32": {k: kern["backward_dh64_f32"][name][k] for k in timed_shape},
                     "lm_small_launches": {dt: n[name] for dt, n in small_launches.items()}})
    # Past head dim 128: the three kernels built for 192 and 256 in both
    # dtypes (the train leg's FLOPs at 256, then at 192 and [4, 4, 1024,
    # Dh]), the forward's own past 256 and past 512, the dQ and dK/dV past
    # 256 in both dtypes and past 512 in float32, and the wide kernels
    # (csrc/flash_wide.cu) at [4, 4, 1024, 160] bf16 and at 160, 320, 384,
    # 512 and 640. Their launches are those the
    # main path's runs (the LM train leg and lm_small's, each counted from 0
    # just before it) made through these entry points at these head dims:
    # no registry model has heads past 128.
    main_entries: Counter = Counter()
    for run in (train, small["float32"], small["bfloat16"]):
        main_entries.update(run["entry_launches"])

    def main_launches(entry: str, dhs=None, dtype: str | None = None) -> int:
        total = 0
        for key, n in main_entries.items():
            e, dh, dt = key.split()
            if e == entry and (dhs is None or int(dh) in dhs) and dtype in (None, dt):
                total += n
        return total

    def timing(name: str, key: str) -> dict:
        return fwd[key] if name == "flash_forward" else kern[f"backward_{key}"][name]

    # The kernels built for 192 and 256: the bf16 Hopper ones, then the
    # float32 ones (each with the wide kernel it replaced there, timed
    # through its entry point in this run, where REPLACED_WIDE lists it).
    replaced = kern["replaced_wide"]
    for name, source, line, tag in (("flash_forward", "flash_fwd", "157 and :215", "bf16"),
                                    ("flash_bwd_dq", "flash_bwd_dq", "271", "bf16"),
                                    ("flash_bwd_dkv", "flash_bwd_dkv", "320", "bf16"),
                                    ("flash_forward", "flash_fwd", "157 and :215", "f32"),
                                    ("flash_bwd_dq", "flash_bwd_dq", "271", "f32"),
                                    ("flash_bwd_dkv", "flash_bwd_dkv", "320", "f32")):
        dtype = "bfloat16" if tag == "bf16" else "float32"
        launches = main_launches(source, FL.SM90_WIDE_HEAD_DIMS, dtype)
        first = timing(name, f"w256_{tag}")
        row = {"name": f"{name}_{'sm90' if tag == 'bf16' else 'f32'}_wide", "route": "cuda",
               "source": f"dmlc_tpu_torch/csrc/{source}.cu",
               "replaces": f"dmlc_tpu/ops/pallas_kernels.py:{line}", "launches": launches,
               "on_main_path": launches > 0, **{k: first[k] for k in timed_shape},
               "max_err": first["max_abs_err"], "dtype": dtype,
               **{key: {k: timing(name, key)[k] for k in timed_shape}
                  for key in (f"w192_{tag}", f"dh192_{tag}", f"dh256_{tag}")}}
        wide_entry = source.replace("flash_", "flash_wide_", 1)
        wide = {key: by_entry[wide_entry] for key, by_entry in replaced.items()
                if key.startswith(("w256", "w192")) and key.endswith(tag)
                and wide_entry in by_entry}
        if wide:
            row["replaced_wide_fma"] = wide
        rows.append(row)
    # The forward's own kernels past 256 (320, 384, 448, 512): at [4, 4,
    # 1024, 512], 320, 384 and the train leg's FLOPs at 384, each with the
    # wide forward it replaced there, timed through its entry point.
    for tag, dtype, design in (("bf16", "bfloat16", "sm90"), ("f32", "float32", "f32")):
        first = timing("flash_forward", f"dh512_{tag}")
        launches = main_launches("flash_fwd", FL.FWD_WIDE_HEAD_DIMS, dtype)
        keys = [f"{key}_{tag}" for key in ("dh512", "dh320", "dh384", "w384")]
        rows.append({"name": f"flash_forward_{design}_wide512", "route": "cuda",
                     "source": "dmlc_tpu_torch/csrc/flash_fwd.cu",
                     "replaces": "dmlc_tpu/ops/pallas_kernels.py:157 and :215",
                     "launches": launches, "on_main_path": launches > 0,
                     **{k: first[k] for k in timed_shape}, "max_err": first["max_abs_err"],
                     "dtype": dtype,
                     **{key: {k: timing("flash_forward", key)[k] for k in timed_shape}
                        for key in keys[1:]},
                     "replaced_wide_fma": {key: replaced[key]["flash_wide_fwd"] for key in keys}})
    # The forward's own kernels past 512, which take the head dim at run
    # time: at [4, 4, 1024, 640], 1024 and the train leg's FLOPs as one head
    # of 768, each with the wide forward it replaced there, timed through
    # its entry point.
    for tag, dtype, design in (("bf16", "bfloat16", "sm90"), ("f32", "float32", "f32")):
        first = timing("flash_forward", f"dh640_{tag}")
        launches = main_launches("flash_fwd", range(513, 1 << 20), dtype)
        keys = [f"{key}_{tag}" for key in ("dh640", "dh1024", "w768")]
        rows.append({"name": f"flash_forward_{design}_xl", "route": "cuda",
                     "source": "dmlc_tpu_torch/csrc/flash_fwd.cu",
                     "replaces": "dmlc_tpu/ops/pallas_kernels.py:157 and :215",
                     "launches": launches, "on_main_path": launches > 0,
                     **{k: first[k] for k in timed_shape}, "max_err": first["max_abs_err"],
                     "dtype": dtype,
                     **{key: {k: timing("flash_forward", key)[k] for k in timed_shape}
                        for key in keys[1:]},
                     "replaced_wide_fma": {key: replaced[key]["flash_wide_fwd"] for key in keys}})
    # The dQ and dK/dV built past 256 (320, 384, 448, 512), the bf16 Hopper
    # ones and the float32 ones: at [4, 4, 1024, 512], 320, 384 and the
    # train leg's FLOPs at 384, each with the wide kernel it replaced there,
    # timed through its entry point.
    for tag, dtype, design in (("bf16", "bfloat16", "sm90"), ("f32", "float32", "f32")):
        for name, line, wide_entry in (("flash_bwd_dq", "271", "flash_wide_bwd_dq"),
                                       ("flash_bwd_dkv", "320", "flash_wide_bwd_dkv")):
            first = timing(name, f"dh512_{tag}")
            launches = main_launches(name, FL.FWD_WIDE_HEAD_DIMS, dtype)
            keys = [f"{key}_{tag}" for key in ("dh512", "dh320", "dh384", "w384")]
            rows.append({"name": f"{name}_{design}_wide512", "route": "cuda",
                         "source": f"dmlc_tpu_torch/csrc/{name}.cu",
                         "replaces": f"dmlc_tpu/ops/pallas_kernels.py:{line}",
                         "launches": launches, "on_main_path": launches > 0,
                         **{k: first[k] for k in timed_shape}, "max_err": first["max_abs_err"],
                         "dtype": dtype,
                         **{key: {k: timing(name, key)[k] for k in timed_shape}
                            for key in keys[1:]},
                         "replaced_wide_fma": {key: replaced[key][wide_entry] for key in keys}})
    # The dQ and dK/dV past 512, which take the head dim at run time, the
    # float32 ones and the bf16 Hopper ones: at [4, 4, 1024, 640], 1024 and
    # the train leg's FLOPs as one head of 768, each with the wide kernel it
    # replaced there, timed through its entry point.
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        for name, line, wide_entry in (("flash_bwd_dq", "271", "flash_wide_bwd_dq"),
                                       ("flash_bwd_dkv", "320", "flash_wide_bwd_dkv")):
            first = timing(name, f"dh640_{tag}")
            launches = main_launches(name, range(513, 1 << 20), dtype)
            keys = [f"{key}_{tag}" for key in ("dh640", "dh1024", "w768")]
            rows.append({"name": f"{name}_{tag}_xl", "route": "cuda",
                         "source": f"dmlc_tpu_torch/csrc/{name}.cu",
                         "replaces": f"dmlc_tpu/ops/pallas_kernels.py:{line}",
                         "launches": launches, "on_main_path": launches > 0,
                         **{k: first[k] for k in timed_shape}, "max_err": first["max_abs_err"],
                         "dtype": dtype,
                         **{key: {k: timing(name, key)[k] for k in timed_shape}
                            for key in keys[1:]},
                         "replaced_wide_fma": {key: replaced[key][wide_entry] for key in keys}})
    for name, entry, line in (("flash_forward", "flash_wide_fwd", "157 and :215"),
                              ("flash_bwd_dq", "flash_wide_bwd_dq", "271"),
                              ("flash_bwd_dkv", "flash_wide_bwd_dkv", "320")):
        first = timing(name, "dh160_bf16")
        launches = main_launches(entry)
        # Through the wrappers at 160 (a direct call) in both dtypes; past
        # 256 through their entry points (device time; replaced_wide_fma of
        # the rows above).
        others = ("dh160_f32",)
        row = {"name": f"{name}_wide_fma", "route": "cuda",
               "source": "dmlc_tpu_torch/csrc/flash_wide.cu",
               "replaces": f"dmlc_tpu/ops/pallas_kernels.py:{line}", "launches": launches,
               "on_main_path": launches > 0, **{k: first[k] for k in timed_shape},
               "max_err": first["max_abs_err"], "dtype": "bfloat16",
               **{key: {k: timing(name, key)[k] for k in timed_shape} for key in others}}
        past = ("dh320", "dh384", "dh512", "w384", "dh640", "dh1024", "w768")
        row["entry_point"] = {key: replaced[key][entry] for key in replaced
                              if key.startswith(past) and entry in replaced[key]}
        rows.append(row)
    print(dev["nvidia_smi"], flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
