#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dmlc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script exits
non-zero:

1. device  — the card's name, power limit and the TF32 settings in force.
2. build   — compiles every kernel in dmlc_tpu_torch/csrc with nvcc.
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes its path gives it, with its time, its bound, the plain
   version's time and one library call's (CUDA events, median over
   repeated runs after a warm-up).
4. serve   — job.predict through PredictWorker -> EngineBackend ->
   InferenceEngine for resnet18 and alexnet at batch 256, 224 px, bf16,
   seeded weights: multi-batch shards take seeded pixels from a decode
   tier, one shard decodes a small JPEG corpus. Launch counters are zeroed
   just before the requests and must have risen just after; the answers
   are held against the same pixels sent through the plain versions.
   Then CUDA events time each engine's host-to-device copy and forward,
   which bound the device's idle share of run_batch and of one request
   from below; one traced run_batch per model and one traced request give
   the device time by kernel (torch.profiler).
5. the card's name and power limit as nvidia-smi prints them, the kernels
   line, and the final {"ok": true, ...} line.

It needs one CUDA device and exits non-zero, printing no result, without
one or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
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
# Greedy steps whose top-two logit gap is at most this are counted as ties.
TIE_GAP = 1e-4
# Decode-bench geometry (bench.py:bench_lm_decode and its lm_bench_decode).
BENCH_LAYERS, BENCH_HEADS, BENCH_HIDDEN, BENCH_MLP = 8, 6, 768, 3072
BENCH_VOCAB, BENCH_MAX_LEN = 32768, 1024
BENCH_SLOTS, BENCH_REQUESTS, BENCH_PROMPT, BENCH_NEW, BENCH_PAGE = 8, 16, 128, 128, 64
# Published rates of the cards this runs on (NVIDIA data sheets):
# memory bytes/s and float32 (non-tensor) FLOP/s.
CARDS = {
    "H100 80GB HBM3": (3.35e12, 67e12),   # H100 SXM
    "H100 SXM": (3.35e12, 67e12),
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H200": (4.8e12, 67e12),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_rates(name: str) -> tuple[float, float]:
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


def device_records(prof) -> list[tuple[str, float, float]]:
    """(name, start us, duration us) of every device record of a finished
    torch.profiler run, from Kineto's raw results: the FunctionEvent view
    drops some of them (a pageable host-to-device copy, for one)."""
    return [(k.name(), k.start_ns() / 1e3, k.duration_ns() / 1e3)
            for k in prof.profiler.kineto_results.events()
            if k.device_type() == torch.autograd.DeviceType.CUDA]


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


def kernel_device_ms(fn, name: str, calls: int = 20, flush: torch.Tensor | None = None) -> float:
    """Mean device time of kernel ``name`` over ``calls`` calls of ``fn``,
    from the profiler's kernel records (the host's call overhead excluded).
    With ``flush`` (a buffer larger than the 50 MB L2), the buffer is
    overwritten before each call, so the kernel finds its inputs cold."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    # The trace can drop a record (device_records); the mean is over those
    # it kept, and too few of them fail the run.
    times = [dur for kernel, _, dur in device_records(prof) if name in kernel]
    if not calls // 2 <= len(times) <= calls:
        raise AssertionError(f"{name}: profiler saw {len(times)} launches of {calls}")
    return statistics.fmean(times) / 1e3


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
    bw, fp32 = card_rates(name)
    info = {
        "phase": "device", "kind": name, "count": torch.cuda.device_count(),
        "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "allow_tf32": {"cudnn": False, "matmul": False},
        "mem_bytes_per_s": bw, "fp32_flops_per_s": fp32,
    }
    emit(info)
    return info


def phase_build() -> None:
    from dmlc_tpu_torch.ops import _build

    seconds = _build.build()
    regs = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for name, log in _build.build_log.items()
    }
    emit({"phase": "build", "seconds": seconds, "kernels": _build.kernel_names(),
          "ptxas": regs})


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

    logits =torch.randn(BATCH, NUM_CLASSES, device="cuda", generator=gen) * 4
    logits[0, [5, 7]] = logits[0].max() + 1.0           # tie: first index wins
    logits[1] = 0.25                                    # a whole row tied
    logits[2, :4] = torch.tensor([1e4, -1e4, 0.0, 9.9e3])  # extreme logits
    logits[3] = -1e4
    logits[3, [500, 999]] = 1e4                         # extreme tie
    idx, prob = K.softmax_top1(logits)
    ridx, rprob = K.softmax_top1_reference(logits)
    torch.cuda.synchronize()
    if not torch.equal(idx, ridx):
        raise AssertionError("softmax_top1: indices differ from the plain version")
    if idx[:4].tolist() != [5, 0, 0, 500]:
        raise AssertionError(f"softmax_top1: tie/extreme rows gave {idx[:4].tolist()}")
    rel = float(((prob - rprob).abs() / rprob).max())
    if not (torch.isfinite(prob).all() and rel <= PROB_RTOL):
        raise AssertionError(f"softmax_top1: probability rel err {rel} > {PROB_RTOL}")
    n = logits.numel()
    nbytes = n * 4 + BATCH * 8
    ops = 4 * n  # compare, subtract, exp, add per logit
    soft = {
        "max_abs_err": float((prob - rprob).abs().max()), "max_rel_err": rel, "tol": PROB_RTOL,
        "ms": time_ms(lambda: K.softmax_top1(logits)),
        "device_ms": kernel_device_ms(lambda: K.softmax_top1(logits), "softmax_top1_kernel"),
        "plain_ms": time_ms(lambda: K.softmax_top1_reference(logits)),
        "library_ms": time_ms(lambda: torch.softmax(logits, -1).max(-1)),
        "bound_ms": max(nbytes / bw, ops / fp32) * 1e3,
        "bound_by": "bytes" if nbytes / bw >= ops / fp32 else "operations",
    }
    gather = phase_kernels_gather(bw)
    result = {"normalize_u8": norm, "softmax_top1": soft, "gather_kv_pages": gather}
    emit({"phase": "kernels",
          "normalize_u8": {str(k).replace("torch.", ""): v for k, v in norm.items()},
          "softmax_top1": soft, "gather_kv_pages": gather})
    return result


def full_cache_table(slots: int, pages_per_slot: int, usable: int, in_use: int,
                     rng: np.random.Generator) -> np.ndarray:
    """A page table as the engine holds it: each slot's first ``in_use``
    entries are distinct pages drawn from the ``usable`` allocatable ones
    (1..usable), the rest point at the scratch page 0."""
    table = np.zeros((slots, pages_per_slot), np.int32)
    ids = rng.permutation(np.arange(1, usable + 1))[: slots * in_use].astype(np.int32)
    table[:, :in_use] = ids.reshape(slots, in_use)
    return table


def gather_timing(pool: torch.Tensor, table: np.ndarray, bw: float) -> dict:
    """The page gather against its plain version at one shape, with its
    times. The bound counts what this table needs: each distinct page it
    names read once, the table read once, the output written once."""
    from dmlc_tpu_torch.ops import ragged_decode as RD

    ids = torch.from_numpy(table).to(pool.device)
    got = RD.gather_kv_pages(pool, ids)
    want = RD.gather_kv_pages_reference(pool, ids)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"gather_kv_pages differs from its plain version at {tuple(pool.shape)}")
    page_bytes = pool[0].numel() * pool.element_size()
    nbytes = len(np.unique(table)) * page_bytes + table.nbytes + got.numel() * got.element_size()
    flat = ids.reshape(-1)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=pool.device)
    return {
        "pool": list(pool.shape), "table": list(table.shape), "dtype": str(pool.dtype),
        "distinct_pages": int(len(np.unique(table))), "max_abs_err": 0.0,
        "ms": time_ms(lambda: RD.gather_kv_pages(pool, ids)),
        "device_ms": kernel_device_ms(lambda: RD.gather_kv_pages(pool, ids),
                                      "gather_pages_vec16_kernel"),
        "device_ms_cold_l2": kernel_device_ms(lambda: RD.gather_kv_pages(pool, ids),
                                              "gather_pages_vec16_kernel", flush=flush),
        "plain_ms": time_ms(lambda: RD.gather_kv_pages_reference(pool, ids)),
        "library_ms": time_ms(lambda: torch.index_select(pool, 0, flat)),
        "bound_ms": nbytes / bw * 1e3, "bound_by": "bytes",
    }


def phase_kernels_gather(bw: float) -> dict:
    """gather_kv_pages on the card: equal to its plain version at lm_wide's
    serving shape and at the decode-bench shape (timed), in bf16, with
    repeated and scratch ids, and on the byte path (a page whose length is
    not a multiple of 16 bytes, and a pool 4 bytes off alignment)."""
    from dmlc_tpu_torch.ops import ragged_decode as RD

    gen = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(1)
    wide_pool = torch.randn(GEN_PAGES, GEN_PAGE, 4, 128, device="cuda", generator=gen)
    wide_table = full_cache_table(GEN_SLOTS, 128 // GEN_PAGE, GEN_PAGES - 1, 128 // GEN_PAGE, rng)
    wide = gather_timing(wide_pool, wide_table, bw)
    bench_pages = BENCH_REQUESTS * -(-(BENCH_PROMPT + BENCH_NEW + 1) // BENCH_PAGE) + BENCH_SLOTS + 1
    bench_pool = torch.randn(bench_pages, BENCH_PAGE, BENCH_HEADS, 128, device="cuda",
                             generator=gen)
    in_use = -(-(BENCH_PROMPT + BENCH_NEW) // BENCH_PAGE)
    bench_table = full_cache_table(BENCH_SLOTS, BENCH_MAX_LEN // BENCH_PAGE, bench_pages - 1,
                                   in_use, rng)
    bench = gather_timing(bench_pool, bench_table, bw)
    del bench_pool

    repeats = np.array([[3, 3, 0, 0, 7, 127, 0, 3]] * 2 + [[0] * 8], np.int32)
    flat = torch.randn(7 * 3 * 1 * 3 + 1, device="cuda", generator=gen)
    cases = [
        (wide_pool.to(torch.bfloat16), wide_table),
        (wide_pool.to(torch.bfloat16), repeats),
        (wide_pool, repeats),
        (flat[:-1].view(7, 3, 1, 3), np.array([[6, 0, 2], [2, 2, 5]], np.int32)),  # 36-byte pages
        (flat[1:].view(7, 3, 1, 3), np.array([[1, 4, 0]], np.int32)),  # pool 4 bytes off 16
    ]
    for pool, table in cases:
        ids = torch.from_numpy(table).to("cuda")
        if not torch.equal(RD.gather_kv_pages(pool, ids), RD.gather_kv_pages_reference(pool, ids)):
            raise AssertionError(f"gather_kv_pages differs on {pool.dtype} {tuple(pool.shape)}")
    torch.cuda.synchronize()
    return {"lm_wide": wide, "bench_decode": bench, "exact_cases": len(cases) + 2}


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


def phase_serve(dev: dict) -> dict:
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.ops import preprocess as pp
    from dmlc_tpu_torch.scheduler.worker import EngineBackend, PredictWorker
    from dmlc_tpu_torch.utils import corpus

    with tempfile.TemporaryDirectory(prefix="dmlc-torch-smoke-") as td:
        data_dir, synset_path = corpus.generate(Path(td), n_classes=200, images_per_class=1,
                                                size=256, seed=0)
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
        worker = PredictWorker(backends)
        predict = worker.methods()["job.predict"]
        requests = [
            ("resnet18", [f"seed_{k}" for k in range(600)], "decode_tier"),
            ("alexnet", [f"seed_{k}" for k in range(1000, 1300)], "decode_tier"),
            ("resnet18", [f"seed_{k}" for k in range(2000, 2257)], "decode_tier"),
            ("resnet18", jpeg_synsets, "jpeg"),
        ]

        K.reset_launch_counts()
        answers = []
        for model, synsets, source_kind in requests:
            t = time.perf_counter()
            preds = predict({"model": model, "synsets": synsets})["predictions"]
            answers.append((model, synsets, source_kind, preds, time.perf_counter() - t))
        launches = {k: K.launch_counts()[k] for k in PREDICT_KERNELS}
        for name, count in launches.items():
            if count == 0:
                raise AssertionError(f"{name}: no launch on the serving path")

        reports = []
        for model, synsets, source_kind, preds, wall in answers:
            engine = backends[model].engine
            paths = source(synsets)
            pixels = (source.decode_paths(paths, SIZE) if source_kind == "decode_tier"
                      else pp.load_batch(paths, size=SIZE))
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
                "batches": -(-len(synsets) // BATCH), "wall_s": wall,
                "img_per_s": len(synsets) / wall, "rows": len(preds),
                "compared_rows": int(mask.sum()), "distinct_classes": int(len(set(preds.tolist()))),
            })

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
             "launches": launches, "requests": reports, "throughput": throughput,
             "traced_request": traced}
    emit(serve)
    return serve


class LocalRpc:
    """Stands in for the RPC fabric, which the port does not have yet:
    ``call`` runs the worker's method on the caller's thread."""

    def __init__(self, methods: dict):
        self.methods = methods

    def call(self, addr, method, payload, timeout=None):
        return self.methods[method](dict(payload))


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


def run_clients(rpc, model: str, reqs) -> tuple[dict, dict, float]:
    """One generate_stream client thread per request, all started together."""
    from dmlc_tpu_torch.generate.worker import generate

    results: dict[int, list[int]] = {}
    errors: dict[int, str] = {}

    def run(i: int) -> None:
        prompt, n, temp, seed = reqs[i]
        try:
            results[i] = generate(rpc, "member", model, prompt, max_new_tokens=n,
                                  temperature=temp, seed=seed, poll_interval_s=0.005)
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
    try:
        K.reset_launch_counts()
        results, errors, wall = run_clients(LocalRpc(worker.methods()), model_name, reqs)
        launches = K.launch_counts()
        steps = engine.steps
        stream_errors = [s.stream.error for s in worker._sessions.values()]
        summary = backend.summary()
    finally:
        backend.stop()
    if errors:
        raise AssertionError(f"generate clients failed: {errors}")
    if len(stream_errors) != GEN_REQUESTS or any(e is not None for e in stream_errors):
        raise AssertionError(f"stream errors: {stream_errors}")
    for i, (_, n, _, _) in enumerate(reqs):
        if len(results[i]) != n or not all(0 <= t < engine.vocab for t in results[i]):
            raise AssertionError(f"request {i}: {len(results[i])} tokens of {n}, or out of vocab")
    want_launches = 2 * engine.num_layers * steps
    if steps == 0 or launches["gather_kv_pages"] != want_launches:
        raise AssertionError(f"gather_kv_pages launched {launches['gather_kv_pages']} times, "
                             f"expected 2 x {engine.num_layers} layers x {steps} steps")
    if summary["sheds"] or summary["evictions"]:
        raise AssertionError(f"sheds/evictions in the generate phase: {summary}")

    # The same requests on a contiguous-cache engine (no gather kernel).
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
        "slots": GEN_SLOTS, "page_size": GEN_PAGE, "num_pages": GEN_PAGES,
        "max_prefill": GEN_PREFILL, "engine_build_s": build_s,
        "requests": len(reqs), "greedy": len(greedy), "sampled": len(sampled),
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall, "steps": steps,
        "gather_launches": launches["gather_kv_pages"],
        "gather_launches_per_step": 2 * engine.num_layers,
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
        launches = K.launch_counts()["gather_kv_pages"]
        steps = engine.steps - steps0
        stats = sched.step_stats
    finally:
        sched.stop()
    if any(len(o) != BENCH_NEW for o in outs):
        raise AssertionError("a decode-bench request came back short")
    if launches != 2 * BENCH_LAYERS * steps:
        raise AssertionError(f"gather launched {launches} times in {steps} steps")

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
    # writes): an upper bound on one step's device time.
    device_ms = time_ms(lambda: engine._decode(regs[0], regs[1], regs[2].bool(), table),
                        reps=11, inner=5)
    gather_ms = time_ms(lambda: K.KERNELS["gather_kv_pages"](engine.cache.k_pages[0], table),
                        reps=11, inner=5)
    profile = profile_call(one_step)
    tokens = sum(len(o) for o in outs)
    report = {
        "phase": "decode", "model": name, "nvidia_smi": dev["nvidia_smi"],
        "geometry": {"layers": BENCH_LAYERS, "heads": BENCH_HEADS, "hidden": BENCH_HIDDEN,
                     "mlp": BENCH_MLP, "vocab": BENCH_VOCAB, "max_len": BENCH_MAX_LEN},
        "slots": BENCH_SLOTS, "requests": BENCH_REQUESTS, "prompt": BENCH_PROMPT,
        "new_tokens": BENCH_NEW, "page_size": BENCH_PAGE, "num_pages": num_pages,
        "engine_build_s": build_s, "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "steps": steps, "gather_launches": launches,
        "step_ms_p50": stats.percentile(50) * 1e3, "step_ms_p99": stats.percentile(99) * 1e3,
        "one_step": {
            "lengths": int(engine.lengths[0]), "wall_ms": step_wall_ms,
            "device_ms_at_most": device_ms,
            "idle_share_at_least": 1.0 - device_ms / step_wall_ms,
            "gather_call_ms": gather_ms, "gathers": 2 * BENCH_LAYERS,
            "profile": profile,
        },
    }
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
    dev = phase_device()
    phase_build()
    kern = phase_kernels(dev)
    serve = phase_serve(dev)
    gen = phase_generate(dev)
    phase_decode(dev)
    norm = kern["normalize_u8"][torch.bfloat16]
    soft = kern["softmax_top1"]
    gather = kern["gather_kv_pages"]["lm_wide"]
    rows = [
        {"name": "normalize_u8", "route": "cuda", "source": "dmlc_tpu_torch/csrc/normalize_u8.cu",
         "replaces": "dmlc_tpu/ops/pallas_kernels.py:50",
         "launches": serve["launches"]["normalize_u8"],
         "max_abs_err": norm["max_abs_err"], "max_err": norm["max_abs_err"],
         "ms": norm["ms"], "device_ms": norm["device_ms"],
         "plain_ms": norm["plain_ms"], "bound_ms": norm["bound_ms"],
         "bound_by": norm["bound_by"], "library_ms": norm["library_ms"],
         "shape": [BATCH, SIZE, SIZE, 3], "out": "bfloat16",
         "f32_out": {k: kern["normalize_u8"][torch.float32][k]
                     for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
                               "bound_ms")}},
        {"name": "softmax_top1", "route": "cuda", "source": "dmlc_tpu_torch/csrc/softmax_top1.cu",
         "replaces": "dmlc_tpu/ops/pallas_kernels.py:97",
         "launches": serve["launches"]["softmax_top1"],
         "max_abs_err": soft["max_abs_err"], "max_err": soft["max_abs_err"],
         "ms": soft["ms"], "device_ms": soft["device_ms"],
         "plain_ms": soft["plain_ms"], "bound_ms": soft["bound_ms"],
         "bound_by": soft["bound_by"], "library_ms": soft["library_ms"],
         "shape": [BATCH, NUM_CLASSES]},
        {"name": "gather_kv_pages", "route": "cuda", "source": "dmlc_tpu_torch/csrc/gather_pages.cu",
         "replaces": "dmlc_tpu/ops/ragged_decode.py:49",
         "launches": gen["gather_launches"],
         "max_abs_err": gather["max_abs_err"], "max_err": gather["max_abs_err"],
         "ms": gather["ms"], "device_ms": gather["device_ms"],
         "device_ms_cold_l2": gather["device_ms_cold_l2"],
         "plain_ms": gather["plain_ms"], "bound_ms": gather["bound_ms"],
         "bound_by": gather["bound_by"], "library_ms": gather["library_ms"],
         "shape": [gather["pool"], gather["table"]],
         "bench_decode": {k: kern["gather_kv_pages"]["bench_decode"][k]
                          for k in ("pool", "table", "distinct_pages", "ms", "device_ms",
                                    "device_ms_cold_l2", "plain_ms", "library_ms",
                                    "bound_ms")}},
    ]
    print(dev["nvidia_smi"], flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
