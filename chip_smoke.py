#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dmlc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script exits
non-zero:

1. device  — the card's name, power limit and the TF32 settings in force.
2. build   — compiles every kernel in dmlc_tpu_torch/csrc with nvcc.
3. kernels — each kernel against its plain PyTorch version on the card at
   the serving shapes, with its time, its bound and the plain version's
   time (CUDA events, median over repeated runs after a warm-up).
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


def kernel_device_ms(fn, name: str, calls: int = 20) -> float:
    """Mean device time of kernel ``name`` over ``calls`` calls of ``fn``,
    from the profiler's CUDA events (the host's call overhead excluded)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [dur for kernel, _, dur in device_records(prof) if name in kernel]
    if len(times) != calls:
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
    result = {"normalize_u8": norm, "softmax_top1": soft}
    emit({"phase": "kernels",
          "normalize_u8": {str(k).replace("torch.", ""): v for k, v in norm.items()},
          "softmax_top1": soft})
    return result


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
        launches = K.launch_counts()
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
    norm = kern["normalize_u8"][torch.bfloat16]
    soft = kern["softmax_top1"]
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
    ]
    print(dev["nvidia_smi"], flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
