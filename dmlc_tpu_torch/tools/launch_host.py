#!/usr/bin/env python3
"""Times each part of the kernel wrappers' launch path on the host's clock, on the card.

    python3 dmlc_tpu_torch/tools/launch_host.py [--calls N]
    python3 dmlc_tpu_torch/tools/launch_host.py --parent OPS_DIR SCRATCH_DIR [--calls N]

For ``gather_kv_pages`` at lm_wide's serving shape and at the decode
bench's (chip_smoke.phase_kernels_gather's pools and tables),
``paged_decode_attention`` at both geometries of chip_smoke.PAGED_GEOMETRIES
(float32, head dim 128) and ``softmax_top1`` at the serve shape [256,
1000], it times the whole wrapper call and each part of it on its own, as
the ops/ it runs on lays the call out: the checks, the device guard, the
stream lookup, the output and scratch allocation, the ctypes call
(argument conversion and cudaLaunchKernel inside) and the count. Each is
``chip_smoke.host_us``: the median of the mean over batches of 100
back-to-back calls, N calls in all (default 2000). It also times
candidate pieces of a launch path (the raw stream pointer, the device
index read three ways, one entry point loaded with ctypes.CDLL against
ctypes.PyDLL).

With --parent, OPS_DIR is an earlier ops/ (e.g. from ``git archive``):
the checkout's package is copied into SCRATCH_DIR (outside the checkout)
as ``dmlc_tpu_torch_parent``, with OPS_DIR's modules in place of its ops/,
and both launch paths are timed in one process, in rounds that time one
batch of each part of each path in turn (the host's clock drifts with the
load of the machine; in turns within one process both see the same
drift). Prints one JSON line. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _layout(K) -> str:
    """Which launch path ``ops/kernels.py`` holds: ``raw_stream`` (the
    stream pointer read with one call, devices compared as indices) or
    ``stream_object`` (a ``torch.cuda.Stream`` built each launch)."""
    return "raw_stream" if hasattr(K, "_raw_stream") else "stream_object"


def _inputs(cs):
    """The timed cases: name -> (kind, inputs)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    wide_pool = torch.randn(cs.GEN_PAGES, cs.GEN_PAGE, 4, 128, device="cuda", generator=gen)
    wide_table = cs.full_cache_table(cs.GEN_SLOTS, 128 // cs.GEN_PAGE, cs.GEN_PAGES - 1,
                                     128 // cs.GEN_PAGE, rng)
    slots, page, pages, heads, cols, in_use = cs.PAGED_GEOMETRIES["bench_decode"]
    bench_pool = torch.randn(pages, page, heads, 128, device="cuda", generator=gen)
    bench_table = cs.full_cache_table(slots, cols, pages - 1, in_use, rng)
    cases = {
        "gather_lm_wide": ("gather", (wide_pool, torch.from_numpy(wide_table).cuda())),
        "gather_bench": ("gather", (bench_pool, torch.from_numpy(bench_table).cuda())),
    }
    for geometry in cs.PAGED_GEOMETRIES:
        uniform = np.full(cs.PAGED_GEOMETRIES[geometry][0], cs.PAGED_BENCH_LENGTH)
        x = cs.paged_inputs(geometry, torch.float32, 128,
                            uniform if geometry == "bench_decode" else None, seed=1)
        cases[f"paged_{geometry}"] = ("paged", (x["q"], x["k"], x["v"], x["table"],
                                                x["lengths"]))
    logits = torch.randn(cs.BATCH, cs.NUM_CLASSES, device="cuda", generator=gen)
    cases["softmax_top1"] = ("softmax", (logits,))
    return cases


def _parts(layout, kind, args, K, RD):
    """Each part of one wrapper call, as ``layout`` lays it out, and the
    whole call. ``stream_object`` (the earlier ops/): checks that read
    ``t.device`` per tensor, ``t.device.index == current_device()``,
    ``torch.cuda.current_stream().cuda_stream``, one ``torch.empty`` an
    output or scratch buffer. ``raw_stream``: the checks read each device
    as an index, ``get_device() == _cuda_getDevice()``, the raw stream
    pointer, outputs from the input's ``new_empty``, the paged kernel's
    output and scratch as views of one."""
    import torch

    t = args[0]
    index = t.get_device()
    stream = torch.cuda.current_stream().cuda_stream
    if layout == "stream_object":
        parts = {"guard": lambda: t.device.index == torch.cuda.current_device(),
                 "stream": lambda: torch.cuda.current_stream().cuda_stream}
    else:
        parts = {"guard": lambda: t.get_device() == torch._C._cuda_getDevice(),
                 "stream": lambda: K._raw_stream(index)}
    if kind == "gather":
        pool, ids = args
        b, mp = ids.shape
        _, ps, h, dh = pool.shape
        out = torch.empty((b, mp * ps, h, dh), dtype=pool.dtype, device=pool.device)
        page_bytes = ps * h * dh * pool.element_size()
        _, fn = K._entry("gather_pages")
        new = layout != "stream_object"

        def count():
            RD.gather_kv_pages.launches += 1

        parts.update(
            checks=lambda: RD._check_gather(pool, ids),
            alloc=(lambda: pool.new_empty((b, mp * ps, h, dh))) if new else
            (lambda: torch.empty((b, mp * ps, h, dh), dtype=pool.dtype, device=pool.device)),
            ctypes=lambda: fn(pool.data_ptr(), pool.shape[0], page_bytes, ids.data_ptr(),
                              b * mp, out.data_ptr(), stream),
            count=count)
        return parts, lambda: RD.gather_kv_pages(pool, ids)
    if kind == "paged":
        q, k, v, table, lens = args
        b, h, dh = q.shape
        mp, ps = table.shape[1], k.shape[1]
        nsplit = -(-mp * ps // RD._paged_split())
        out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
        scratch = torch.empty(b * h * nsplit * (dh + 2), dtype=torch.float32, device=q.device)
        _, fn = K._entry("paged_decode")

        def count():
            RD.paged_decode_attention.launches += 1

        def alloc_two():
            torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
            n = -(-mp * ps // RD._paged_split())
            torch.empty(b * h * n * (dh + 2), dtype=torch.float32, device=q.device)

        def alloc_one():
            n = -(-mp * ps // RD._paged_split())
            item = q.element_size()
            out_elems = -(-b * h * dh * item // 16) * 16 // item
            buf = q.new_empty(out_elems + b * h * n * (dh + 2) * 4 // item)
            buf.as_strided((b, h, dh), (h * dh, dh, 1))

        parts.update(
            checks=lambda: RD._check_paged(q, k, v, table, lens),
            alloc=alloc_two if layout == "stream_object" else alloc_one,
            ctypes=lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k.shape[0], ps, h, dh,
                              table.data_ptr(), b, mp, lens.data_ptr(), 0, dh ** -0.5, 0,
                              scratch.data_ptr(), out.data_ptr(), stream),
            count=count)
        return parts, lambda: RD.paged_decode_attention(q, k, v, table, lens)
    (logits,) = args
    b, c = logits.shape
    idx = torch.empty(b, dtype=torch.int32, device=logits.device)
    prob = torch.empty(b, dtype=torch.float32, device=logits.device)
    _, fn = K._entry("softmax_top1")

    def count():
        K.softmax_top1.launches += 1

    def alloc():
        if layout == "stream_object":
            torch.empty(b, dtype=torch.int32, device=logits.device)
            torch.empty(b, dtype=torch.float32, device=logits.device)
        else:
            logits.new_empty(b, dtype=torch.int32)
            logits.new_empty(b)

    parts.update(
        checks=lambda: K._check_logits(logits),
        alloc=alloc,
        ctypes=lambda: fn(logits.data_ptr(), b, c, idx.data_ptr(), prob.data_ptr(), stream),
        count=count)
    return parts, lambda: K.softmax_top1(logits)


def _candidates(cs, K, cases) -> dict:
    """Host time of pieces a launch path can be built from, on the gather's
    lm_wide inputs."""
    import torch

    pool, ids = cases["gather_lm_wide"][1]
    index = pool.get_device()
    b, mp = ids.shape
    _, ps, h, dh = pool.shape
    out = torch.empty((b, mp * ps, h, dh), dtype=pool.dtype, device=pool.device)
    args = (pool.data_ptr(), pool.shape[0], ps * h * dh * pool.element_size(), ids.data_ptr(),
            b * mp, out.data_ptr())
    from dmlc_tpu_torch.ops import _build

    path = str(_build.library_path("gather_pages"))
    symbol, argtypes = K._SIGNATURES["gather_pages"]
    loaded = {}
    for name, loader in (("cdll", ctypes.CDLL), ("pydll", ctypes.PyDLL)):
        fn = getattr(loader(path), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        loaded[name] = fn
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = torch.cuda.current_stream().cuda_stream
    pieces = {
        "empty_loop": lambda: None,
        "current_stream_object": lambda: torch.cuda.current_stream().cuda_stream,
        "current_device": lambda: torch.cuda.current_device(),
        "c_get_device": lambda: torch._C._cuda_getDevice(),
        "t_device_index": lambda: pool.device.index,
        "t_get_device": lambda: pool.get_device(),
        "t_is_cuda": lambda: pool.is_cuda,
        "t_device_compare": lambda: ids.device != pool.device,
        "t_is_contiguous": lambda: pool.is_contiguous(),
        "t_data_ptr": lambda: pool.data_ptr(),
        "empty_device_object": lambda: torch.empty(out.shape, dtype=pool.dtype,
                                                   device=pool.device),
        "empty_device_index": lambda: torch.empty(out.shape, dtype=pool.dtype, device=index),
        "empty_new_empty": lambda: pool.new_empty(out.shape),
        "empty_small": lambda: torch.empty(b, dtype=torch.int32, device=index),
        "new_empty_small": lambda: pool.new_empty(b, dtype=torch.int32),
        "slice": lambda: out[:4],
        "view_dtype": lambda: out.view(torch.int32),
        "as_strided": lambda: out.as_strided((b, 4), (4, 1)),
        "ctypes_cdll": lambda: loaded["cdll"](*args, stream),
        "ctypes_pydll": lambda: loaded["pydll"](*args, stream),
        "ctypes_cdll_again": lambda: loaded["cdll"](*args, stream),
        "ctypes_pydll_again": lambda: loaded["pydll"](*args, stream),
    }
    if raw is not None:
        pieces["raw_stream"] = lambda: raw(index)
    report = {"has_raw_stream": raw is not None}
    for name, fn in pieces.items():
        report[name] = cs.host_us(fn, calls=2000)
    return report


def _parent_package(ops: Path, scratch: Path) -> str:
    """A copy of the checkout's package under ``scratch`` named
    ``dmlc_tpu_torch_parent``, with ``ops``'s modules in place of its ops/
    and its imports renamed, so that both import into one process."""
    dest = scratch / "dmlc_tpu_torch_parent"
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(REPO / "dmlc_tpu_torch", dest,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for module in ops.glob("*.py"):
        shutil.copy2(module, dest / "ops" / module.name)
    for module in dest.rglob("*.py"):
        module.write_text(module.read_text().replace("dmlc_tpu_torch", "dmlc_tpu_torch_parent"))
    return dest.name


def run(calls: int, parent: str | None = None, batch: int = 100) -> dict:
    """The parts and whole calls of every timed case, for the checkout's
    ops/ and, with ``parent`` (a package made by ``_parent_package``), for
    the earlier one, in rounds: each round times one batch of every part
    and call of every layout in turn, so drift on the host's clock falls on
    both alike; each number is the median over the rounds."""
    import importlib

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    import torch

    packages = {"checkout": "dmlc_tpu_torch"}
    if parent:
        packages = {"parent": parent, **packages}
    cases = _inputs(cs)
    report = {"card": cs.phase_device()["nvidia_smi"], "torch": torch.__version__,
              "calls": calls, "wrappers": {}}
    timed = []  # (case, layout name, part, fn)
    for name, package in packages.items():
        K = importlib.import_module(f"{package}.ops.kernels")
        RD = importlib.import_module(f"{package}.ops.ragged_decode")
        report[f"{name}_layout"] = _layout(K)
        for case, (kind, args) in cases.items():
            parts, call = _parts(_layout(K), kind, args, K, RD)
            call()
            timed += [(case, name, part, fn) for part, fn in {**parts, "call": call}.items()]
    torch.cuda.synchronize()
    samples: dict = {}
    for _ in range(max(1, calls // batch)):
        for case, name, part, fn in timed:
            samples.setdefault((case, name, part), []).append(cs.host_us(fn, batch, batch))
    for (case, name, part), values in samples.items():
        entry = report["wrappers"].setdefault(case, {}).setdefault(name, {"parts_us": {}})
        if part == "call":
            entry["call_us"] = statistics.median(values)
        else:
            entry["parts_us"][part] = statistics.median(values)
    for entry in (e for by_layout in report["wrappers"].values() for e in by_layout.values()):
        entry["rest_us"] = entry["call_us"] - sum(entry["parts_us"].values())
    K = importlib.import_module("dmlc_tpu_torch.ops.kernels")
    report["candidates"] = _candidates(cs, K, cases)
    return report


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="an earlier ops/ directory")
    ap.add_argument("scratch", nargs="?", help="a directory outside the checkout (with --parent)")
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv[1:])
    parent = None
    if args.parent is not None:
        if not args.scratch or not list(args.parent.glob("*.py")):
            ap.error("--parent needs an ops/ directory with modules and a SCRATCH_DIR")
        root = Path(args.scratch).resolve()
        if root == REPO or REPO in root.parents:
            ap.error("SCRATCH_DIR must lie outside the checkout")
        root.mkdir(parents=True, exist_ok=True)
        parent = _parent_package(args.parent, root)
        sys.path.insert(0, str(root))
    print(json.dumps(run(args.calls, parent)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
