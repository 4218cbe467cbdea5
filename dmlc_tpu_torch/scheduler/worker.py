"""Member-side inference worker: answers ``job.predict`` shards.

Port of ``dmlc_tpu/scheduler/worker.py`` (``PredictWorker``,
``EngineBackend``, ``gang_slice``, ``_resolve_paths``). Given a model name
and a list of synset ids, look up one fixture image per synset, preprocess,
forward, return top-1 — one batched device execution per shard.

The model backend is injectable: a node wires ``EngineBackend``
(InferenceEngine on the card); tests may wire any callable
``(synsets) -> list[int]``.

``methods()`` is the table a fabric serves: ``cluster.rpc.TcpRpcServer``
over TCP (frames compatible with the JAX package's) or
``cluster.rpc.SimRpcNetwork`` in process. Not ported yet: the node that
wires the worker, its gate and the SDFS image source together, the gang
verbs, ``DynamicBatcher``, ``LmBackend``, ``ExportedBackend`` and
``ModelLoader``.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Callable, Sequence

import torch

from dmlc_tpu_torch.cluster.rpc import DecodeError, RpcError
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.tracing import traced_methods

# (synset_ids) -> list of predicted class indices
PredictFn = Callable[[Sequence[str]], list[int]]


def _resolve_paths(image_source, data_dir: Path, synsets: Sequence[str]) -> list[Path]:
    """Synsets -> local image paths: through the injected source when wired,
    else the local fixture-corpus layout."""
    from dmlc_tpu_torch.ops import preprocess as pp

    if image_source is not None:
        return list(image_source(synsets))
    return [pp.class_image_path(data_dir, s) for s in synsets]


class PredictWorker:
    """RPC surface for shard prediction over a registry of models.

    ``gate`` (cluster/admission.AdmissionGate, optional) bounds concurrent
    ``job.predict`` and ``job.decode`` work: past max_inflight + max_queue
    the request is shed with a typed ``Overloaded`` instead of queuing on
    the engine lock toward a guaranteed deadline miss."""

    def __init__(self, backends: dict[str, PredictFn], gate=None,
                 decode_lanes: int | None = None):
        self.backends = dict(backends)
        self.gate = gate
        # Decode-tier lane accounting: this host can usefully run ~one JPEG
        # decode per core; idle lanes = lanes minus in-flight job.decode.
        self.decode_lanes = int(decode_lanes or min(32, (os.cpu_count() or 4)))
        self._decode_active = 0
        self._decode_lock = threading.Lock()

    def methods(self) -> dict:
        return traced_methods({
            "job.predict": self._predict,
            "job.decode": self._decode,
        })

    def decode_lane_idle(self) -> int:
        """Idle decode lanes right now (gauge read; never negative)."""
        with self._decode_lock:
            return max(0, self.decode_lanes - self._decode_active)

    def _decode(self, p: dict) -> dict:
        """Decode-tier member verb: raw encoded-image BYTES in, one
        device-ready uint8 tensor block out (``data`` = C-contiguous
        [n, size, size, 3] bytes). Undecodable blobs answer a typed
        ``DecodeError`` naming the poison indices. Admitted through the
        same gate as ``job.predict``: decode work competes with shards for
        this host's CPU."""
        import numpy as np

        from dmlc_tpu_torch.ops import preprocess as pp

        blobs = list(p["blobs"])
        size = int(p["size"])
        if self.gate is not None:
            with self.gate.admit():
                out, status = self._decode_tracked(pp, blobs, size)
        else:
            out, status = self._decode_tracked(pp, blobs, size)
        if status.any():
            bad = [int(i) for i in np.nonzero(status)[0]]
            raise DecodeError(
                f"{len(bad)}/{len(blobs)} blobs undecodable (indices {bad[:16]})"
            )
        return {"n": len(blobs), "size": size, "data": out.tobytes()}

    def _decode_tracked(self, pp, blobs: list, size: int):
        with self._decode_lock:
            self._decode_active += 1
        try:
            return pp.decode_blobs(blobs, size=size)
        finally:
            with self._decode_lock:
                self._decode_active -= 1

    def _predict(self, p: dict) -> dict:
        model, synsets = p["model"], list(p["synsets"])
        fn = self.backends.get(model)
        if fn is None:
            raise RpcError(f"model {model!r} not loaded here; have {sorted(self.backends)}")
        if self.gate is not None:
            with self.gate.admit():
                preds = fn(synsets)
        else:
            preds = fn(synsets)
        if len(preds) != len(synsets):
            raise RpcError(f"backend returned {len(preds)} predictions for {len(synsets)} queries")
        return {"predictions": [int(x) for x in preds]}


def gang_slice(n: int, rank: int, world: int) -> tuple[int, int]:
    """The [start, stop) of rank's contiguous share of an n-query gang
    shard: contiguous per-rank runs keep reply order == shard order. The
    leader and every member MUST agree on this function."""
    share = -(-n // world) if n else 0  # ceil; empty shard -> empty slices
    start = min(n, rank * share)
    return start, min(n, start + share)


class EngineBackend:
    """Real backend: fixture images through an InferenceEngine.

    The engine is built on first use (or by ``warmup``), then serves every
    shard with batched device executions. A lock serializes shards per
    engine — one batch stream already saturates the device pipeline. The
    device is resolved at construction: with no CUDA device and no explicit
    ``device="cpu"`` this raises at once.
    """

    def __init__(
        self,
        model_name: str,
        data_dir: str | Path,
        batch_size: int = 256,
        image_source=None,
        variables=None,
        dtype: torch.dtype | None = None,
        device: str | torch.device | None = None,
    ):
        self.model_name = model_name
        self.data_dir = Path(data_dir)
        self.batch_size = batch_size
        self.device = resolve_device(device)
        # Optional synsets -> local paths resolver; None = local fixture dirs.
        self.image_source = image_source
        # Fleet decode tier client (anything with decode_paths(paths, size)
        # -> uint8 [n, size, size, 3]): multi-batch shards source their
        # prefetch decode through it instead of the local stage pool.
        self.decode_tier = None
        self.variables = variables
        self.dtype = dtype
        self._engine = None
        self._lock = threading.Lock()

    @property
    def engine(self):
        """The engine once built (by ``warmup`` or the first shard), else None."""
        return self._engine

    def warmup(self) -> None:
        """Build the native decoder (best effort) and the engine, and run
        the engine's first batch now, before serving."""
        from dmlc_tpu_torch import native

        native.ensure_built()
        with self._lock:
            self._ensure_engine()

    def _ensure_engine(self):
        if self._engine is None:
            from dmlc_tpu_torch.parallel.inference import InferenceEngine

            kw = {}
            if self.variables is not None:
                kw["variables"] = self.variables
            if self.dtype is not None:
                kw["dtype"] = self.dtype
            self._engine = InferenceEngine(
                self.model_name, device=self.device, batch_size=self.batch_size, **kw
            )
            self._engine.warmup()
        return self._engine

    def __call__(self, synsets: Sequence[str]) -> list[int]:
        with self._lock:
            engine = self._ensure_engine()
            paths = _resolve_paths(self.image_source, self.data_dir, synsets)
            if len(paths) <= self.batch_size:
                result = engine.run_paths(paths)
            else:
                # Multi-batch shard: decode batch i+1 while the device runs
                # batch i; with a decode tier wired, that decode comes from it.
                result = engine.run_paths_stream(
                    paths,
                    decode_source=(
                        self.decode_tier.decode_paths
                        if self.decode_tier is not None
                        else None
                    ),
                )
            return [int(x) for x in result.top1_index]

    def load_variables(self, variables) -> None:
        """Swap weights into the live engine (this package's state dict or
        the JAX package's variables tree)."""
        with self._lock:
            self._ensure_engine().load_variables(variables)
