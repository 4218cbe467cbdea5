"""Member-side inference worker: answers ``job.predict`` and
``job.predict_gang`` shards.

Port of ``dmlc_tpu/scheduler/worker.py`` (``PredictWorker`` with its gang
verbs, ``EngineBackend``, ``LmBackend``, ``ExportedBackend``,
``gang_slice``, ``_resolve_paths``). Given a model name and a list of
synset ids, look up one fixture image per synset, preprocess, forward,
return top-1 — one batched device execution per shard. A ``kind="lm"``
model's "synsets" are prompt ids, answered with the next token by
``LmBackend`` through the partition-rule engine
(``parallel/sharding.py``), solo or as a rank of a gang.

The model backend is injectable: a node wires ``EngineBackend``
(InferenceEngine on the card); tests may wire any callable
``(synsets) -> list[int]``.

``methods()`` is the table a fabric serves: ``cluster.rpc.TcpRpcServer``
over TCP (frames compatible with the JAX package's) or
``cluster.rpc.SimRpcNetwork`` in process. ``DynamicBatcher`` and
``ModelLoader`` (``model.load``: a weights blob from the member's SDFS store
into a live backend) are copies of the JAX package's over this package's
modules. An ``EngineBackend`` with an ``image_source``
(scheduler/dataset.SdfsImageSource) serves shards on a member with no local
corpus. ``ExportedBackend`` serves shards from the SDFS-published
``torch.export`` program and weights alone (``models/export.py``).
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Sequence

import torch

from dmlc_tpu_torch.cluster import tenant as tenant_mod
from dmlc_tpu_torch.cluster.rpc import DecodeError, Overloaded, RpcError
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.hotpath import hot_path
from dmlc_tpu_torch.utils.metrics import LatencyStats
from dmlc_tpu_torch.utils.tracing import traced_methods, tracer

log = logging.getLogger(__name__)

# (synset_ids) -> list of predicted class indices
PredictFn = Callable[[Sequence[str]], list[int]]


class DynamicBatcher:
    """Dynamic micro-batcher: coalesce concurrent small classify requests
    into device-shaped batches.

    The engine's unit of work is a ``batch_size`` XLA execution; an RPC
    carrying one (or a few) synsets would otherwise pay a whole padded
    device dispatch for itself. This wrapper queues incoming requests and a
    background worker drains them in batches: a batch dispatches the moment
    ``batch_size`` items are queued, or when the OLDEST queued item has
    waited ``max_wait_s`` — so under load N single-image requests ride
    ceil(N / batch_size) device dispatches, while a lone request is delayed
    at most the deadline. Results map back to their callers by queue order
    (the wrapped ``predict`` returns predictions in argument order).

    Wraps any PredictFn-shaped backend: ``__call__`` is the batched predict
    surface, and every other attribute (``warmup``, ``load_variables``,
    ``predict_gang``, ...) passes through to the wrapped backend — gang
    shards are collective SPMD executions whose slicing must not be
    reordered, so they deliberately bypass the batcher.

    Overload control (docs/OVERLOAD.md): with ``max_queue > 0`` the queue is
    BOUNDED — a submit against a full queue is shed immediately with a typed
    ``Overloaded`` (retry-after = the batch deadline) instead of buffering
    toward a guaranteed timeout. And the batch deadline *brownouts*: as the
    queue fills, the coalescing wait shrinks linearly to zero — waiting
    optimizes latency the batcher no longer has, so under pressure it
    degrades to dispatch-as-fast-as-the-device-drains.

    Multi-tenant quotas (docs/OVERLOAD.md §Priority classes): with a
    tenant table, each queued item is charged to its ambient tenant
    (cluster/tenant.py) against share x max_queue. A tenant at quota
    sheds typed (``quota="over_quota"``); a *full* queue first tries to
    displace a queued low-priority-and-over-quota item in favor of a
    high-priority within-quota submit — brownout ordering is
    low-priority-and-over-quota first, never cross-tenant eviction of
    within-quota work.
    """

    def __init__(
        self,
        predict: PredictFn,
        batch_size: int,
        max_wait_s: float = 0.005,
        name: str = "microbatch",
        max_queue: int = 0,
        metrics=None,
        flight=None,
        tenants=None,
    ):
        # _predict is set FIRST: __getattr__ delegates to it, and any
        # attribute probe before it exists would recurse.
        self._predict = predict
        self.flight = flight
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_s)
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        # Bounded admission: 0 = unbounded (the pre-overload behavior). A
        # bound below one device batch would shed work the very next
        # dispatch could carry, so the floor is 2 full batches.
        self.max_queue = max(2 * self.batch_size, int(max_queue)) if max_queue > 0 else 0
        self.metrics = metrics
        # One Condition owns all batcher state; its internal lock is only
        # ever held for list surgery — the device dispatch runs outside it.
        self._cv = threading.Condition()
        self._queue: list[tuple[str, concurrent.futures.Future, str]] = []
        self._closed = False
        # Per-tenant queue-token quotas (cluster/tenant.py): enforced only
        # when the queue is bounded — an unbounded queue has no capacity to
        # derive shares from (the pre-overload legacy configuration).
        self.ledger = tenant_mod.TenantLedger(
            tenants if self.max_queue > 0 else None, self.max_queue
        )
        self.requests = 0    # items ever submitted
        self.dispatches = 0  # device-shaped batches sent to the backend
        self.sheds = 0       # submits refused at the bounded queue
        self.queue_hw = 0    # queue-depth high-water
        self.fill = LatencyStats()  # per-dispatch batch fill fraction
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    # ---- request side ---------------------------------------------------

    def _count_shed(self, tenant: str, verdict: str) -> None:
        self.sheds += 1
        self.ledger.note_shed(tenant)
        if self.metrics is not None:
            self.metrics.inc("shed")
            self.metrics.inc("shed_microbatch")
            if verdict == "over_quota":
                self.metrics.inc("shed_over_quota_microbatch")
        if self.flight is not None:
            self.flight.note("shed", gate=self._thread.name,
                             active=len(self._queue), tenant=tenant,
                             quota=verdict)

    def _displace_over_quota(self) -> bool:
        """Brownout ordering under a full queue: shed the NEWEST queued
        item whose tenant is low-priority and over quota, freeing its slot
        for a high-priority within-quota submit. Called under the cv.
        Returns False when every queued item is within-quota or
        high-priority (those are never displaced across tenants)."""
        for i in range(len(self._queue) - 1, -1, -1):
            _, vfut, vtenant = self._queue[i]
            if self.ledger.over_quota(vtenant) and \
                    not self.ledger.spec(vtenant).high_priority:
                del self._queue[i]
                self.ledger.release(vtenant)
                self._count_shed(vtenant, "over_quota")
                vfut.set_exception(Overloaded(
                    f"microbatch: displaced by higher-priority work "
                    f"(tenant {vtenant!r} over quota)",
                    retry_after_s=self.max_wait_s,
                    tenant=vtenant, quota="over_quota",
                ))
                return True
        return False

    def submit(self, synset: str) -> "concurrent.futures.Future":
        """Queue one classify request; the future resolves to its predicted
        class index once the batch it rides in completes. Sheds with a
        typed ``Overloaded`` (carrying the tenant + quota verdict) when the
        bounded queue — or the calling tenant's quota — is full."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        tenant = tenant_mod.current()
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is stopped")
            if self.ledger.would_exceed(tenant):
                self._count_shed(tenant, "over_quota")
                raise Overloaded(
                    f"microbatch: tenant {tenant!r} at quota "
                    f"({self.ledger.active(tenant)}/{self.ledger.quota(tenant)})",
                    retry_after_s=self.max_wait_s,
                    tenant=tenant, quota="over_quota",
                )
            if self.max_queue > 0 and len(self._queue) >= self.max_queue:
                displaced = (
                    self.ledger.spec(tenant).high_priority
                    and self._displace_over_quota()
                )
                if not displaced:
                    self._count_shed(tenant, "gate_full")
                    raise Overloaded(
                        f"microbatch queue full ({len(self._queue)}/{self.max_queue})",
                        retry_after_s=self.max_wait_s,
                        tenant=tenant, quota="gate_full",
                    )
            self._queue.append((synset, fut, tenant))
            self.ledger.acquire(tenant)
            self.requests += 1
            if len(self._queue) > self.queue_hw:
                self.queue_hw = len(self._queue)
                if self.metrics is not None:
                    self.metrics.observe_high("queue_hw_microbatch", len(self._queue))
            self._cv.notify_all()
        return fut

    @hot_path
    def __call__(self, synsets: Sequence[str]) -> list[int]:
        """PredictFn surface: queue every synset, wait for all results.
        Items from concurrent callers interleave into shared batches, which
        is the whole point; per-caller order is preserved by the futures."""
        futs = [self.submit(s) for s in synsets]
        return [int(f.result()) for f in futs]

    def __getattr__(self, name: str):
        # Backend capability passthrough (warmup/load_variables/decode_gang/
        # predict_gang/image_source/...). Only called for attributes not
        # found on the batcher itself.
        return getattr(self._predict, name)

    # ---- worker side ----------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                # Deadline semantics: measured from the moment the worker
                # sees the first queued item; the batch goes as soon as it
                # is FULL, else when the deadline lapses (partial batch).
                # Brownout: the wait shrinks linearly with queue depth — a
                # full bounded queue coalesces with ZERO added latency.
                wait = self.max_wait_s
                if self.max_queue > 0:
                    wait *= max(0.0, 1.0 - len(self._queue) / self.max_queue)
                deadline = time.monotonic() + wait
                while len(self._queue) < self.batch_size and not self._closed:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                batch = self._queue[: self.batch_size]
                del self._queue[: self.batch_size]
                for _, _, t in batch:
                    self.ledger.release(t)
            self._dispatch(batch)

    def _dispatch(self, batch: list) -> None:
        synsets = [s for s, _, _ in batch]
        try:
            with tracer.span("scheduler/microbatch", n=len(synsets)):
                preds = list(self._predict(synsets))
            if len(preds) != len(synsets):
                raise RpcError(
                    f"backend returned {len(preds)} predictions for "
                    f"{len(synsets)} queries"
                )
        except BaseException as e:  # noqa: BLE001 - every waiter must observe the failure
            for _, fut, _ in batch:
                fut.set_exception(e)
            return
        with self._cv:
            self.dispatches += 1
            self.fill.record(len(batch) / self.batch_size)
        for (_, fut, _), pred in zip(batch, preds):
            fut.set_result(int(pred))

    def stop(self, timeout_s: float = 10.0) -> None:
        """Drain the queue (queued requests still complete), then join the
        worker. Further submits raise."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout_s)

    def summary(self) -> dict:
        """Coalescing counters for reports/bench: requests, device
        dispatches, and the mean batch-fill fraction (1.0 = every dispatch
        rode a full device batch)."""
        with self._cv:
            out: dict = {
                "requests": self.requests,
                "dispatches": self.dispatches,
                "mean_fill": self.fill.mean if len(self.fill) else 0.0,
                "sheds": self.sheds,
                "queue_hw": self.queue_hw,
            }
            tenants = self.ledger.summary()
            if tenants:
                out["tenants"] = tenants
            return out


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
    the engine lock toward a guaranteed deadline miss. Gang verbs are NOT
    gated — a collective execution needs every rank, so shedding one would
    fail the whole gang the leader is about to retry anyway (the
    scheduler's gang breaker is the backpressure there)."""

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
            "job.predict_gang": self._predict_gang,
            "job.decode_gang": self._decode_gang,
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

    def _decode_gang(self, p: dict) -> dict:
        """Prefetch decode for an upcoming gang shard: the leader calls this
        while the previous gang shard still executes, so host-side decode
        overlaps device execution. Best-effort by contract: a backend
        without staging, or any decode failure, answers staged=False and
        predict_gang decodes inline."""
        backend = self.backends.get(p["model"])
        if backend is None or not hasattr(backend, "decode_gang"):
            return {"staged": False}
        staged = backend.decode_gang(list(p["synsets"]), int(p["rank"]), int(p["world"]))
        return {"staged": bool(staged)}

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

    def _predict_gang(self, p: dict) -> dict:
        """Gang-scheduled shard: the leader sent the SAME shard to every
        rank of the gang; this member answers only for its rank's
        contiguous slice (``gang_slice``). The leader reassembles rank
        order."""
        model = p["model"]
        synsets = list(p["synsets"])
        rank, world = int(p["rank"]), int(p["world"])
        backend = self.backends.get(model)
        if backend is None:
            raise RpcError(f"model {model!r} not loaded here; have {sorted(self.backends)}")
        if not hasattr(backend, "predict_gang"):
            raise RpcError(f"backend for {model!r} cannot serve gang shards")
        preds = backend.predict_gang(synsets, rank, world)
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
    shard with batched device executions. An embedding model (the CLIP
    encoders) answers a zero for every query, its ``BatchResult``'s top-1
    field, as the JAX package's backend does. A lock serializes shards per
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
        device_resize_from: int | None = None,
        device_work=None,
    ):
        self.model_name = model_name
        self.data_dir = Path(data_dir)
        self.batch_size = batch_size
        self.device = resolve_device(device)
        # Device-plane telemetry hook (cluster/devicemon.py): called with
        # (model, items, device_seconds) per device execution; feeds the
        # node's MFU window and compute cost lane.
        self.device_work = device_work
        # Optional synsets -> local paths resolver; None = local fixture dirs.
        self.image_source = image_source
        # Device-side resize (ops/device_resize.py): decode at this RAW
        # size on the host (no host resample) and reach the model's input
        # size on the card — the decode tier's peers then ship near-raw
        # uint8 and the host CPU sheds the resample.
        self.device_resize_from = device_resize_from
        # Fleet decode tier client (anything with decode_paths(paths, size)
        # -> uint8 [n, size, size, 3]): multi-batch shards source their
        # prefetch decode through it instead of the local stage pool.
        self.decode_tier = None
        self.variables = variables
        self.dtype = dtype
        self._engine = None
        self._lock = threading.Lock()
        # Gang decode staging: slice content -> decoded uint8 batch, keyed by
        # the synset tuple itself so a requeued shard's stage is still valid.
        # Bounded LRU.
        self._staged: "OrderedDict[tuple, object]" = OrderedDict()
        self._stage_lock = threading.Lock()
        self.stage_hits = 0  # predict_gang calls served from a prefetch

    _STAGE_CAP = 4

    @property
    def engine(self):
        """The engine once built (by ``warmup`` or the first shard), else None."""
        return self._engine

    def warmup(self) -> None:
        """Build the native decoder (best effort) and the engine, and run
        the engine's first batch now, before serving; on a CUDA engine also
        build the device decode's entropy library and kernel (raising when
        either cannot be built)."""
        from dmlc_tpu_torch import native

        native.ensure_built()
        with self._lock:
            engine = self._ensure_engine()
        if engine.device.type == "cuda":
            from dmlc_tpu_torch.native import jpeg as native_jpeg
            from dmlc_tpu_torch.ops import jpeg as jpeg_ops

            native_jpeg.load()
            jpeg_ops.kernel_entry()

    def _ensure_engine(self):
        if self._engine is None:
            from dmlc_tpu_torch.parallel.inference import InferenceEngine

            kw = {}
            if self.variables is not None:
                kw["variables"] = self.variables
            if self.dtype is not None:
                kw["dtype"] = self.dtype
            if self.device_resize_from is not None:
                kw["device_resize_from"] = self.device_resize_from
            if self.device_work is not None:
                kw["device_work"] = self.device_work
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

    def decode_gang(self, synsets: Sequence[str], rank: int, world: int) -> bool:
        """Decode this rank's slice of an UPCOMING gang shard into the
        staging buffer, outside the engine lock, so decode and device
        execution overlap across gang shards. Best-effort: any failure
        stages nothing, and predict_gang decodes inline."""
        from dmlc_tpu_torch.ops import preprocess as pp

        try:
            engine = self._engine
            if engine is None:
                with self._lock:
                    engine = self._ensure_engine()
            start, stop = gang_slice(len(synsets), rank, world)
            mine = tuple(synsets[start:stop])
            if not mine:
                return False
            paths = _resolve_paths(self.image_source, self.data_dir, list(mine))
            batch = pp.load_batch(paths, size=engine.input_size)
            with self._stage_lock:
                self._staged[mine] = batch
                while len(self._staged) > self._STAGE_CAP:
                    self._staged.popitem(last=False)
            return True
        except Exception:
            log.warning("gang decode prefetch failed; will decode inline", exc_info=True)
            return False

    def _pop_staged(self, mine: Sequence[str]):
        with self._stage_lock:
            return self._staged.pop(tuple(mine), None)

    def predict_gang(self, synsets: Sequence[str], rank: int, world: int) -> list[int]:
        """This rank's slice of a gang shard, through one
        ``InferenceEngine.run_batch_global`` entered by every process of
        the ``torch.distributed`` group (rank 0 of 1 without one).

        Failure symmetry: every process must enter the collective or the
        others wait in it holding this backend's lock. So a per-rank failure
        the other ranks cannot see (an unreadable corpus file, a rank
        mismatch, an over-cap slice) is deferred — this rank still enters
        with an EMPTY batch, then raises after its peers are released. Only
        failures that hit every rank alike (engine construction, batch and
        process divisibility) raise before the collective."""
        import numpy as np

        from dmlc_tpu_torch.ops import preprocess as pp
        from dmlc_tpu_torch.parallel.inference import process_index_count

        with self._lock:
            engine = self._ensure_engine()
            size = engine.input_size
            deferred: Exception | None = None
            batch = np.zeros((0, size, size, 3), np.uint8)
            try:
                me, procs = process_index_count()
                if rank != me:
                    # The scheduler's rank map and the process group MUST
                    # agree, or rows come back permuted across members.
                    raise RpcError(
                        f"gang rank mismatch: scheduler says {rank}, "
                        f"the torch.distributed rank is {me}"
                    )
                start, stop = gang_slice(len(synsets), rank, world)
                mine = list(synsets[start:stop])
                cap = engine.batch_size // max(1, procs)
                if len(mine) > cap:
                    raise RpcError(
                        f"gang slice of {len(mine)} exceeds per-process "
                        f"batch cap {cap} (shard too large for the engines)"
                    )
                if mine:
                    batch = self._pop_staged(mine)
                    if batch is not None:
                        self.stage_hits += 1
                    else:
                        paths = _resolve_paths(self.image_source, self.data_dir, mine)
                        batch = pp.load_batch(paths, size=size)
            except Exception as e:
                deferred = e
            result = engine.run_batch_global(batch)
            if deferred is not None:
                raise RpcError(f"{type(deferred).__name__}: {deferred}")
            return [int(x) for x in result.top1_index]

    def load_variables(self, variables) -> None:
        """Swap weights into the live engine (this package's state dict or
        the JAX package's variables tree)."""
        with self._lock:
            self._ensure_engine().load_variables(variables)


class LmBackend:
    """Gang-sharded causal-LM serving backend.

    A "synset" on a ``kind="lm"`` job is a PROMPT ID: the encoding is the
    deterministic arithmetic of ``parallel.sharding.tokens_for_prompt``, so
    the leader, every gang member and a single-process reference agree on
    the token stream byte for byte, and the predicted "class index" is the
    argmax next-token id — the job's accuracy then measures exact TOKEN
    IDENTITY against reference labels.

    The program comes from the partition-rule engine: one rule table, placed
    at whatever gang width the PlacementAdvisor chose (``plan_axes`` splits
    the width into dp x tp) over the devices of ``device`` (the card's, or
    ``[cpu]``), the width clamped to their count. Solo ``__call__`` REFUSES
    when the model's resident bytes exceed this chip's HBM budget — the
    refusal the advisor converts into a wide gang instead of a dead job.
    ``predict_gang`` serves a rank's contiguous ``gang_slice`` of the shard.
    The devices are resolved at construction: with no CUDA device and no
    explicit ``device="cpu"`` this raises at once.
    """

    def __init__(
        self,
        model_name: str,
        *,
        gang_devices: int = 0,
        prompt_len: int = 16,
        dtype: torch.dtype | None = None,
        hbm_budget_bytes: int = 0,
        device_work=None,
        devices=None,
        device: str | torch.device | None = None,
    ):
        from dmlc_tpu_torch.parallel.mesh import default_devices

        self.model_name = model_name
        self.prompt_len = prompt_len
        # Fixed gang width (config lm_gang_devices); 0 = follow the
        # scheduler's world size, clamped to the device count.
        self.gang_devices = gang_devices
        # Per-chip resident-bytes budget enforced on the SOLO path; 0 = no
        # budget.
        self.hbm_budget_bytes = hbm_budget_bytes
        self.device_work = device_work
        self._devices = [torch.device(d) for d in devices] if devices is not None \
            else default_devices(device)
        self._dtype = dtype
        self._programs: dict[int, object] = {}
        self._lock = threading.Lock()

    def _program(self, width: int):
        from dmlc_tpu_torch.models.registry import get_model
        from dmlc_tpu_torch.parallel import sharding as sharding_lib
        from dmlc_tpu_torch.parallel.mesh import make_mesh

        devs = self._devices
        width = max(1, min(width, len(devs)))
        prog = self._programs.get(width)
        if prog is None:
            spec = get_model(self.model_name)
            axes = sharding_lib.plan_axes(width, num_heads=spec.num_heads)
            mesh = make_mesh(axes, devices=devs[:width])
            prog = sharding_lib.ShardedProgram(
                self.model_name, mesh, dtype=self._dtype or torch.float32
            )
            self._programs[width] = prog
        return prog

    def warmup(self) -> None:
        """Build the program now, before serving."""
        with self._lock:
            self._program(self.gang_devices or 1)

    def _run(self, prog, synsets: Sequence[str]) -> list[int]:
        from dmlc_tpu_torch.parallel import sharding as sharding_lib

        spec = prog.spec  # registry ModelSpec: input_size=max_len, num_outputs=vocab
        tokens = sharding_lib.encode_prompts(
            list(synsets), min(self.prompt_len, spec.input_size), spec.num_outputs
        )
        t0 = time.monotonic()
        out = prog.run(tokens)
        if self.device_work is not None:
            self.device_work(self.model_name, len(synsets), time.monotonic() - t0)
        return [int(x) for x in out]

    def __call__(self, synsets: Sequence[str]) -> list[int]:
        with self._lock:
            if self.hbm_budget_bytes > 0:
                from dmlc_tpu_torch.models.registry import get_model

                need = get_model(self.model_name).param_bytes(self._dtype or torch.float32)
                if need > self.hbm_budget_bytes:
                    raise RpcError(
                        f"model {self.model_name!r} needs {need} resident bytes, "
                        f"over this chip's {self.hbm_budget_bytes} HBM budget; "
                        f"serve it as a gang (docs/SHARDING.md)"
                    )
            return self._run(self._program(1), synsets)

    def predict_gang(self, synsets: Sequence[str], rank: int, world: int) -> list[int]:
        """This rank's contiguous slice of a gang shard, computed by the
        rule-sharded program at the gang's width. Each rank's slice is an
        independent execution, with no collective to enter, so an empty
        slice just answers []."""
        with self._lock:
            prog = self._program(self.gang_devices or world)
            start, stop = gang_slice(len(synsets), rank, world)
            mine = list(synsets[start:stop])
            if not mine:
                return []
            return self._run(prog, mine)

    def load_variables(self, variables) -> None:
        """Swap weights (the `train` verb): every cached width re-shards the
        same tree under the model's rule table."""
        with self._lock:
            for prog in self._programs.values():
                prog.load_variables(variables)

    def resident_bytes(self) -> int | None:
        """Per-chip resident weight bytes of the WIDEST built program — the
        number the leader's HBM gauges see. None until a program builds."""
        from dmlc_tpu_torch.parallel import sharding as sharding_lib

        if not self._programs:
            return None
        prog = self._programs[max(self._programs)]
        return int(sharding_lib.sharded_bytes_per_chip(self.model_name, prog.mesh,
                                                       dtype=prog.dtype))


class ExportedBackend:
    """Serve shards from the SDFS-distributed ``torch.export`` program and
    weights: NO model class on the serving path. Everything a member needs
    to answer ``job.predict`` is two SDFS files, ``executables/<m>.pt2``
    (``models/export.py``) and ``models/<m>``. Weights absent from SDFS
    fall back to the registry's seeded init (EngineBackend's behavior
    before `train`), and `train` hot-swaps them through ``load_variables``
    like any backend. The program runs on ``device`` (the card unless the
    caller asks for the CPU) and must have been exported there. An
    embedding model answers zeros, as EngineBackend does.
    """

    def __init__(
        self,
        model_name: str,
        data_dir: str | Path,
        sdfs,
        image_source=None,
        device: str | torch.device | None = None,
    ):
        self.model_name = model_name
        self.data_dir = Path(data_dir)
        self.sdfs = sdfs
        self.image_source = image_source
        self.device = resolve_device(device)
        self._server = None
        self._lock = threading.Lock()
        # Persistent decode-ahead worker for the shard pipeline below:
        # created once here, never per shard.
        self._decoder = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="export-decode"
        )

    def warmup(self) -> None:
        # One-time lazy init under the lock: shards arriving before the
        # artifact is resident block instead of double-fetching.
        with self._lock:
            self._ensure_server()

    def _ensure_server(self):
        if self._server is None:
            from dmlc_tpu_torch.cluster.rpc import RpcUnreachable
            from dmlc_tpu_torch.models import export as export_lib
            from dmlc_tpu_torch.models import weights as weights_lib
            from dmlc_tpu_torch.models.registry import get_model

            version, exported = export_lib.fetch_executable(
                self.sdfs, self.model_name, device=self.device
            )
            try:
                _, blob = self.sdfs.get_bytes(weights_lib.sdfs_weights_name(self.model_name))
                # Validation errors (corrupt/mismatched blob) PROPAGATE:
                # weights.py's contract is fail-at-load, never serve them.
                _, variables = weights_lib.weights_from_bytes(blob, expect_model=self.model_name)
                log.info("%s: artifact v%d + SDFS weights", self.model_name, version)
            except RpcUnreachable:
                raise  # transient (failover mid-fetch): retry the shard, not random-init
            except RpcError as e:
                if not weights_lib.not_published(e):
                    raise  # any refusal other than not-published is not consent
                variables = get_model(self.model_name).init_params(
                    0, dtype=torch.float32).state_dict()
                log.info("%s: artifact v%d, weights not published yet — random init",
                         self.model_name, version)
            # The artifact's input shape is FIXED at export: serving batch
            # and input size come from IT, never from node config.
            self._server = export_lib.ExportedServer(exported, variables)
            self._serve_batch = exported.batch
            self._input_size = exported.input_size
        return self._server

    @hot_path
    def __call__(self, synsets: Sequence[str]) -> list[int]:
        import numpy as np

        from dmlc_tpu_torch.ops import preprocess as pp

        if not synsets:
            return []
        # The backend lock serializes shards per artifact, and the first
        # shard's lazy init blocks later shards on the one SDFS fetch.
        with self._lock:
            server = self._ensure_server()
            chunk_size = self._serve_batch
            paths = _resolve_paths(self.image_source, self.data_dir, synsets)
            starts = list(range(0, len(paths), chunk_size))
            preds: list[int] = []
            # Decode chunk i+1 while the program executes chunk i, on the
            # persistent self._decoder.
            decode = lambda s: pp.load_batch(
                paths[s : s + chunk_size], size=self._input_size
            )
            fut = self._decoder.submit(decode, starts[0])
            for i, s in enumerate(starts):
                batch = fut.result()
                if i + 1 < len(starts):
                    fut = self._decoder.submit(decode, starts[i + 1])
                if server.classifier:
                    idx, _ = server(batch)
                else:
                    server(batch)
                    idx = np.zeros(batch.shape[0], np.int32)
                preds.extend(int(x) for x in idx)
            return preds

    def load_variables(self, variables) -> None:
        """The `train` verb's hot-swap: the same validated tree the engine
        path takes, converted once onto the program's device."""
        with self._lock:
            self._ensure_server().load_variables(variables)


class ModelLoader:
    """Member RPC surface for hot-loading distributed weights.

    After `train` replicates ``models/{model}`` into a member's local SDFS
    store, the leader calls ``model.load`` here: read the blob from the local
    store, deserialize + validate (models/weights.py), and hand the variables
    to the model's backend. Backends without ``load_variables`` (test fakes)
    refuse cleanly.
    """

    def __init__(self, store, backends: dict, extra: dict | None = None):
        self.store = store
        self.backends = backends
        # A second live backend table (e.g. the generation backends): the
        # `train` verb hot-swaps LM weights the same way it swaps image
        # weights. Predict backends win a (never-expected) name collision.
        self.extra = extra if extra is not None else {}

    def methods(self) -> dict:
        return traced_methods({"model.load": self._load})

    def _load(self, p: dict) -> dict:
        from dmlc_tpu_torch.models import weights as weights_lib

        model = p["model"]
        backend = self.backends.get(model, self.extra.get(model))
        if backend is None:
            raise RpcError(f"model {model!r} not served here")
        if not hasattr(backend, "load_variables"):
            raise RpcError(f"backend for {model!r} does not support weight loading")
        name = weights_lib.sdfs_weights_name(model)
        version = int(p["version"])
        try:
            blob = self.store.read(name, version)
        except KeyError as e:
            raise RpcError(str(e))
        try:
            _, variables = weights_lib.weights_from_bytes(blob, expect_model=model)
        except ValueError as e:
            raise RpcError(f"bad weights blob {name} v{version}: {e}")
        backend.load_variables(variables)
        log.info("loaded %s v%d into %s backend", name, version, model)
        return {"model": model, "version": version}
