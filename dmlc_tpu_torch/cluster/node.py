"""Process bootstrap: one ClusterNode wires every layer for deployment.

Ported from ``dmlc_tpu/cluster/node.py`` with its structure and names, wired
only to modules this package has: the fabric (auth, ``TcpRpc``/
``TcpRpcServer``, admission gates, retry policy, clock, UDP gossip
membership), the SDFS (member store, member, client and leader), the
member's workers (``PredictWorker`` over ``EngineBackend``s and
``LmBackend``s, ``GenerateWorker``, ``ModelLoader``, ``DynamicBatcher``), the
observability plane (``CostProfiler``, ``CritPathAnalyzer``/
``FleetCritPath``, ``DriftSentinel``, ``ObsService``, ``ScrapeDelegate``),
the device monitor and the fleet decode tier (``DecodeTierClient``) on every
node, the closed loop (``PlacementAdvisor``, ``SloEvaluator``, ``GenRouter``
with its ``gen.*`` verbs, ``Autoscaler``) on every leader candidate, and the
leader (``JobScheduler``, ``LeaderTracker``, ``StandbyLeader``,
``ScrapeTreeCoordinator``, the ``obs.fleet``/``obs.fleet_prom``/
``obs.critpath``/``obs.slo`` verbs and, with ``mesh_processes`` > 1, the
``MeshBootstrap`` behind ``mesh.register``/``mesh.info``/``mesh.state``,
whose rank map the scheduler gang-dispatches to). A node of this package
and one of the JAX package join one fleet: their gossip, RPC frames and
verbs are the same.

Capability parity with the reference's main() (src/main.rs:25-41): start
membership threads, start the member RPC server, conditionally start the
leader server (if this host is a leader candidate), and hand a handle to the
CLI. Periodic maintenance loops mirror the reference's tokio tasks:

- membership step every heartbeat interval (membership.rs:225-291)
- SDFS healing every rereplication interval (services.rs:186-198)
- job assignment every assignment interval (services.rs:199-211)
- dispatch loop feeding shards to members (services.rs:407-433)
- member-side leader probe (services.rs:527-545)
- standby-leader state sync (services.rs:212-240)

Addressing convention: a node's identity is its gossip address
``host:gossip_port``; its RPC server lives at ``host:member_port`` (and
``host:leader_port`` when leading). ``member_rpc_addr`` maps between them,
so membership stays the single source of liveness truth.

Engines run on ``device``: the CUDA device unless the caller passes
``device="cpu"``; with no card and no ``device="cpu"`` building an engine
raises. A ``kind="lm"`` job model is served by an ``LmBackend`` (the
partition-rule engine, solo or through ``job.predict_gang`` when the
advisor plans a chip gang), as in the JAX package. ``join_global_mesh``
joins the fleet's default ``torch.distributed`` group through the leader
(``parallel/multihost.py``). With ``serve_from_executable`` on, an image
job model is served by an ``ExportedBackend``: the ``torch.export`` program
and the weights from the SDFS, no model class on the serving path
(``models/export.py``). The JAX package's compile cache has no
counterpart in an eager port.
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path

import torch

from dmlc_tpu_torch.cluster import observe
from dmlc_tpu_torch.cluster.admission import AdmissionGate
from dmlc_tpu_torch.cluster.clock import Clock, TimerRegistry
from dmlc_tpu_torch.cluster.critpath import CritPathAnalyzer, FleetCritPath
from dmlc_tpu_torch.cluster.decodetier import DecodeTierClient
from dmlc_tpu_torch.cluster.devicemon import DeviceMonitor
from dmlc_tpu_torch.cluster.failover import LeaderTracker, StandbyLeader
from dmlc_tpu_torch.cluster.flight import FlightRecorder
from dmlc_tpu_torch.cluster.membership import MembershipNode
from dmlc_tpu_torch.cluster.observe import ObsService
from dmlc_tpu_torch.cluster.profile import CostProfiler
from dmlc_tpu_torch.cluster.retrypolicy import RetryPolicy
from dmlc_tpu_torch.cluster.rpc import TcpRpc, TcpRpcServer
from dmlc_tpu_torch.cluster.scrapetree import ScrapeDelegate, ScrapeTreeCoordinator
from dmlc_tpu_torch.cluster.sdfs import MemberStore, SdfsClient, SdfsLeader, SdfsMember
from dmlc_tpu_torch.cluster.sentinel import DriftSentinel
from dmlc_tpu_torch.cluster.tenant import parse_tenants
from dmlc_tpu_torch.cluster.transport import UdpTransport
from dmlc_tpu_torch.scheduler.autoscaler import Autoscaler, ScaleTarget
from dmlc_tpu_torch.scheduler.genrouter import GenRouter
from dmlc_tpu_torch.scheduler.jobs import JobScheduler
from dmlc_tpu_torch.scheduler.placement import PlacementAdvisor, SloEvaluator, SloObjective
from dmlc_tpu_torch.scheduler.worker import (
    DynamicBatcher,
    EngineBackend,
    ExportedBackend,
    LmBackend,
    ModelLoader,
    PredictWorker,
)
from dmlc_tpu_torch.utils import tracing
from dmlc_tpu_torch.utils.config import ClusterConfig
from dmlc_tpu_torch.utils.metrics import Counters, Registry, TenantLabelGuard
from dmlc_tpu_torch.utils.tracing import traced_methods

log = logging.getLogger(__name__)

def member_rpc_addr(gossip_addr: str, port_offset: int) -> str:
    """Map a gossip identity to its member RPC address. The fleet shares one
    port layout (the reference's fixed 8850/8851/8852 scheme,
    membership.rs:64 + services.rs:31-32); here it's the *offset* that is
    fleet-wide, so several nodes can share a host in tests."""
    host, _, gport = gossip_addr.rpartition(":")
    return f"{host}:{int(gport) + port_offset}"


def _backend_resident(backend) -> int | None:
    """Resident device bytes of a predict backend's engine — None until the
    lazy engine builds (or for backends without the capability, e.g. the
    test fakes). Backends that know their own footprint answer directly."""
    fn = getattr(backend, "resident_bytes", None)
    if fn is None:
        engine = getattr(backend, "_engine", None)
        fn = getattr(engine, "resident_bytes", None)
    try:
        return int(fn()) if fn is not None else None
    except Exception:  # noqa: BLE001 - gauge read must never raise
        return None


def _gen_resident(backend) -> int | None:
    """Resident device bytes (weights + KV page pools) of a generation
    backend's engine — None until the lazy scheduler/engine builds."""
    sched = getattr(backend, "_scheduler", None)
    fn = getattr(getattr(sched, "engine", None), "resident_bytes", None)
    try:
        return int(fn()) if fn is not None else None
    except Exception:  # noqa: BLE001 - gauge read must never raise
        return None


def _model_kind(name: str) -> str:
    """Registry kind for a job model ("image"/"lm"); unknown names fall back
    to "image" so a misconfigured job fails in the backend, with a real
    error, rather than here at wiring time."""
    try:
        from dmlc_tpu_torch.models.registry import get_model

        return get_model(name).kind
    except Exception:  # noqa: BLE001 - wiring must not die on a bad name
        return "image"


class ClusterNode:
    """One running node: membership + member services + optional leadership.

    ``device`` goes to every ``EngineBackend`` and ``GenerationBackend`` the
    node builds (``backends`` given by the caller are used as they are)."""

    def __init__(self, config: ClusterConfig, backends: dict | None = None, device=None):
        # If construction fails after some ports are bound (e.g. EADDRINUSE
        # on member_port after gossip bound), the caller never gets a handle
        # to stop() — close whatever bound before re-raising so a harness
        # retry can redraw the port block without leaking sockets.
        self.gossip = None
        self.member_server = None
        self.leader_server = None
        try:
            self._build(config, backends, device)
        except BaseException:
            for bound in (self.leader_server, self.member_server, self.gossip):
                if bound is not None:
                    try:
                        bound.close()
                    except Exception:  # dmlc-lint: disable=E1 -- best-effort close mid-unwind; the original error re-raises below
                        pass
            raise

    def _build(self, config: ClusterConfig, backends: dict | None, device) -> None:
        from dmlc_tpu_torch.cluster.auth import maybe_auth

        self.config = config
        self.device = device
        self.clock = Clock()
        # Sender identity binds this node's address into every sealed frame's
        # replay sequence track (auth.py: per-sender monotonic windows).
        self.auth = maybe_auth(
            config.auth_key, sender=f"{config.host}:{config.gossip_port}"
        )
        self.rpc = TcpRpc(auth=self.auth)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._announced = False  # restart inventory re-announce (probe loop)
        # Every maintenance loop's body registers here (see _timer): one
        # named dispatch table shared by the deployment threads and the
        # schedule explorer.
        self.timers = TimerRegistry()

        # --- observability plane (docs/OBSERVABILITY.md) ----------------
        # ONE counter registry, ONE flight recorder, and ONE retry governor
        # per node, shared by every component: the CLI `status`/`metrics`
        # verbs, leader.status, and the obs.* scrape surface all read the
        # same numbers the gates/breakers/scheduler write.
        self.metrics = Counters()
        # Multi-tenant admission: the declared tenant table feeds every
        # gate's quota ledger and the CLI `tenants` verb; the label guard
        # bounds per-tenant metric cardinality (one guard per node, shared).
        self.tenant_specs = parse_tenants(config.tenants)
        self.tenant_guard = TenantLabelGuard(
            config.metrics_max_tenants, counters=self.metrics
        )
        self.lane = f"{config.host}:{config.member_port}"
        self.flight = FlightRecorder(
            clock=self.clock.monotonic, node=self.lane
        )
        self.registry = Registry(counters=self.metrics)
        self.retry_policy = RetryPolicy(
            clock=self.clock.monotonic,
            breaker_threshold=config.breaker_threshold,
            breaker_cooldown_s=config.breaker_cooldown_s,
            retry_rate_per_s=config.retry_rate_per_s,
            retry_burst=config.retry_burst,
            metrics=self.metrics,
            flight=self.flight,
        )
        self.predict_gate = AdmissionGate(
            config.predict_max_inflight,
            config.predict_max_queue,
            name="predict",
            metrics=self.metrics,
            retry_after_s=config.shed_retry_after_s,
            flight=self.flight,
            tenants=self.tenant_specs,
        )
        self.transfer_gate = AdmissionGate(
            config.transfer_max_inflight,
            config.transfer_max_queue,
            name="transfer",
            metrics=self.metrics,
            retry_after_s=config.shed_retry_after_s,
            flight=self.flight,
            tenants=self.tenant_specs,
        )
        self.registry.gauge("predict_gate_active", lambda: self.predict_gate.active)
        self.registry.gauge("transfer_gate_active", lambda: self.transfer_gate.active)
        # Latest obs.metrics reply per member, scraped by the leader on the
        # probe cadence (empty on non-leading nodes). fleet_merged is the
        # counter-exact fleet-wide rollup the scrape tree folds;
        # fleet_stale lists member addrs whose span went dark this cycle.
        self.fleet_metrics: dict[str, dict] = {}
        self.fleet_merged: dict = {}
        self.fleet_stale: list[str] = []
        # Head-based trace sampling: base rate + spans/s budget from config;
        # the per-node decision counters ride obs.metrics as gauges. The
        # tracer is process-global — co-hosted nodes (localcluster) share
        # one controller, exactly like they share one span buffer.
        tracing.tracer.set_sampling(
            rate=config.trace_sample_rate,
            spans_per_s=config.trace_spans_per_s_budget,
        )
        self.registry.gauge(
            "trace_sampled",
            lambda: tracing.tracer.sampling_summary()["sampled"],
        )
        self.registry.gauge(
            "trace_unsampled",
            lambda: tracing.tracer.sampling_summary()["unsampled"],
        )
        self.registry.gauge(
            "trace_sampling_rate",
            lambda: tracing.tracer.sampling_summary()["effective_rate"],
        )
        # Live cost profiles (cluster/profile.py): every node keeps one —
        # members feed their own gen/step and device lanes, the leader
        # additionally folds dispatch latencies + fleet scrapes into
        # fleet-wide lanes. Warm-started from the persisted snapshot.
        self.profiler = CostProfiler(
            window_s=config.profile_window_s,
            windows=config.profile_windows,
            decay=config.profile_decay,
            clock=self.clock.monotonic,
        )
        if config.profile_persist:
            adopted = self.profiler.load(self.profile_path())
            if adopted:
                self.flight.note("profile_warm_start", lanes=adopted)
        # Root-cause plane (cluster/critpath.py): every node drains its
        # sampled span DAGs into per-(model, stage, member) critical-path
        # seconds; the snapshot rides obs.metrics to the leader, which
        # folds the fleet table and runs the drift sentinel.
        self.critpath = (
            CritPathAnalyzer(
                window_s=config.critpath_window_s,
                windows=config.critpath_windows,
                decay=config.critpath_decay,
                clock=self.clock.monotonic,
            )
            if config.critpath_enabled else None
        )
        self.fleet_critpath = FleetCritPath()
        self.sentinel = (
            DriftSentinel(
                quantile=config.sentinel_quantile,
                drift_factor=config.sentinel_drift_factor,
                clear_factor=config.sentinel_clear_factor,
                min_samples=config.sentinel_min_samples,
                confirm_windows=config.sentinel_confirm_windows,
                baseline_decay=config.sentinel_baseline_decay,
                force_sample_s=config.sentinel_force_sample_s,
                flight_note=self.flight.note,
                force_sample=self._drift_force_sample,
                request_replan=self._drift_request_replan,
            )
            if config.sentinel_enabled and config.critpath_enabled else None
        )
        # Worst clamp distance seen in the last merged fleet trace (set by
        # export_fleet_trace below); 0 until a trace has been collected.
        self._trace_max_skew = 0.0
        self.registry.gauge("trace_max_skew_s", lambda: self._trace_max_skew)
        # Device-plane telemetry (cluster/devicemon.py): kernel-build census
        # + HBM gauges + live MFU on the SAME registry the obs scrape
        # exports, so the leader learns about rebuilds and memory pressure
        # the way it learns about queue depths.
        self.devicemon = DeviceMonitor(
            self.registry,
            flight=self.flight,
            metrics=self.metrics,
            profiler=self.profiler,
            member=self.lane,
            clock=self.clock.monotonic,
            warmup_s=config.devicemon_warmup_s,
            hbm_alert_fraction=config.devicemon_hbm_alert_fraction,
            peak_flops=config.devicemon_peak_flops,
            device=device,
        )

        # --- L1 membership over UDP gossip -----------------------------
        self.gossip = UdpTransport(config.host, config.gossip_port, auth=self.auth)
        self.membership = MembershipNode(config, self.gossip, self.clock)

        # --- member services (SDFS store + inference worker) -----------
        self.store = MemberStore(Path(config.storage_dir), flight=self.flight)
        self.registry.gauge(
            "sdfs_blobs",
            lambda: sum(len(vs) for vs in self.store.listing().values()),
        )
        self.sdfs_member = SdfsMember(
            self.store,
            self.rpc,
            chunk_bytes=config.transfer_chunk_bytes,
            transfer_timeout_s=config.transfer_deadline_s,
            gate=self.transfer_gate,
        )
        if backends is None:
            backends = {}
            for name in config.job_models:
                if _model_kind(name) == "lm":
                    # kind="lm" jobs serve through the gang-aware sharded
                    # path (parallel/sharding.py).
                    backends[name] = LmBackend(
                        name,
                        gang_devices=config.lm_gang_devices,
                        prompt_len=config.lm_prompt_len,
                        hbm_budget_bytes=config.lm_hbm_budget_bytes,
                        device=device,
                        device_work=self.devicemon.device_work,
                    )
                elif config.serve_from_executable:
                    # sdfs is wired in below once the client exists (the
                    # member server needs the backends first); the backend is
                    # lazy, so nothing touches sdfs until warmup/first shard.
                    # No batch size here: the serving batch is the published
                    # artifact's, fixed at export time.
                    backends[name] = ExportedBackend(
                        name, config.data_dir, sdfs=None, device=device
                    )
                else:
                    backends[name] = EngineBackend(
                        name, config.data_dir, batch_size=config.batch_size, device=device,
                        device_work=self.devicemon.device_work,
                    )
        self.worker = PredictWorker(backends, gate=self.predict_gate)
        # Per-model device accounting: resident_bytes_<model> (None until
        # the lazy engine builds) + mfu_<model> gauges. Registered against
        # the RAW backends, before any DynamicBatcher wrap below.
        for name, backend in self.worker.backends.items():
            self.devicemon.register_model(
                name, resident_bytes=lambda b=backend: _backend_resident(b)
            )
        # Idle decode capacity, scraped fleet-wide by the leader's obs loop.
        self.registry.gauge("decode_lane_idle", self.worker.decode_lane_idle)
        # --- generation serving (generate/) ------------------------------
        # Continuous-batching LM worker: slots join/leave the running
        # decode batch between steps, KV lives in fixed-size pages, and
        # tokens stream back through the chunk-poll protocol. Built only
        # when configured — image-only nodes pay nothing.
        self.generate_worker = None
        self._gen_backends: dict = {}
        if config.generate_models:
            from dmlc_tpu_torch.generate.worker import GenerateWorker, GenerationBackend

            self._gen_backends = {
                name: GenerationBackend(
                    name,
                    max_slots=config.gen_max_slots,
                    page_size=config.gen_page_size,
                    num_pages=config.gen_num_pages,
                    max_prefill=config.gen_max_prefill,
                    max_waiting=config.gen_max_waiting,
                    metrics=self.metrics,
                    flight=self.flight,
                    registry=self.registry,
                    lane=lambda: self.lane,
                    # Decode-step costs land in this node's own profile
                    # lane; the leader's scrape folds them fleet-wide.
                    profile=lambda sec, m=name: self.profiler.record(
                        m, self.lane, "gen/step", sec
                    ),
                    device_work=self.devicemon.device_work,
                    tenants=self.tenant_specs,
                    device=device,
                )
                for name in config.generate_models
            }
            for name, gb in self._gen_backends.items():
                self.devicemon.register_model(
                    name, resident_bytes=lambda b=gb: _gen_resident(b)
                )
            self.generate_worker = GenerateWorker(
                self._gen_backends, session_ttl_s=config.gen_session_ttl_s,
                flight=self.flight,
            )
        self.model_loader = ModelLoader(
            self.store, self.worker.backends, extra=self._gen_backends
        )
        self.obs = ObsService(
            self.registry, flight=self.flight, lane=self.lane,
            profiler=self.profiler, critpath=self.critpath,
            claim_unlaned=lambda: (
                self.standby is not None and self.standby.is_leader
            ),
        )
        # Scrape-tree delegate surface (cluster/scrapetree.py): ANY member
        # can scrape a ring span on the leader's behalf — delegates are
        # picked per cycle, so there is nothing to elect.
        self.scrape_delegate = ScrapeDelegate(
            self.rpc,
            timeout_s=config.scrape_timeout_s,
            concurrency=config.scrape_concurrency,
            metrics=self.metrics,
        )
        methods = traced_methods({
            **self.sdfs_member.methods(),
            **self.worker.methods(),
            **(self.generate_worker.methods() if self.generate_worker else {}),
            **self.model_loader.methods(),
            **self.obs.methods(),
            **self.scrape_delegate.methods(),
            "node.info": self._node_info,
            "node.status": lambda p: self.status(remote=False),
        })
        self.member_server = TcpRpcServer(
            config.host, config.member_port, methods, auth=self.auth,
            metrics=self.metrics, lane=self.lane,
        )
        self.self_member_addr = self.member_server.address
        if self.self_member_addr != self.lane:  # OS-assigned port (port 0)
            self.lane = self.self_member_addr
            self.flight.node = self.lane
            self.obs.lane = self.lane
            self.member_server.lane = self.lane
            self.devicemon.member = self.lane

        # --- leader-candidate machinery --------------------------------
        candidates = config.leader_candidates or [f"{config.host}:{config.leader_port}"]
        self.leader_candidates = list(candidates)
        self.self_leader_addr = f"{config.host}:{config.leader_port}"
        self.is_candidate = self.self_leader_addr in self.leader_candidates
        self.tracker = LeaderTracker(
            self.rpc, self.leader_candidates, retry_policy=self.retry_policy
        )

        self.leader_server = None
        self.sdfs_leader = None
        self.scheduler = None
        self.standby = None
        self.mesh_bootstrap = None
        self.advisor = None
        self.slo = None
        self.scrapetree = None
        self.autoscaler = None
        self.genrouter = None
        if self.is_candidate:
            self._start_leader_services()

        self.sdfs = SdfsClient(
            self.rpc,
            self.tracker.current,
            self.store,
            self.self_member_addr,
            chunk_bytes=config.transfer_chunk_bytes,
            timeout_s=config.rpc_deadline_s,
            transfer_timeout_s=config.transfer_deadline_s,
            retry_policy=self.retry_policy,
        )
        for backend in self.worker.backends.values():
            if isinstance(backend, ExportedBackend) and backend.sdfs is None:
                backend.sdfs = self.sdfs

        # BASELINE "SDFS shard" config: members with no local corpus resolve
        # class images through the replicated store, cached on local disk.
        # Wired after SdfsClient exists; only backends this node built get it.
        if self.config.data_from_sdfs:
            from dmlc_tpu_torch.scheduler.dataset import SdfsImageSource

            source = SdfsImageSource(
                self.sdfs, Path(self.config.storage_dir).parent / "data_cache"
            )
            for backend in self.worker.backends.values():
                if hasattr(backend, "image_source") and backend.image_source is None:
                    backend.image_source = source

        # --- fleet decode tier (cluster/decodetier.py) -------------------
        # Ship raw JPEG bytes to peers' idle decode lanes so streamed
        # ingest decode scales with membership instead of one host's
        # cores. ONE client per node, built here (never per call);
        # backends source run_paths_stream's prefetch through it. Wired
        # before the DynamicBatcher wrap below so the attribute lands on
        # the raw backends.
        self.decode_tier = None
        if config.decode_tier_enabled:
            self.decode_tier = DecodeTierClient(
                self.rpc,
                lambda: [
                    a
                    for a in self.active_member_addrs()
                    if a != self.self_member_addr
                ],
                min_batch=config.decode_tier_min_batch,
                max_bytes_per_rpc=config.decode_tier_max_bytes_per_rpc,
                timeout_s=config.rpc_deadline_s,
                retry_policy=self.retry_policy,
                metrics=self.metrics,
                flight=self.flight,
            )
            for backend in self.worker.backends.values():
                if hasattr(backend, "decode_tier"):
                    backend.decode_tier = self.decode_tier

        # Dynamic request micro-batching, wrapped LAST so the wiring above
        # (image_source assignment) still hits the raw backends. With a
        # deadline configured, concurrent small `job.predict` RPCs coalesce
        # into device-shaped batches (scheduler/worker.py).
        self._batchers: list[DynamicBatcher] = []
        if config.microbatch_wait_s > 0:
            for name, backend in list(self.worker.backends.items()):
                wrapped = DynamicBatcher(
                    backend,
                    batch_size=config.batch_size,
                    max_wait_s=config.microbatch_wait_s,
                    name=f"microbatch-{name}",
                    # Bounded queue + brownout: as the queue fills the
                    # coalescing wait shrinks to zero, and a full queue
                    # sheds with Overloaded.
                    max_queue=config.predict_max_queue,
                    metrics=self.metrics,
                    flight=self.flight,
                    tenants=self.tenant_specs,
                )
                self.worker.backends[name] = wrapped
                self._batchers.append(wrapped)
                self.registry.gauge(
                    f"microbatch_queue_{name}", lambda b=wrapped: len(b._queue)
                )

        # --- elastic autoscaler (scheduler/autoscaler.py) ----------------
        # Built LAST: its scale targets hold the decode tier, the generate
        # backends, and (on a leader candidate) the placement advisor, all
        # wired above. Ticked from the leader's obs scrape loop right after
        # the SLO evaluation it keys off — a non-leading node registers its
        # local seams but never ticks.
        if config.autoscaler_enabled:
            self.autoscaler = Autoscaler(
                flight=self.flight,
                metrics=self.metrics,
                clock=self.clock.monotonic,
                clear_windows=config.autoscaler_clear_windows,
                moves_budget=config.autoscaler_moves_budget,
                hbm_ceiling=config.autoscaler_hbm_ceiling,
                hbm_used=self._fleet_hbm_used,
            )
            if self.decode_tier is not None:
                self.autoscaler.register(ScaleTarget(
                    "decode_fanout",
                    get=self.decode_tier.fanout,
                    apply=self.decode_tier.set_fanout,
                    lo=1,
                    hi=self.decode_tier.max_fanout,
                ))
            for name, gb in self._gen_backends.items():
                self.autoscaler.register(ScaleTarget(
                    f"gen_slots_{name}",
                    get=gb.slot_limit,
                    apply=gb.set_slot_limit,
                    lo=1,
                    hi=gb.max_slots,
                    models={name},
                    memory_bound=True,  # slots pin KV pages on the device
                    # Scale-down-through-drain: hold the shrink while more
                    # slots than the proposed limit are mid-decode —
                    # resident streams finish (or the router migrates
                    # them), they are never cut.
                    drain=lambda keep, b=gb: b.slots_resident() <= keep,
                ))
            if self.advisor is not None:
                for name in self.config.job_models:
                    self.autoscaler.register(ScaleTarget(
                        f"replicas_{name}",
                        get=lambda n=name: self._replica_current(n),
                        apply=lambda v, n=name: self._apply_replica_target(n, v),
                        lo=config.autoscaler_min_replicas,
                        hi=config.autoscaler_max_replicas,
                        models={name},
                        # Retiring a replica of a generation-serving model
                        # goes through the router's drain (sessions finish
                        # or migrate) before the shrink lands.
                        drain=(
                            (lambda keep, n=name:
                             self.genrouter.release_capacity(n, keep))
                            if self.genrouter is not None
                            and name in self._gen_backends else None
                        ),
                    ))

    def _replica_current(self, name: str) -> int:
        """Autoscaler read seam for per-model replica counts: the explicit
        target once one is set, else the advisor's live assignment width
        (gang width counts — a gang is one multi-chip replica set)."""
        adv = self.advisor
        if adv is None:
            return self.config.autoscaler_min_replicas
        target = adv.replica_targets.get(name)
        if target is not None:
            return target
        assigned = adv.status()["assignment"].get(name)
        return len(assigned) if assigned else self.config.autoscaler_min_replicas

    def _apply_replica_target(self, name: str, value: int) -> int:
        """Autoscaler apply seam: pin the advisor's replica target and ask
        the scheduler to replan now — a shrink marks the cached plan stale,
        a growth raises the dealing cap (and widens gangs)."""
        if self.advisor is None:
            return value
        self.advisor.set_replica_target(name, value)
        if self.scheduler is not None:
            self.scheduler.request_replan(f"autoscale:{name}")
        return value

    def _member_gauges(self, addr: str) -> dict:
        """GenRouter's routing signal: one member's gauges from the last
        obs scrape (LOCAL cache read by contract — never an RPC). Empty
        while the member is dark; the router falls back to its own
        session-residency view."""
        reply = self.fleet_metrics.get(addr)
        if not reply:
            return {}
        return (reply.get("metrics") or {}).get("gauges", {}) or {}

    def _fleet_hbm_used(self) -> float | None:
        """Worst-device memory occupancy fraction across the last fleet
        scrape (the autoscaler's scale-up guard). None while the device
        plane is dark — unknown never blocks."""
        worst = None
        for reply in self.fleet_metrics.values():
            gauges = (reply.get("metrics") or {}).get("gauges", {})
            limit = gauges.get("hbm_limit_bytes")
            used = gauges.get("hbm_bytes_in_use")
            if limit and used is not None and float(limit) > 0:
                frac = float(used) / float(limit)
                worst = frac if worst is None else max(worst, frac)
        return worst

    # ---- leader side ---------------------------------------------------

    def _load_workload(self) -> list[tuple[str, int]]:
        from dmlc_tpu_torch.ops.preprocess import load_synset_words

        path = Path(self.config.synset_path)
        if not path.exists():
            return []
        return [(synset, i) for i, (synset, _) in enumerate(load_synset_words(path))]

    def _start_leader_services(self) -> None:
        workload = self._load_workload()
        self.sdfs_leader = SdfsLeader(
            self.rpc,
            self.active_member_addrs,
            self.config.replication_factor,
            # Leadership is claimed via StandbyLeader.step(); until then this
            # candidate's SDFS surface refuses writes (they would be lost to
            # the next directory sync).
            is_leading=False,
            fanout=self.config.replicate_fanout,
            transfer_timeout_s=self.config.transfer_deadline_s,
        )
        self._weight_cache: dict[str, tuple[int, float]] = {}
        # Profile-driven placement (scheduler/placement.py): consulted by
        # every assignment pass; falls back to round-robin whenever the
        # profiles are too thin to advise.
        if self.config.placement_enabled:
            self.advisor = PlacementAdvisor(
                self.profiler,
                flight=self.flight,
                metrics=self.metrics,
                clock=self.clock.monotonic,
                max_moves=self.config.placement_max_moves,
                window_s=self.config.placement_window_s,
                hysteresis=self.config.placement_hysteresis,
                exclude_factor=self.config.placement_exclude_factor,
                # Ingest-aware placement: weight assignment toward members
                # with idle decode lanes and local SDFS blobs, read from the
                # obs scrape + SDFS directory.
                decode_idle=self._member_decode_idle,
                blob_locality=self._member_blob_locality,
                # Memory-headroom HARD constraint (devicemon): a model is
                # never assigned to a member whose scraped device-memory
                # headroom cannot hold its analytic resident bytes.
                headroom=self._member_hbm_headroom,
                model_bytes=self._model_required_bytes,
            )
        self.scheduler = JobScheduler(
            self.rpc,
            self.active_member_addrs,
            jobs={name: list(workload) for name in self.config.job_models},
            shard_size=self.config.dispatch_shard_size,
            shard_timeout_s=self.config.predict_deadline_s,
            member_weight=self._member_weight,
            hedge_tail=self.config.hedge_tail,
            mesh_group=self._mesh_group,
            retry_policy=self.retry_policy,
            gray_factor=self.config.gray_factor,
            gray_min_latency_s=self.config.gray_min_latency_s,
            gray_probe_interval_s=self.config.gray_probe_interval_s,
            metrics=self.metrics,
            flight=self.flight,
            profiler=self.profiler,
            advisor=self.advisor,
        )
        # Gang placement read-out: the planned gang width per job (0 =
        # solo/replicated serving), scrapeable beside the per-member
        # resident_bytes_<model> gauges.
        for job_name in self.config.job_models:
            self.registry.gauge(
                f"gang_world_{job_name}",
                lambda n=job_name: self.scheduler.jobs[n].gang_world,
            )
        # SLO burn-rate evaluation (scheduler/placement.SloEvaluator): runs
        # on the scrape cadence while leading; a fast-burn edge asks the
        # scheduler for a replan — the closed loop the objectives exist for.
        if self.config.slo_objectives:
            self.slo = SloEvaluator(
                self.profiler,
                SloObjective.from_config(self.config.slo_objectives),
                fast_window_s=self.config.slo_fast_window_s,
                slow_window_s=self.config.slo_slow_window_s,
                fast_burn=self.config.slo_fast_burn,
                slow_burn=self.config.slo_slow_burn,
                metrics=self.metrics,
                flight=self.flight,
                registry=self.registry,
                on_fast_burn=lambda model: self.scheduler.request_replan(
                    f"slo_fast_burn:{model}"
                ),
                # Per-tenant burn lanes: each declared tenant's traffic is
                # scored against the model objective on its own
                # ``model@tenant`` profiler lane.
                tenants=sorted(self.tenant_specs),
                tenant_guard=self.tenant_guard,
                # Root-cause attribution: every burn alert names the
                # model's top critical-path contributor.
                attribution=self.fleet_critpath.culprit,
            )
        # Survivable generation sessions (scheduler/genrouter.py): the
        # leader routes job.generate by the scraped per-member gauges and
        # owns the session ledger that failure-triggered migration and
        # drain work from. Built on every candidate — the routing verbs
        # refuse until StandbyLeader promotes, and the standby sync loop
        # mirrors the acting leader's ledger in the meantime.
        self.genrouter = GenRouter(
            self.rpc,
            self.active_member_addrs,
            metrics_for=self._member_gauges,
            tenants=self.tenant_specs,
            max_sessions=self.config.gen_router_max_sessions,
            drain_deadline_s=self.config.gen_drain_deadline_s,
            # Same idle budget as the member-side sweep: both planes reap
            # an abandoned stream after the same silence.
            session_ttl_s=self.config.gen_session_ttl_s,
            timeout_s=self.config.rpc_deadline_s,
            retry_policy=self.retry_policy,
            metrics=self.metrics,
            flight=self.flight,
            clock=self.clock.monotonic,
        )
        self.scheduler.extra_status = self.genrouter.status
        self.registry.gauge("gen_drain_active", self.genrouter.drain_active)
        # Delegated scrape tree (cluster/scrapetree.py): past
        # scrape_tree_min_members the scrape loop partitions the ring and
        # folds delegate partials instead of calling every member itself.
        self.scrapetree = ScrapeTreeCoordinator(
            self.rpc,
            clock=self.clock.monotonic,
            span_size=self.config.scrape_span_size,
            timeout_s=self.config.scrape_timeout_s,
            concurrency=self.config.scrape_concurrency,
            metrics=self.metrics,
            flight=self.flight,
        )
        methods = {
            **self.sdfs_leader.methods(),
            **self.scheduler.methods(),
            **self.genrouter.methods(),
            # Fleet-wide observability read-outs: the latest obs.metrics
            # snapshot per member (scraped by _obs_scrape_loop while
            # leading), raw and as Prometheus text, plus the tree-merged
            # fleet rollup and any spans dark this cycle, the SLO, placement
            # and autoscaler state, and the fleet critical-path table with
            # the drift sentinel's state.
            **traced_methods({
                "obs.fleet": lambda p: {
                    "fleet": dict(self.fleet_metrics),
                    "merged": dict(self.fleet_merged),
                    "stale": list(self.fleet_stale),
                },
                "obs.fleet_prom": lambda p: {
                    "text": observe.render_fleet_prometheus(dict(self.fleet_metrics))
                },
                "obs.slo": lambda p: {
                    "slo": self.slo.status() if self.slo is not None else {},
                    "placement": (
                        self.advisor.status() if self.advisor is not None else {}
                    ),
                    "autoscaler": (
                        self.autoscaler.status()
                        if self.autoscaler is not None else {}
                    ),
                },
                "obs.critpath": lambda p: {
                    "critpath": self.fleet_critpath.table(),
                    "sentinel": (
                        self.sentinel.status()
                        if self.sentinel is not None else {}
                    ),
                },
            }),
        }
        if self.config.mesh_processes > 1:
            from dmlc_tpu_torch.parallel.multihost import MeshBootstrap

            self.mesh_bootstrap = MeshBootstrap(
                self.config.mesh_coordinator_port,
                self.config.mesh_processes,
                is_leading=False,  # promoted with the rest by StandbyLeader
            )
            methods.update(self.mesh_bootstrap.methods())
        self.leader_server = TcpRpcServer(
            self.config.host, self.config.leader_port, methods, auth=self.auth,
            metrics=self.metrics, lane=self.lane,
        )
        # Leadership is claimed via StandbyLeader.step(), never assumed at
        # boot: a restarted ex-leader must defer to whoever promoted while
        # it was down instead of double-leading.
        self.standby = StandbyLeader(
            self.rpc,
            self.self_leader_addr,
            self.leader_candidates,
            self.scheduler,
            sdfs_leader=self.sdfs_leader,
            mesh_bootstrap=self.mesh_bootstrap,
            genrouter=self.genrouter,
        )

    # ---- topology ------------------------------------------------------

    def _mesh_group(self):
        """Scheduler hook: {member_addr: mesh rank} once the fleet's default
        torch.distributed group is fully registered (members register with
        their member RPC address, join_global_mesh), else None — the
        scheduler then gang-dispatches shards to the whole mesh as one
        collective execution instead of per-member silos."""
        mb = self.mesh_bootstrap
        return None if mb is None else mb.group()

    def _node_info(self, p: dict) -> dict:
        """Member RPC: this host's chip capacity, for the leader's weighted
        placement: the process's CUDA devices when the engines run on the
        card, 1 when they run on the CPU."""
        chips = self.config.chips_per_host
        if chips <= 0:
            kind = torch.device(self.device).type if self.device is not None else "cuda"
            on_card = kind == "cuda" and torch.cuda.is_available()
            chips = max(1, torch.cuda.device_count()) if on_card else 1
        info: dict = {"chips": int(chips)}
        # Idle decode lanes right now.
        info["decode_lane_idle"] = int(self.worker.decode_lane_idle())
        if self._batchers:
            # Micro-batching observability: per-model coalescing counters
            # ride the same member-info RPC the leader already polls.
            info["microbatch"] = {
                name: b.summary()
                for name, b in self.worker.backends.items()
                if isinstance(b, DynamicBatcher)
            }
        return info

    def _member_weight(self, addr: str) -> int:
        """TTL-cached node.info lookup used by the scheduler's assignment
        pass; unreachable members keep their last known (or unit) weight."""
        now = self.clock.monotonic()
        cached = self._weight_cache.get(addr)
        if cached is not None and now - cached[1] < 30.0:
            return cached[0]
        try:
            w = int(self.rpc.call(addr, "node.info", {}, timeout=2.0)["chips"])
        except Exception:
            w = cached[0] if cached is not None else 1
        self._weight_cache[addr] = (w, now)
        return w

    def _member_decode_idle(self, member: str) -> float | None:
        """Idle decode lanes from the leader's last obs scrape of this
        member (the `decode_lane_idle` gauge every node registers). None
        when the member hasn't been scraped yet — the advisor treats
        unknown as neutral, never as zero capacity."""
        reply = self.fleet_metrics.get(member)
        if not reply:
            return None
        v = (reply.get("metrics") or {}).get("gauges", {}).get("decode_lane_idle")
        return float(v) if v is not None else None

    def _member_hbm_headroom(self, member: str) -> float | None:
        """Device-memory headroom (limit - in_use bytes) from the leader's
        last obs scrape of this member (the devicemon gauges every node
        registers). None when unscraped or when the member reports no
        memory stats (CPU) — unknown never blocks placement."""
        reply = self.fleet_metrics.get(member)
        if not reply:
            return None
        gauges = (reply.get("metrics") or {}).get("gauges", {})
        limit, used = gauges.get("hbm_limit_bytes"), gauges.get("hbm_bytes_in_use")
        if limit is None or used is None:
            return None
        return float(limit) - float(used)

    def _model_required_bytes(self, model: str) -> float | None:
        """Analytic weights residency for the headroom constraint. None for
        models without a registry entry (test jobs) — no constraint rather
        than a false refusal."""
        try:
            from dmlc_tpu_torch.models.registry import get_model

            return float(get_model(model).param_bytes())
        except Exception:  # noqa: BLE001 - unknown models place unconstrained
            return None

    def _member_blob_locality(self, member: str) -> float | None:
        """Fraction of the SDFS directory this member replicates — blobs it
        can decode without fetching first."""
        if self.sdfs_leader is None:
            return None
        return self.sdfs_leader.blob_locality(member)

    # ---- liveness glue -------------------------------------------------

    def active_member_addrs(self) -> list[str]:
        offset = self.config.member_port - self.config.gossip_port
        return [
            member_rpc_addr(addr, offset) for addr, _ in self.membership.active_ids()
        ]

    # ---- lifecycle -----------------------------------------------------

    def start(self) -> None:
        """Spawn the periodic loops (the reference's tokio tasks). Model
        engines warm up first — a long first build must not starve the
        heartbeat threads into a false FAILED verdict."""
        if self.config.eager_load:
            from dmlc_tpu_torch import native

            # Best effort: a host without libjpeg decodes through PIL.
            try:
                native.ensure_built()
            except Exception:
                log.exception("native decoder unavailable; PIL decodes")
            for backend in [
                *self.worker.backends.values(),
                *self._gen_backends.values(),
            ]:
                if not hasattr(backend, "warmup"):
                    continue
                try:
                    backend.warmup()
                except Exception:
                    # Best-effort: an ExportedBackend on a FRESH cluster has
                    # nothing to fetch yet (the artifact is published by the
                    # running cluster's `export` verb) — it must not kill
                    # bootstrap. The backend stays lazy and builds on the
                    # first shard instead.
                    log.exception("eager warmup failed; backend will build lazily")
        self._spawn(self._membership_loop)
        self._spawn(self._probe_loop)
        if self.config.devicemon_poll_interval_s > 0:
            self._spawn(self._devicemon_loop)
        if self.config.scrub_interval_s > 0:
            self._spawn(self._scrub_loop)
        if self.is_candidate:
            self._spawn(self._heal_loop)
            self._spawn(self._assign_loop)
            self._spawn(self._obs_scrape_loop)
            for _ in range(max(1, self.config.dispatch_workers)):
                self._spawn(self._dispatch_loop)
            self._spawn(self._standby_loop)
            self._spawn(self._genrouter_loop)

    def _spawn(self, fn) -> None:
        def run() -> None:
            # Every span a maintenance thread records (dispatch, heal,
            # probes) attributes to this node's lane in traces.
            with tracing.lane(self.lane):
                fn()

        t = threading.Thread(target=run, daemon=True, name=fn.__name__)
        t.start()
        self._threads.append(t)

    def flight_dump_path(self) -> Path:
        """Where this node's flight-recorder ring lands on crash/stop —
        a sibling of the storage dir, so postmortems of a wiped node still
        find it."""
        base = Path(self.config.storage_dir)
        return base.parent / (base.name + ".flight.json")

    def profile_path(self) -> Path:
        """Where this node's cost-profile snapshot persists (same sibling
        convention as the flight dump) for restart warm-start."""
        base = Path(self.config.storage_dir)
        return base.parent / (base.name + ".profile.json")

    def export_fleet_trace(self, path: str | Path) -> dict:
        """Collect + write one merged fleet trace (CLI ``trace fleet``),
        with this node's flight recorder armed for the skew-clamp alarm;
        the worst residual skew lands in the ``trace_max_skew_s`` gauge."""
        doc = observe.export_fleet_trace(
            self.rpc,
            sorted(set(self.active_member_addrs()) | {self.self_member_addr}),
            path,
            flight=self.flight,
            skew_alert_s=self.config.trace_skew_alert_s,
        )
        nodes = doc.get("otherData", {}).get("nodes", {})
        self._trace_max_skew = max(
            (float(v.get("max_skew_s") or 0.0) for v in nodes.values()),
            default=0.0,
        )
        return doc

    def stop(self) -> None:
        self._stop.set()
        for b in self._batchers:
            b.stop(timeout_s=2.0)
        for gb in self._gen_backends.values():
            gb.stop(timeout_s=2.0)
        for t in self._threads:
            t.join(timeout=2.0)
        self.devicemon.close()  # unsubscribe from the process-global census
        self.member_server.close()
        if self.leader_server is not None:
            self.leader_server.close()
        self.gossip.close()
        if self.config.profile_persist:
            self.profiler.save(self.profile_path())
        self.flight.note("node_stop")
        self.flight.dump(self.flight_dump_path(), reason="stop")

    def _timer(self, name: str, interval: float, body) -> None:
        """Register ``body`` as the named timer and tick it on the wall
        clock. All cadenced maintenance goes through this one seam so the
        timer table (``self.timers``) is the complete, firable inventory of
        this node's periodic work."""
        self.timers.register(name, interval, body)
        self._loop(interval, lambda: self.timers.fire(name))

    def _loop(self, interval: float, body) -> None:
        while not self._stop.is_set():
            try:
                body()
            except Exception as e:
                # A crashed maintenance loop is exactly the moment the ring
                # must survive: record the transition and dump to disk so a
                # postmortem has the (bounded) event history leading up.
                self.flight.note(
                    "loop_error",
                    loop=getattr(body, "__qualname__", str(body)),
                    error=f"{type(e).__name__}: {e}",
                )
                self.flight.dump(self.flight_dump_path(), reason="loop_error")
                log.exception("maintenance loop error")
            self._stop.wait(interval)

    def _membership_loop(self):
        self._timer("membership", self.config.heartbeat_interval_s,
                    self.membership.step)

    def _devicemon_loop(self):
        """HBM watermark/alert poll (cluster/devicemon.py): tracks the
        high-water mark and fires the ``hbm_high_watermark`` flight event
        on the alert-fraction edge."""
        self._timer("devicemon", self.config.devicemon_poll_interval_s,
                    self.devicemon.poll)

    def _probe_loop(self):
        def body():
            self.tracker.probe()
            self.sdfs.leader_addr = self.tracker.current
            if not self._announced:
                self._try_announce()

        self._timer("probe", self.config.leader_probe_interval_s, body)

    def _try_announce(self) -> None:
        """Push this store's recovered inventory to the acting leader
        (sdfs.announce) so a restarted member's replicas re-enter the
        directory instead of being healed around. Retried each probe tick
        until a leader accepts it (a standby refuses writes) — through the
        shared retry policy, so a down/drowning leader costs one budgeted
        announce per breaker window, not one per tick."""
        leader = self.tracker.current
        if not self.retry_policy.allow_retry(leader):
            return  # breaker open or budget dry: the next window retries
        try:
            reply = self.rpc.call(
                leader,
                "sdfs.announce",
                {"member": self.self_member_addr, "inventory": self.store.inventory()},
                timeout=5.0,
            )
            self.retry_policy.record(leader)
        except Exception as e:
            from dmlc_tpu_torch.cluster.rpc import RpcError

            if isinstance(e, RpcError):
                self.retry_policy.record(leader, e)
            log.debug("inventory announce deferred: %s", e)
            return
        self._announced = True
        # The leader's verdicts on our recovered state: names wholly below
        # a delete tombstone are dropped, digest-divergent copies park in
        # quarantine (never served, never a heal source).
        for name in reply.get("dead", []):
            self.store.delete(name)
        for name, version in reply.get("corrupt", []):
            self.store.quarantine(name, int(version))

    def _scrub_loop(self):
        """Member-side anti-entropy: re-hash a bounded batch of stored
        blobs per tick; quarantine rot locally and report it to the leader
        so heal_once re-places from verified replicas."""

        def body():
            _, corrupt = self.store.scrub_once(self.config.scrub_batch)
            for name, version in corrupt:
                # The quarantine itself is already in the ring (MemberStore
                # notes it); this records the scrub VERDICT + report hop.
                self.flight.note("scrub_corrupt", name=name, version=int(version))
                self.sdfs.report_corrupt(name, version, self.self_member_addr)

        self._timer("scrub", self.config.scrub_interval_s, body)

    def scrub(self) -> dict:
        """CLI verb: one FULL verification pass over this node's store
        (the periodic loop scrubs incrementally); corrupt copies are
        quarantined and reported for healing."""
        scanned, corrupt = self.store.scrub_once(None)
        for name, version in corrupt:
            self.sdfs.report_corrupt(name, version, self.self_member_addr)
        return {"scanned": scanned, "corrupt": corrupt}

    def _heal_loop(self):
        self._timer(
            "heal", self.config.rereplication_interval_s,
            lambda: self._if_leading(lambda: self.sdfs_leader.heal_once()),
        )

    def _assign_loop(self):
        self._timer(
            "assign", self.config.assignment_interval_s,
            lambda: self._if_leading(self.scheduler.assign_once),
        )

    def _dispatch_loop(self):
        """One dispatcher worker. config.dispatch_workers of these run
        concurrently; each blocks on one shard RPC at a time, so together
        they keep up to W shards in flight across the assigned members
        (the scheduler's offset reservation makes this safe)."""

        def body():
            if self.standby.is_leader and self.scheduler.has_dispatchable():
                if self.scheduler.dispatch_all_once() > 0:
                    return  # progress made: loop immediately, no sleep
            # Idle or failing (e.g. every assigned member erroring): back
            # off so retries don't become a zero-sleep RPC flood.
            self._stop.wait(0.05)

        # W workers share one registration (the body is stateless between
        # ticks); the registry needs the NAME firable, not the thread count.
        self.timers.register("dispatch", 0.05, body)
        while not self._stop.is_set():
            try:
                self.timers.fire("dispatch")
            except Exception:
                log.exception("dispatch loop error")

    def _standby_loop(self):
        self._timer("standby", self.config.leader_probe_interval_s,
                    self.standby.step)

    def _obs_scrape_loop(self):
        """Leader-side fleet metrics scrape: while leading, refresh every
        active member's ``obs.metrics`` on the probe cadence — directly
        (bounded concurrency, per-scrape deadlines) for small fleets,
        through the delegated scrape tree past ``scrape_tree_min_members``.
        ``obs.fleet``/``obs.fleet_prom`` and the CLI ``metrics fleet`` verb
        read from here. Each pass also closes the profile loop: scrapes
        fold into the leader's cost profiler and fleet critical-path table,
        the drift sentinel ticks, the SLO evaluator re-judges the burn rates
        (a fast-burn edge forces fleet-wide trace sampling when configured)
        and ticks the autoscaler, and the profile snapshot persists for
        warm-start."""

        def body():
            cfg = self.config
            addrs = self.active_member_addrs()
            if (
                self.scrapetree is not None
                and cfg.scrape_tree_enabled
                and len(addrs) >= cfg.scrape_tree_min_members
            ):
                result = self.scrapetree.scrape(addrs)
                fleet = result.members
                self.fleet_merged = result.merged_summary
                self.fleet_stale = sorted(
                    a for s in result.stale_spans for a in s["addrs"]
                )
            else:
                fleet = observe.scrape_fleet_metrics(
                    self.rpc, addrs, timeout=cfg.scrape_timeout_s,
                    concurrency=cfg.scrape_concurrency, metrics=self.metrics,
                )
                self.fleet_stale = []
            self.fleet_metrics = fleet
            for addr, reply in fleet.items():
                self.profiler.ingest_scrape(addr, reply)
                # Critical-path snapshots ride the same scrape reply: fold
                # the fleet table the drift sentinel reads from.
                crit = reply.get("critpath")
                if crit is not None:
                    self.fleet_critpath.fold(addr, crit)
            self.fleet_critpath.prune(addrs)
            if self.sentinel is not None:
                self.sentinel.tick(self.fleet_critpath.table())
            if self.slo is not None:
                state = self.slo.evaluate()
                if self.autoscaler is not None:
                    # Close the elastic loop on the same cadence the burn
                    # verdicts refresh: burning lanes (including per-tenant
                    # composites) drive scale-up, quiet streaks scale-down.
                    self.autoscaler.tick(
                        self.slo.burning_models(),
                        {lane: st.get("fast", 0.0)
                         for lane, st in state.items()},
                    )
                if cfg.trace_burn_force_sample_s > 0:
                    burning = [m for m, st in sorted(state.items())
                               if st.get("fast_alert")]
                    if burning:
                        # Burn-flagged traffic must leave whole traces, not
                        # a head-sampling lottery: force-sample locally and
                        # push the window to every member (best-effort).
                        tracing.tracer.force_sampling(
                            cfg.trace_burn_force_sample_s
                        )
                        observe.force_fleet_sampling(
                            self.rpc, addrs, cfg.trace_burn_force_sample_s,
                            timeout=cfg.scrape_timeout_s,
                        )
            if self.config.profile_persist:
                self.profiler.save(self.profile_path())

        self._timer(
            "obs_scrape", self.config.leader_probe_interval_s,
            lambda: self._if_leading(body),
        )

    def _if_leading(self, fn):
        if self.standby is not None and self.standby.is_leader:
            fn()

    def _genrouter_loop(self) -> None:
        """While leading: migrate generation sessions off dead, convicted,
        or drain-expired members and retire completed drains
        (scheduler/genrouter.py tick)."""
        self._timer(
            "genrouter", self.config.leader_probe_interval_s,
            lambda: self._if_leading(self.genrouter.tick),
        )

    # ---- drift sentinel hooks (cluster/sentinel.py) --------------------

    def _drift_force_sample(self, seconds: float) -> None:
        """Sentinel alert hook: open a forced trace-sampling window locally
        and push it to every member (best-effort) — the drift window must
        be densely traced, not a head-sampling lottery."""
        tracing.tracer.force_sampling(seconds)
        observe.force_fleet_sampling(
            self.rpc, sorted(self.active_member_addrs()), seconds,
            timeout=self.config.scrape_timeout_s,
        )

    def _drift_request_replan(self, reason: str) -> None:
        """Sentinel localization hook: drift pinned to one member asks the
        scheduler for a placement replan under that evidence."""
        self.scheduler.request_replan(reason)

    # ---- CLI-facing verbs ---------------------------------------------

    def join(self, introducer_gossip_addr: str) -> None:
        self.membership.join(introducer_gossip_addr)

    def leave(self) -> None:
        self.membership.leave()

    def train(self) -> dict:
        """The reference's `train`: broadcast model weights to every member
        through SDFS (services.rs:139-144) — each member pulls the latest
        weights file for each job model and hot-swaps it into its running
        engine (the reference loads .ot files, services.rs:513-524). Pulled
        copies are recorded in the leader directory so ls/delete see them.
        Members are driven concurrently (bounded by rpc_concurrency, the
        reference's 10-way fanout, main.rs:61) so one wedged member delays
        the verb by one timeout, not one timeout per member behind it."""
        import concurrent.futures

        results = {}
        for name in self.config.job_models:
            sdfs_name = f"models/{name}"
            pulled: list[str] = []
            loaded: list[str] = []
            results[sdfs_name] = {"pulled": pulled, "loaded": loaded}
            try:
                info = self.rpc.call(
                    self.tracker.current, "sdfs.get", {"name": sdfs_name},
                    timeout=self.config.rpc_deadline_s,
                )
            except Exception as e:
                log.warning("train: no weights for %s: %s", sdfs_name, e)
                continue
            have = set(info["replicas"])

            def push_one(member: str) -> None:
                if member not in have:  # existing replicas skip the re-transfer
                    self.rpc.call(
                        member,
                        "sdfs.replicate",
                        {
                            "name": sdfs_name,
                            "version": info["version"],
                            "source": info["replicas"][0],
                            "from_stage": False,
                            # The puller verifies the weights against the
                            # directory digest before committing them.
                            "digest": info.get("digest"),
                        },
                        timeout=self.config.transfer_deadline_s,
                    )
                    pulled.append(member)
                    try:
                        self.rpc.call(
                            self.tracker.current,
                            "sdfs.record",
                            {"name": sdfs_name, "version": info["version"],
                             "member": member, "digest": info.get("digest")},
                            timeout=self.config.rpc_deadline_s,
                        )
                    except Exception as e:
                        log.warning("train: record %s@%s: %s", sdfs_name, member, e)
                self.rpc.call(
                    member,
                    "model.load",
                    {"model": name, "version": info["version"]},
                    timeout=120.0,
                )
                loaded.append(member)

            with concurrent.futures.ThreadPoolExecutor(
                max_workers=max(1, self.config.rpc_concurrency)
            ) as pool:
                futures = {
                    pool.submit(push_one, m): m for m in self.active_member_addrs()
                }
                for fut, member in futures.items():
                    try:
                        fut.result()
                    except Exception as e:
                        log.warning("train: %s -> %s: %s", sdfs_name, member, e)
        return results

    def join_global_mesh(self, timeout_s: float = 120.0) -> dict:
        """Form/join the fleet-wide torch.distributed group via the elected
        leader (config.mesh_processes processes -> ONE global mesh), on
        the node's device. Explicit, not automatic: a process joins one
        group in its life, so the operator (or deploy script) triggers it
        once the fleet is assembled."""
        from dmlc_tpu_torch.parallel import multihost

        return multihost.join_global_mesh(
            self.rpc,
            lambda: self.tracker.current,  # re-resolved per poll: failover-safe
            self.self_member_addr,
            timeout_s=timeout_s,
            device=self.device,
        )

    def predict(self) -> dict:
        return self.rpc.call(
            self.tracker.current, "job.start", {}, timeout=self.config.rpc_deadline_s
        )

    def generate(
        self,
        model: str,
        prompt: list[int],
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        seed: int | None = None,
    ) -> dict:
        """CLI verb: stream one generation to completion. Routed through
        the acting leader's session router when one answers — the stream
        then survives member death, drain, and leader failover — with
        member-direct dialing as the fallback for routerless fleets."""
        from dmlc_tpu_torch.cluster.rpc import RpcError, RpcUnreachable
        from dmlc_tpu_torch.generate import worker as gen_worker

        try:
            tokens = gen_worker.generate(
                self.rpc, self.tracker.current, model, prompt,
                max_new_tokens=max_new_tokens, temperature=temperature,
                seed=seed, poll_timeout=self.config.rpc_deadline_s,
            )
            return {"member": self.tracker.current, "routed": True,
                    "tokens": tokens}
        except (RpcUnreachable, RpcError) as e:
            msg = str(e)
            if not isinstance(e, RpcUnreachable) and \
                    "unknown method" not in msg and \
                    "not the active leader" not in msg:
                raise  # a routed verdict (quota shed, no member, …)
            log.warning("leader routing unavailable (%s); dialing members", e)
        addrs = [self.self_member_addr] if model in self._gen_backends else []
        addrs += [a for a in self.active_member_addrs() if a not in addrs]
        last: Exception | None = None
        for addr in addrs:
            try:
                tokens = gen_worker.generate(
                    self.rpc, addr, model, prompt,
                    max_new_tokens=max_new_tokens, temperature=temperature,
                    seed=seed, poll_timeout=self.config.rpc_deadline_s,
                )
                return {"member": addr, "routed": False, "tokens": tokens}
            except RpcError as e:
                last = e
                if "not served here" in str(e):
                    continue  # try a member that hosts the model
                raise
        raise last if last is not None else RpcError(
            f"no active member serves generation for {model!r}"
        )

    def jobs_report(self) -> dict:
        return self.rpc.call(
            self.tracker.current, "job.report", {}, timeout=self.config.rpc_deadline_s
        )["jobs"]

    def assignments(self) -> dict:
        return self.rpc.call(
            self.tracker.current, "job.assignments", {},
            timeout=self.config.rpc_deadline_s,
        )["assigned"]

    def gen_sessions(self) -> list[dict]:
        """CLI ``sessions`` verb: the acting leader's generation-session
        ledger table (scheduler/genrouter.py)."""
        return self.rpc.call(
            self.tracker.current, "job.generate_sessions", {},
            timeout=self.config.rpc_deadline_s,
        )["sessions"]

    def drain(self, member: str, deadline_s: float | None = None) -> dict:
        """CLI ``drain <member>``: stop admitting generation sessions to a
        member; residents finish within the deadline or migrate."""
        payload: dict = {"member": member}
        if deadline_s is not None:
            payload["deadline_s"] = float(deadline_s)
        return self.rpc.call(
            self.tracker.current, "job.drain", payload,
            timeout=self.config.rpc_deadline_s,
        )

    def undrain(self, member: str) -> dict:
        """CLI ``undrain <member>``: reopen a drained member for admission."""
        return self.rpc.call(
            self.tracker.current, "job.undrain", {"member": member},
            timeout=self.config.rpc_deadline_s,
        )

    def status(self, remote: bool = True) -> dict:
        """The overload-control picture from where this node stands: local
        admission gates + batcher queues + this node's counters and breaker
        states, plus (with ``remote``) the acting leader's scheduler-side
        verdicts — sheds, deadline trips, breaker opens, gray demotions.
        Served as ``node.status`` too, so operators can poll any member."""
        out: dict = {
            "member": self.self_member_addr,
            "leader": self.tracker.current,
            "counters": self.metrics.snapshot(),
            "gates": {
                "predict": self.predict_gate.summary(),
                "transfer": self.transfer_gate.summary(),
            },
            "breakers": self.retry_policy.snapshot(),
            "flight_recorded": self.flight.to_wire()["recorded"],
        }
        if self.tenant_specs:
            out["tenants"] = {
                name: {"priority": spec.priority, "share": spec.share}
                for name, spec in sorted(self.tenant_specs.items())
            }
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.status()
        if self._batchers:
            out["microbatch"] = {
                name: b.summary()
                for name, b in self.worker.backends.items()
                if isinstance(b, DynamicBatcher)
            }
        if self.generate_worker is not None:
            out["generate"] = self.generate_worker.summary()
        if remote:
            try:
                reply = self.rpc.call(
                    self.tracker.current, "leader.status", {}, timeout=2.0
                )
                out["cluster"] = reply.get("overload", {})
                out["cluster_leading"] = bool(reply.get("leading"))
                if reply.get("generate"):
                    # Router-side session/drain picture (GenRouter.status):
                    # the CLI renders drain state per member from this.
                    out["cluster_generate"] = reply["generate"]
            except Exception as e:
                out["cluster_error"] = str(e)
        return out
