"""Process bootstrap: one ClusterNode wires every layer for deployment.

Ported from ``dmlc_tpu/cluster/node.py`` with its structure and names, wired
only to modules this package has: the fabric (auth, ``TcpRpc``/
``TcpRpcServer``, admission gates, retry policy, clock, UDP gossip
membership), the SDFS (member store, member, client and leader), the
member's workers (``PredictWorker`` over ``EngineBackend``s,
``GenerateWorker``, ``ModelLoader``, ``DynamicBatcher``) and the leader
(``JobScheduler``, ``LeaderTracker``, ``StandbyLeader``). A node of this
package and one of the JAX package join one fleet: their gossip, RPC frames
and verbs are the same.

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
raises. Left out until this package ports them: the observability plane
(``observe``, ``profile``, ``critpath``, ``sentinel``, ``scrapetree``, and so
the leader's ``obs.*`` verbs), ``devicemon``, ``decodetier``, ``placement``,
``autoscaler``, ``genrouter`` (and the ``gen.*`` routing verbs),
``multihost``, ``LmBackend``, ``ExportedBackend`` and the compile cache.
Their switches that are on by default (``DEFAULT_ON_LEFT_OUT``) are left
out with one warning in the log; a config that turns on one that is off by
default (``refuse_unported``) raises ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path

import torch

from dmlc_tpu_torch.cluster.admission import AdmissionGate
from dmlc_tpu_torch.cluster.clock import Clock, TimerRegistry
from dmlc_tpu_torch.cluster.failover import LeaderTracker, StandbyLeader
from dmlc_tpu_torch.cluster.flight import FlightRecorder
from dmlc_tpu_torch.cluster.membership import MembershipNode
from dmlc_tpu_torch.cluster.retrypolicy import RetryPolicy
from dmlc_tpu_torch.cluster.rpc import TcpRpc, TcpRpcServer
from dmlc_tpu_torch.cluster.sdfs import MemberStore, SdfsClient, SdfsLeader, SdfsMember
from dmlc_tpu_torch.cluster.tenant import parse_tenants
from dmlc_tpu_torch.cluster.transport import UdpTransport
from dmlc_tpu_torch.scheduler.jobs import JobScheduler
from dmlc_tpu_torch.scheduler.worker import (
    DynamicBatcher,
    EngineBackend,
    ModelLoader,
    PredictWorker,
)
from dmlc_tpu_torch.utils import tracing
from dmlc_tpu_torch.utils.config import ClusterConfig
from dmlc_tpu_torch.utils.metrics import Counters, Registry, TenantLabelGuard
from dmlc_tpu_torch.utils.tracing import traced_methods

log = logging.getLogger(__name__)

#: Config switches that are on by default, with the module of the JAX package
#: each one drives. This package has none of them yet: the node runs without
#: them and names those that are on in one warning.
DEFAULT_ON_LEFT_OUT = {
    "placement_enabled": "dmlc_tpu/scheduler/placement.py",
    "critpath_enabled": "dmlc_tpu/cluster/critpath.py",
    "sentinel_enabled": "dmlc_tpu/cluster/sentinel.py",
    "profile_persist": "dmlc_tpu/cluster/profile.py",
    "devicemon_poll_interval_s": "dmlc_tpu/cluster/devicemon.py",
}


def member_rpc_addr(gossip_addr: str, port_offset: int) -> str:
    """Map a gossip identity to its member RPC address. The fleet shares one
    port layout (the reference's fixed 8850/8851/8852 scheme,
    membership.rs:64 + services.rs:31-32); here it's the *offset* that is
    fleet-wide, so several nodes can share a host in tests."""
    host, _, gport = gossip_addr.rpartition(":")
    return f"{host}:{int(gport) + port_offset}"


def _model_kind(name: str) -> str:
    """Registry kind for a job model ("image"/"lm"); unknown names fall back
    to "image" so a misconfigured job fails in the backend, with a real
    error, rather than here at wiring time."""
    try:
        from dmlc_tpu_torch.models.registry import get_model

        return get_model(name).kind
    except Exception:  # noqa: BLE001 - wiring must not die on a bad name
        return "image"


def refuse_unported(config: ClusterConfig) -> None:
    """Raise ``NotImplementedError`` for a switch that is off by default and
    turns on a module this package does not have yet, naming the module."""
    wanted = (
        (config.autoscaler_enabled, "autoscaler_enabled", "dmlc_tpu/scheduler/autoscaler.py"),
        (config.decode_tier_enabled, "decode_tier_enabled", "dmlc_tpu/cluster/decodetier.py"),
        (config.serve_from_executable, "serve_from_executable",
         "ExportedBackend in dmlc_tpu/scheduler/worker.py"),
        (config.mesh_processes > 1, "mesh_processes > 1", "dmlc_tpu/parallel/multihost.py"),
        (bool(config.slo_objectives), "slo_objectives",
         "SloEvaluator in dmlc_tpu/scheduler/placement.py"),
    )
    for on, switch, module in wanted:
        if on:
            raise NotImplementedError(f"{switch} needs {module}, which dmlc_tpu_torch has "
                                      f"not ported yet")
    for name in config.job_models:
        if _model_kind(name) == "lm":
            raise NotImplementedError(
                f"job model {name!r} is of kind 'lm' and needs LmBackend in "
                f"dmlc_tpu/scheduler/worker.py, which dmlc_tpu_torch has not ported yet")


def left_out_switches(config: ClusterConfig) -> list[str]:
    """The switches of ``DEFAULT_ON_LEFT_OUT`` that ``config`` has on."""
    return [name for name in DEFAULT_ON_LEFT_OUT if getattr(config, name)]


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

        refuse_unported(config)
        left_out = left_out_switches(config)
        if left_out:
            log.warning(
                "running without %s: dmlc_tpu_torch has not ported %s yet",
                ", ".join(left_out),
                ", ".join(DEFAULT_ON_LEFT_OUT[name] for name in left_out),
            )
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

        # ONE counter registry, ONE flight recorder, and ONE retry governor
        # per node, shared by every component: the CLI `status` verb and
        # leader.status read the same numbers the gates/breakers/scheduler
        # write. The gauge registry goes to the generation backends; the
        # scrape that exports it comes with the observability plane.
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
        # Head-based trace sampling: base rate + spans/s budget from config.
        # The tracer is process-global — co-hosted nodes (localcluster)
        # share one controller, exactly like they share one span buffer.
        tracing.tracer.set_sampling(
            rate=config.trace_sample_rate,
            spans_per_s=config.trace_spans_per_s_budget,
        )

        # --- L1 membership over UDP gossip -----------------------------
        self.gossip = UdpTransport(config.host, config.gossip_port, auth=self.auth)
        self.membership = MembershipNode(config, self.gossip, self.clock)

        # --- member services (SDFS store + inference worker) -----------
        self.store = MemberStore(Path(config.storage_dir), flight=self.flight)
        self.sdfs_member = SdfsMember(
            self.store,
            self.rpc,
            chunk_bytes=config.transfer_chunk_bytes,
            transfer_timeout_s=config.transfer_deadline_s,
            gate=self.transfer_gate,
        )
        if backends is None:
            backends = {
                name: EngineBackend(
                    name, config.data_dir, batch_size=config.batch_size, device=device
                )
                for name in config.job_models
            }
        self.worker = PredictWorker(backends, gate=self.predict_gate)
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
                    tenants=self.tenant_specs,
                    device=device,
                )
                for name in config.generate_models
            }
            self.generate_worker = GenerateWorker(
                self._gen_backends, session_ttl_s=config.gen_session_ttl_s,
                flight=self.flight,
            )
        self.model_loader = ModelLoader(
            self.store, self.worker.backends, extra=self._gen_backends
        )
        methods = traced_methods({
            **self.sdfs_member.methods(),
            **self.worker.methods(),
            **(self.generate_worker.methods() if self.generate_worker else {}),
            **self.model_loader.methods(),
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
            self.member_server.lane = self.lane

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
        # No profiler and no advisor: assignment is the reference's
        # round-robin split (scheduler/jobs.py assign_once).
        self.scheduler = JobScheduler(
            self.rpc,
            self.active_member_addrs,
            jobs={name: list(workload) for name in self.config.job_models},
            shard_size=self.config.dispatch_shard_size,
            shard_timeout_s=self.config.predict_deadline_s,
            member_weight=self._member_weight,
            hedge_tail=self.config.hedge_tail,
            retry_policy=self.retry_policy,
            gray_factor=self.config.gray_factor,
            gray_min_latency_s=self.config.gray_min_latency_s,
            gray_probe_interval_s=self.config.gray_probe_interval_s,
            metrics=self.metrics,
            flight=self.flight,
        )
        methods = {
            **self.sdfs_leader.methods(),
            **self.scheduler.methods(),
        }
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
        )

    # ---- topology ------------------------------------------------------

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
                    # Best-effort: the backend stays lazy and builds on the
                    # first shard instead.
                    log.exception("eager warmup failed; backend will build lazily")
        self._spawn(self._membership_loop)
        self._spawn(self._probe_loop)
        if self.config.scrub_interval_s > 0:
            self._spawn(self._scrub_loop)
        if self.is_candidate:
            self._spawn(self._heal_loop)
            self._spawn(self._assign_loop)
            for _ in range(max(1, self.config.dispatch_workers)):
                self._spawn(self._dispatch_loop)
            self._spawn(self._standby_loop)

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

    def stop(self) -> None:
        self._stop.set()
        for b in self._batchers:
            b.stop(timeout_s=2.0)
        for gb in self._gen_backends.values():
            gb.stop(timeout_s=2.0)
        for t in self._threads:
            t.join(timeout=2.0)
        self.member_server.close()
        if self.leader_server is not None:
            self.leader_server.close()
        self.gossip.close()
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

    def _if_leading(self, fn):
        if self.standby is not None and self.standby.is_leader:
            fn()

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

    def predict(self) -> dict:
        return self.rpc.call(
            self.tracker.current, "job.start", {}, timeout=self.config.rpc_deadline_s
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
            except Exception as e:
                out["cluster_error"] = str(e)
        return out
