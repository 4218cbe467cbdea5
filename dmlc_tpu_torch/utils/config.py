"""Cluster configuration.

Copied from ``dmlc_tpu/utils/config.py`` (the whole module).

The reference compiles every constant in: leader candidates
(src/services.rs:26-30), ports (src/membership.rs:64, src/services.rs:31-32),
storage dirs + ssh user (src/services.rs:34-36), replication factor 4
(src/services.rs:328,359), heartbeat 1 s / failure timeout 3 s
(src/membership.rs:230,273), maintenance loop periods 3 s
(src/services.rs:188,201,213,529), query interval 0.5 s (src/services.rs:408).

Here all of that is a config object loadable from JSON and overridable per
field, so fleet topology is data, not code. Defaults mirror the reference's
constants so behavior is comparable out of the box.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class ClusterConfig:
    # --- identity / topology ---
    host: str = "127.0.0.1"
    gossip_port: int = 8850          # reference: src/membership.rs:64
    leader_port: int = 8851          # reference: src/services.rs:31
    member_port: int = 8852          # reference: src/services.rs:32
    leader_candidates: list[str] = field(default_factory=list)  # was LEADER_HOSTNAMES, src/services.rs:26-30

    # --- membership / failure detection ---
    heartbeat_interval_s: float = 1.0   # src/membership.rs:230
    failure_timeout_s: float = 3.0      # src/membership.rs:273
    ring_k: int = 2                     # k=2 symmetric ring neighbors, src/membership.rs:242
    # Max membership entries per gossip datagram. The reference ships the
    # FULL list every ping (membership.rs:242-257), O(N) per heartbeat; a
    # bounded random sample (self always included) keeps datagrams under the
    # UDP limit at any fleet size while anti-entropy still converges.
    gossip_max_entries: int = 64
    # SWIM-style indirect probes: a neighbor silent past HALF the failure
    # timeout gets ping-req'd through this many other members, whose relayed
    # acks keep a node with a merely-lossy direct link from being falsely
    # FAILED. 0 restores the reference's direct-only detector.
    indirect_probes: int = 2

    # --- SDFS ---
    storage_dir: str = "storage"        # src/services.rs:34
    replication_factor: int = 4         # src/services.rs:328,359
    rereplication_interval_s: float = 3.0  # src/services.rs:188
    # Bulk-transfer frame size: blobs larger than this stream disk-to-disk
    # as bounded range-read RPCs (the reference streamed via scp from disk,
    # services.rs:244-262); every hop holds O(chunk) memory.
    transfer_chunk_bytes: int = 8 * 1024 * 1024
    # Concurrent replica copies per placement (reference: 10-way scp fanout,
    # services.rs:367-373).
    replicate_fanout: int = 4
    # Anti-entropy scrub: every node re-hashes its stored blobs against
    # their committed sha256 sidecars on this cadence, quarantining and
    # reporting rot so healing re-places from verified copies (docs/SDFS.md).
    # 0 disables the loop (sdfs.scrub / the CLI verb still work on demand).
    scrub_interval_s: float = 30.0
    # Blobs re-hashed per scrub pass (round-robin cursor): bounds the I/O a
    # single pass can burn on a store full of multi-GB checkpoints.
    scrub_batch: int = 4

    # --- scheduler ---
    assignment_interval_s: float = 3.0  # src/services.rs:201
    leader_probe_interval_s: float = 3.0  # src/services.rs:529
    # The reference throttles to 1 query / 0.5 s per job (src/services.rs:408).
    # TPU-native dispatch is shard-based; this is the *shard* size per dispatch.
    dispatch_shard_size: int = 64
    rpc_concurrency: int = 10           # src/main.rs:61,79
    # Dispatcher threads per leader: max shards in flight across all jobs
    # (the reference dispatched fire-and-forget, services.rs:418-421; here
    # in-flight work is bounded and tracked per shard offset).
    dispatch_workers: int = 8
    # Backup-request the oldest outstanding shard on a second member once
    # fresh work runs out (tail hedging; dedup makes it exactly-once).
    hedge_tail: bool = True

    # --- overload control (docs/OVERLOAD.md) ---
    # Per-class deadline defaults, propagated in every RPC frame and
    # inherited by nested calls (cluster/deadline.py). rpc: small control
    # verbs (directory lookups, status, job.start); predict: one shard's
    # batched forward (also the scheduler's shard timeout); transfer: a
    # whole-blob SDFS replicate/pull (many chunk RPCs under one budget).
    rpc_deadline_s: float = 60.0
    predict_deadline_s: float = 120.0
    transfer_deadline_s: float = 300.0
    # Admission control: per-member bounded work queues. Up to max_inflight
    # requests execute while max_queue more wait; past that the request is
    # shed IMMEDIATELY with a typed Overloaded reply + retry-after hint
    # instead of queuing toward a guaranteed timeout. 0 disables a gate.
    predict_max_inflight: int = 32
    predict_max_queue: int = 128
    transfer_max_inflight: int = 16
    transfer_max_queue: int = 64
    shed_retry_after_s: float = 0.25
    # Retry budgets + circuit breakers (cluster/retrypolicy.py), shared by
    # scheduler dispatch, SDFS pulls, failover probes, and the announce
    # loop: retries to one destination spend a token bucket (rate/burst),
    # and breaker_threshold consecutive unreachable/deadline/overloaded
    # failures open a per-peer breaker that admits one half-open probe per
    # cooldown window.
    retry_rate_per_s: float = 1.0
    retry_burst: float = 5.0
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 5.0
    # Gray-failure ejection (scheduler/jobs.py): a member whose EWMA shard
    # latency exceeds gray_factor x the fleet median (and the absolute
    # floor, so microsecond-scale jitter on a fast fleet never ejects
    # anyone), or whose breaker keeps reopening, is demoted to a quarantine
    # tier — no new shards, one canary shard per probe interval — and
    # restored automatically when its latency recovers. 0 disables.
    gray_factor: float = 3.0
    gray_min_latency_s: float = 0.25
    gray_probe_interval_s: float = 5.0
    # Tenant declarations (cluster/tenant.py, docs/OVERLOAD.md §Priority
    # classes): {name: {"priority": "high"|"low", "share": 0..1}}. Each
    # bounded surface (admission gates, microbatcher queue, generate slot
    # table) derives per-tenant token quotas as share x its capacity, and
    # shed/brownout/evict ordering is low-priority-and-over-quota first.
    # Empty = single-tenant fleet, no quota enforcement (requests without
    # a tenant ride as tenant "default" either way).
    tenants: dict = field(default_factory=dict)
    # Bound on distinct tenant labels the metrics plane will track
    # (utils/metrics.TenantLabelGuard): past this, per-tenant series fold
    # into tenant="other" and metrics_label_overflow counts the folds — a
    # tenant-id flood cannot OOM the registry or the scrape tree.
    metrics_max_tenants: int = 16

    # --- elastic autoscaler (scheduler/autoscaler.py) -------------------
    # Burn-rate-driven actuator on the leader: grows/shrinks decode-tier
    # fan-out, generate slot/page budgets, and per-model replica targets
    # from SLO burn + cost lanes + HBM headroom. Decisions are hysteretic
    # (scale up on fast burn, down only after a sustained clear), bounded
    # by a per-window moves budget, and every one is flight-recorded with
    # its trigger + signal values.
    autoscaler_enabled: bool = False
    # Consecutive clear evaluations required before any scale-down (the
    # down-hysteresis; scale-up reacts on the first fast-burn edge).
    autoscaler_clear_windows: int = 3
    # Max actuation moves per evaluate() call across all targets.
    autoscaler_moves_budget: int = 2
    # Seconds between autoscaler evaluations (rides the obs scrape loop;
    # 0 = every scrape cycle).
    autoscaler_interval_s: float = 0.0
    # Refuse scale-ups that would push device HBM usage above this
    # fraction of the limit (headroom guard; 0 disables the check).
    autoscaler_hbm_ceiling: float = 0.9
    # Replica bounds for per-model replica targets.
    autoscaler_min_replicas: int = 1
    autoscaler_max_replicas: int = 8

    # --- live cost profiles / SLO / placement (docs/OBSERVABILITY.md §5) ---
    # Rolling profile windows (cluster/profile.py): per-(model x member x
    # stage) cost lanes the leader folds dispatch latencies and fleet
    # scrapes into. window_s x windows bounds the history; decay weights
    # each window by decay**age in every query.
    profile_window_s: float = 30.0
    profile_windows: int = 16
    profile_decay: float = 0.7
    # Persist the profile (diskio.atomic_write, sibling of storage_dir) so
    # a restarted leader warm-starts placement instead of re-learning the
    # fleet from zero. False disables both save and load.
    profile_persist: bool = True
    # Per-model serving objectives (scheduler/placement.SloEvaluator):
    # {model: {"latency_s": shard dispatch latency bound,
    #          "availability": target fraction under it (default 0.99)}}.
    # Empty = no SLO evaluation.
    slo_objectives: dict = field(default_factory=dict)
    # Multi-window burn-rate alerting: burn = frac-over-objective / error
    # budget. The fast window catches cliffs (pages in minutes), the slow
    # window catches smolder; thresholds follow the SRE-workbook shape.
    slo_fast_window_s: float = 300.0
    slo_slow_window_s: float = 3600.0
    slo_fast_burn: float = 14.0
    slo_slow_burn: float = 2.0
    # Profile-driven placement (scheduler/placement.PlacementAdvisor):
    # greedy cost-balanced assignment consulted by every assign pass, with
    # outlier exclusion past exclude_factor x the fleet median cost, a
    # relative-improvement hysteresis, and a bounded number of member
    # moves per window (rebalancing is itself a disturbance). False keeps
    # the round-robin assignment.
    placement_enabled: bool = True
    placement_max_moves: int = 2
    placement_window_s: float = 60.0
    placement_hysteresis: float = 0.15
    placement_exclude_factor: float = 3.0
    # Fleet-trace clock alignment decay alarm (cluster/observe.py): when
    # child-before-parent clamping in a merged trace exceeds this residual
    # skew on any node, a flight event fires (0 disables the alarm).
    trace_skew_alert_s: float = 0.05

    # --- fleet-scale observability (docs/OBSERVABILITY.md §6-7) ---------
    # Per-member scrape deadline + leader/delegate concurrency pool: one
    # wedged member costs one pool slot for one timeout, never the cycle.
    scrape_timeout_s: float = 2.0
    scrape_concurrency: int = 8
    # Delegated scrape tree (cluster/scrapetree.py): past min_members the
    # leader partitions the ring into spans of scrape_span_size members
    # (0 = ceil(sqrt(N))) and folds delegate partials — ~O(sqrt(N)) leader
    # RPCs per cycle instead of O(N). Below the threshold the direct
    # concurrent scrape is simpler and just as cheap.
    scrape_tree_enabled: bool = True
    scrape_tree_min_members: int = 16
    scrape_span_size: int = 0
    # Head-based trace sampling (utils/tracing): probability a fresh root
    # trace is kept (the bit rides the `t` frame field fleet-wide), and an
    # optional spans/s storage budget the adaptive controller steers the
    # effective rate toward (0 = controller off). Error/deadline-exceeded
    # spans are always recorded regardless of the rate.
    trace_sample_rate: float = 1.0
    trace_spans_per_s_budget: float = 0.0
    # On an SLO fast-burn edge, force-sample every trace fleet-wide for
    # this window (seconds; 0 disables) — burn investigations need whole
    # traces, not a 1% lottery.
    trace_burn_force_sample_s: float = 0.0

    # --- root-cause plane (cluster/critpath.py + sentinel.py, §9) -------
    # Per-request critical-path attribution: every node drains its sampled
    # span DAGs into per-(model, stage, member) critical-path seconds on
    # the scrape cadence; the leader folds the fleet table, names burn
    # culprits, and feeds the drift sentinel.
    critpath_enabled: bool = True
    # Rolling aggregation: windows of critpath_window_s seconds, the last
    # critpath_windows kept, older windows decayed by critpath_decay**age.
    critpath_window_s: float = 30.0
    critpath_windows: int = 16
    critpath_decay: float = 0.7
    # Latency drift sentinel (leader-side, scrape cadence): alert when a
    # lane's recent qNN self-time exceeds drift_factor x its decay-learned
    # baseline for confirm_windows consecutive ticks (clears below
    # clear_factor after the same streak); lanes with fewer than
    # min_samples recent requests are never judged.
    sentinel_enabled: bool = True
    sentinel_quantile: float = 90.0
    sentinel_drift_factor: float = 2.0
    sentinel_clear_factor: float = 1.3
    sentinel_min_samples: int = 20
    sentinel_confirm_windows: int = 3
    sentinel_baseline_decay: float = 0.8
    # On a drift alert, force-sample every trace fleet-wide this long
    # (seconds; 0 disables) so the drift window is densely traced.
    sentinel_force_sample_s: float = 30.0

    # --- device-plane telemetry (cluster/devicemon.py, OBSERVABILITY §8) ---
    # HBM watermark/alert poll cadence (0 disables the poll loop; gauges
    # still read live on every scrape).
    devicemon_poll_interval_s: float = 5.0
    # Compile-census warmup window: a program label compiling again this
    # long after its FIRST compile is a steady-state recompile (flight
    # event `recompile_steady_state` — runtime counterpart of rule A6).
    devicemon_warmup_s: float = 60.0
    # hbm_high_watermark flight event fires when bytes_in_use crosses this
    # fraction of bytes_limit (re-arms below 0.9x the line).
    devicemon_hbm_alert_fraction: float = 0.9
    # Per-chip peak FLOP/s override for MFU (0 = the per-platform table in
    # devicemon.PEAK_FLOPS: v5e bf16 for tpu, nominal 1 TF for cpu).
    devicemon_peak_flops: float = 0.0

    # --- dynamic request micro-batching (scheduler/worker.DynamicBatcher) ---
    # Coalesce concurrent small `job.predict` requests into device-shaped
    # batches: a request waits at most this long for peers before its batch
    # dispatches (batch fills dispatch immediately). 0 disables — each RPC
    # keeps its own engine call, the pre-batcher behavior. Gang (collective)
    # shards always bypass the batcher.
    microbatch_wait_s: float = 0.0

    # --- inference engine ---
    # Chips on this host, for the leader's capacity-weighted shard
    # placement (north star: "per-host chip topology ... ICI-local
    # placement"). 0 = autodetect from jax when it is already loaded.
    chips_per_host: int = 0
    batch_size: int = 256
    model_dtype: str = "bfloat16"
    data_dir: str = "test_files/imagenet_1k/train"
    synset_path: str = "synset_words.txt"
    # Resolve class images through SDFS (published via
    # scheduler/dataset.publish_corpus) instead of a pre-installed local
    # corpus — the BASELINE "4-node SDFS shard" configuration.
    data_from_sdfs: bool = False
    # The reference's two static jobs (src/services.rs:168-169); any registry
    # model name works here. kind="lm" registry entries (lm_small, lm_wide)
    # serve through the gang-aware LmBackend (docs/SHARDING.md).
    job_models: list[str] = field(default_factory=lambda: ["resnet18", "alexnet"])
    # --- gang-sharded LM serving (parallel/sharding.py, docs/SHARDING.md) -
    # lm_gang_devices pins the tensor/data mesh width an LM job uses
    # when dispatched as a gang (0 = the advisor-planned gang world size).
    # lm_hbm_budget_bytes is the per-chip resident budget the solo path
    # enforces: an LM whose replicated weights exceed it refuses solo
    # service with a typed error, steering the PlacementAdvisor toward a
    # gang (0 = no budget, solo always allowed). lm_prompt_len bounds the
    # synthetic prompt length encoded per query id.
    lm_gang_devices: int = 0
    lm_prompt_len: int = 16
    lm_hbm_budget_bytes: int = 0
    # Compile engines at node startup, before membership begins (the
    # reference's eager model load, src/services.rs:513-524). Lazy loading
    # risks compile-time GIL holds starving the heartbeat threads.
    eager_load: bool = True
    # Serve shards from the SDFS-distributed StableHLO artifact
    # (executables/<model>, published with the `export` verb) instead of
    # building the model from source — the native-serving deployment shape
    # (models/export.py): members need only the artifact + weights blobs.
    serve_from_executable: bool = False
    # --- fleet decode tier (cluster/decodetier.py, docs/INGEST.md) ---
    # Ship raw JPEG bytes to peers' job.decode verbs so ingest decode
    # scales with membership instead of capping at one host's cores.
    # min_batch: batches below this many images decode locally (the RPC
    # round-trip would cost more than the decode). max_bytes_per_rpc:
    # per-chunk wire bound — one oversized batch must never wedge a
    # control frame.
    decode_tier_enabled: bool = False
    decode_tier_min_batch: int = 16
    decode_tier_max_bytes_per_rpc: int = 4 * 1024 * 1024

    # --- generation serving (dmlc_tpu/generate/, docs/GENERATE.md) ---
    # Registry LMs (kind="lm", e.g. "lm_small") this node serves through
    # the continuous-batching generation worker. Empty = no generation
    # surface (the default; image-only nodes pay nothing).
    generate_models: list[str] = field(default_factory=list)
    # Slot table size: the decode step's FIXED batch shape — requests join/
    # leave between steps, the compiled program never reshapes.
    gen_max_slots: int = 8
    # Paged KV cache geometry: tokens per page, pages in the pool (page 0
    # is reserved scratch), and the padded prefill length (prompts longer
    # than gen_max_prefill are refused).
    gen_page_size: int = 16
    gen_num_pages: int = 128
    gen_max_prefill: int = 64
    # Requests allowed to WAIT for a slot beyond the table itself before
    # submits shed with a typed Overloaded (0 = shed at a full table).
    gen_max_waiting: int = 8
    # Streamed-chunk retention for a client that stopped polling.
    gen_session_ttl_s: float = 120.0
    # Leader-routed sessions (scheduler/genrouter.py): ledger capacity and
    # the default drain deadline — residents of a draining member get this
    # long to finish before the tick loop migrates them.
    gen_router_max_sessions: int = 256
    gen_drain_deadline_s: float = 30.0

    # --- control-plane authentication (cluster/auth.py) ---
    # Shared fleet key: every RPC frame and gossip datagram carries an
    # HMAC-SHA256 tag, and unauthenticated frames are dropped — reaching a
    # port no longer grants sdfs.delete / job.start (the reference leaned on
    # fleet ssh trust instead, services.rs:244-272). "" disables.
    auth_key: str = ""

    # --- multi-host global device mesh (parallel/multihost.py) ---
    # >1 enables leader-coordinated jax.distributed bootstrap: members call
    # node.join_global_mesh() and the process fleet forms ONE device mesh
    # spanning hosts (collectives ride ICI/DCN). 1 = single-process meshes.
    mesh_processes: int = 1
    mesh_coordinator_port: int = 8853

    def with_updates(self, **kw) -> "ClusterConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_json(cls, path: str | Path) -> "ClusterConfig":
        raw = json.loads(Path(path).read_text())
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - names
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**raw)

    def to_json(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(dataclasses.asdict(self), indent=2))
