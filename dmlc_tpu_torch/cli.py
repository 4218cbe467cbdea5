"""Interactive CLI / REPL over a node of this package.

Ported from ``dmlc_tpu/cli.py``: the verbs whose node parts this package
has answer as the JAX package's do — membership (list_mem/lm, list_self,
join/j, leave/l), SDFS (put/p, get/g, get-versions/gv, delete/d, ls,
store/s, scrub), ML (train/t, predict, jobs, assign), generation
(generate, sessions, drain, undrain), mesh-join, export, export-bundle,
status, metrics (show, prom, fleet), flight, trace (on/off, summary, export,
fleet), profile, slo, critpath, tenants, device, help and exit. ``jobs``
prints accuracy and latency percentiles (mean/std/median/p90/p95/p99) like
the reference's histogram report (main.rs:282-309). ``export`` publishes
the ``torch.export`` serving program (``models/export.py``) and
``export-bundle`` writes the native host's AOTInductor bundle
(``models/aoti_bundle.py``). A verb of the JAX package's CLI whose node
part this package lacks would answer with an error that names the module
it waits for (``WAITING``, empty now). Logs go to ``{HOSTNAME}.log``
(main.rs:27-28).

Run: ``python -m dmlc_tpu_torch.cli --config cluster.json [--device cuda]``
(or with no config for a single-node local cluster). The node's engines run
on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import shlex
import socket

from dmlc_tpu_torch.cluster.rpc import RpcError
from dmlc_tpu_torch.utils.config import ClusterConfig

#: Verbs of the JAX package's CLI whose node parts this package has not
#: ported yet, with the module each one waits for: none.
WAITING: dict[str, str] = {}


def format_table(headers: list[str], rows: list[list]) -> str:
    """Plain aligned-column table (the reference used the `tabled` crate)."""
    cells = [[str(c) for c in row] for row in rows]
    widths = [
        max(len(h), *(len(r[i]) for r in cells)) if cells else len(h)
        for i, h in enumerate(headers)
    ]
    def line(row):
        return " | ".join(c.ljust(w) for c, w in zip(row, widths))
    sep = "-+-".join("-" * w for w in widths)
    return "\n".join([line(headers), sep, *(line(r) for r in cells)])


def _fmt_bytes(v) -> str:
    """Human-scaled byte count for the device table ('-' for unknown)."""
    if v is None:
        return "-"
    v = float(v)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024.0 or unit == "GiB":
            return f"{v:.1f}{unit}" if unit != "B" else f"{v:.0f}B"
        v /= 1024.0
    return f"{v:.1f}GiB"


def format_latency(summary: dict[str, float]) -> str:
    ms = lambda k: f"{summary[k] * 1e3:.2f}ms" if summary.get("count") else "-"
    return (
        f"n={int(summary.get('count', 0))} mean={ms('mean')} std={ms('std')} "
        f"median={ms('median')} p90={ms('p90')} p95={ms('p95')} p99={ms('p99')}"
    )


def _fmt_decision(d: dict) -> str:
    """One autoscale decision on one line (status / tenants verbs)."""
    move = (
        f"{d.get('from_')}->{d.get('to')}"
        if d.get("direction") in ("up", "down")
        else f"at {d.get('at')} ({d.get('reason')})"
    )
    burn = d.get("burn")
    extra = f" burn={burn:.1f}x" if isinstance(burn, (int, float)) else ""
    return (
        f"{d.get('direction')} {d.get('target')} {move} "
        f"[{d.get('trigger')}]{extra}"
    )


def waiting_error(verb: str, module: str) -> str:
    """The answer of a verb whose node part is not ported yet."""
    return f"error: {verb!r} waits for {module}, which dmlc_tpu_torch has not ported yet"


def pop_option(args: list[str], name: str, cast=str):
    """Extract ``--name value`` from a REPL token list (mutates ``args``);
    None when absent, ValueError on a missing or uncastable value."""
    if name not in args:
        return None
    i = args.index(name)
    if i + 1 >= len(args):
        raise ValueError(f"{name} needs a value")
    try:
        value = cast(args[i + 1])
    except (TypeError, ValueError):
        raise ValueError(f"{name} got a bad value {args[i + 1]!r}") from None
    del args[i:i + 2]
    return value


HELP = """\
Commands (reference: README.md:10-23):
  list_mem | lm                         list active members
  list_self                             print this node's id
  join | j <host:gossip_port>           join the cluster via an introducer
  leave | l                             leave the cluster
  put | p <local_path> <sdfs_name>      store a file (new version)
  get | g <sdfs_name> <local_path>      fetch latest version
  get-versions | gv <name> <n> <local>  fetch last n versions, merged
  delete | d <sdfs_name>                delete all versions
  ls [<sdfs_name>]                      where files live (leader directory)
  store | s                             files stored on this node
  scrub                                 verify this node's blobs against their
                                        sha256 sidecars (rot -> quarantine + heal)
  train | t                             broadcast model weights to members
  predict                               start/resume the inference jobs
  generate <model> <tok> [<tok> ...]    stream an LM generation (token ids;
                                        flags: --max-new N --temp T --seed S);
                                        routed through the leader's session
                                        router when available — the stream
                                        survives member death and drain
  sessions                              leader's generation-session ledger:
                                        id, model, member, tenant, tokens
                                        delivered, state, migrations
  drain <member> [--deadline S]         stop admitting generation sessions to
                                        a member; residents finish within the
                                        deadline or migrate
  undrain <member>                      reopen a drained member for admission
  jobs                                  job status, accuracy, latency percentiles
  mesh-join                             join the fleet-wide torch.distributed mesh
  export <model>                        publish the model's torch.export program
  export-bundle <model> <dir>           write the native AOTInductor host bundle
  assign                                per-job member assignment table
  status                                overload-control counters: sheds,
                                        deadline trips, queue high-water,
                                        breakers, gray-demoted members,
                                        per-tenant gate occupancy + quota
                                        debt, autoscaler last decision
  metrics [prom|fleet]                  this node's metric registry (counters,
                                        gauges, latency summaries); `prom` =
                                        Prometheus text; `fleet` = the leader's
                                        latest per-member scrape + tree-merged
                                        totals incl. per-gate quota sheds
                                        (flags: --top K busiest nodes,
                                        --worst K most error-laden nodes)
  trace on|off|summary|export <path>    span tracing: toggle FLEET-WIDE,
                                        aggregate table, local Chrome trace
  trace fleet <path>                    merged fleet trace: every node's spans,
                                        clock-aligned, one pid lane per node
  flight [member]                       flight-recorder event ring (breaker /
                                        gray / quarantine / shed transitions)
  profile [member]                      live cost-profile lanes (model x
                                        member x stage: n/mean/p50/p99/qps);
                                        the leader's holds the whole fleet
                                        (flags: --model M, --top K busiest
                                        lanes, --worst K slowest-p99 lanes)
  slo                                   per-model SLO burn rates, each lane's
                                        critical-path culprit, + the current
                                        placement plan (leader's evaluator)
  critpath [model] [--top K]            fleet critical-path attribution
                                        (leader's fold): per model the
                                        (stage x member) lanes ranked by
                                        charged seconds, share of the
                                        model's critical-path time,
                                        p50/p99 self-time, and the drift
                                        sentinel's verdict per lane
  tenants                               tenant table: declared priorities and
                                        shares, per-gate occupancy/quota/debt,
                                        per-tenant burn lanes (leader's
                                        evaluator), autoscaler decision ring
  device                                device-plane fleet table (devicemon):
                                        HBM used/limit, kernel builds
                                        (compiles) + build seconds,
                                        steady-state rebuilds, per-model MFU
  help                                  this text
  exit | quit                           leave and stop the node
""" + ("Not ported yet, each answering with the module it waits for:\n  "
       + ", ".join(sorted(WAITING)) + "\n" if WAITING else "")


class Cli:
    """Command dispatcher over a running ClusterNode. Returns output strings
    so tests can drive it without capturing stdout."""

    def __init__(self, node):
        self.node = node

    def run_command(self, line: str) -> str:
        try:
            parts = shlex.split(line)
        except ValueError as e:
            return f"parse error: {e}"
        if not parts:
            return ""
        cmd, *args = parts
        try:
            return self._dispatch(cmd, args)
        except EOFError:
            raise  # exit/quit propagates to the REPL
        except Exception as e:  # RPC errors, bad paths — report, don't crash
            return f"error: {type(e).__name__}: {e}"

    def _dispatch(self, cmd: str, args: list[str]) -> str:
        n = self.node
        if cmd in WAITING:
            return waiting_error(cmd, WAITING[cmd])
        if cmd in ("list_mem", "lm"):
            rows = [
                [addr, f"{inc:.3f}", m.status.value]
                for (addr, inc), m in n.membership.list_membership()
                if m.status.value == "active"
            ]
            return format_table(["address", "incarnation", "status"], rows)
        if cmd == "list_self":
            addr, inc = n.membership.self_id
            return f"{addr} (incarnation {inc:.3f})"
        if cmd in ("join", "j"):
            if len(args) != 1:
                return "usage: join <host:gossip_port>"
            n.join(args[0])
            return f"join sent to {args[0]}"
        if cmd in ("leave", "l"):
            n.leave()
            return "left the cluster"
        if cmd in ("put", "p"):
            if len(args) != 2:
                return "usage: put <local_path> <sdfs_name>"
            reply = n.sdfs.put(args[0], args[1])
            return format_table(
                ["name", "version", "replicas"],
                [[args[1], reply["version"], ", ".join(reply["replicas"])]],
            )
        if cmd in ("get", "g"):
            if len(args) != 2:
                return "usage: get <sdfs_name> <local_path>"
            version = n.sdfs.get(args[0], args[1])
            return f"fetched {args[0]} v{version} -> {args[1]}"
        if cmd in ("get-versions", "gv"):
            if len(args) != 3:
                return "usage: get-versions <sdfs_name> <n> <local_path>"
            versions = n.sdfs.get_versions(args[0], int(args[1]), args[2])
            return f"fetched versions {versions} of {args[0]} -> {args[2]}"
        if cmd in ("delete", "d"):
            if len(args) != 1:
                return "usage: delete <sdfs_name>"
            reply = n.sdfs.delete(args[0])
            return f"deleted from: {', '.join(reply['deleted_from']) or '(nowhere)'}"
        if cmd == "ls":
            files = n.sdfs.ls(args[0] if args else None)
            rows = [
                [name, member, ", ".join(f"v{v}" for v in sorted(vs))]
                for name, members in sorted(files.items())
                for member, vs in sorted(members.items())
            ]
            return format_table(["name", "member", "versions"], rows)
        if cmd in ("store", "s"):
            rows = [
                [name, ", ".join(f"v{v}" for v in vs)]
                for name, vs in sorted(n.store.listing().items())
            ]
            return format_table(["name", "versions"], rows)
        if cmd == "scrub":
            report = n.scrub()
            if report["corrupt"]:
                bad = ", ".join(f"{name} v{v}" for name, v in report["corrupt"])
                return (
                    f"scrubbed {report['scanned']} blob(s); QUARANTINED {bad} "
                    "(reported to leader for re-replication)"
                )
            return f"scrubbed {report['scanned']} blob(s); all digests verified"
        if cmd in ("train", "t"):
            results = n.train()
            rows = [
                [name, len(r["pulled"]), len(r["loaded"])]
                for name, r in sorted(results.items())
            ]
            return format_table(["weights file", "members pulled", "engines loaded"], rows)
        if cmd == "predict":
            reply = n.predict()
            return f"started jobs: {', '.join(reply['jobs'])}"
        if cmd == "generate":
            max_new, temp, seed, rest = 32, 0.0, None, []
            it = iter(args)
            for a in it:
                if a == "--max-new":
                    max_new = int(next(it, "32"))
                elif a == "--temp":
                    temp = float(next(it, "0"))
                elif a == "--seed":
                    seed = int(next(it, "0"))
                else:
                    rest.append(a)
            if len(rest) < 2:
                return ("usage: generate <model> <tok> [<tok> ...] "
                        "[--max-new N] [--temp T] [--seed S]")
            model, prompt = rest[0], [int(t) for t in rest[1:]]
            reply = n.generate(
                model, prompt, max_new_tokens=max_new, temperature=temp,
                seed=seed,
            )
            toks = reply["tokens"]
            via = "router" if reply.get("routed") else "direct"
            return (
                f"{model} @ {reply['member']} ({via}): {len(toks)} token(s)\n"
                "  " + " ".join(str(t) for t in toks)
            )
        if cmd == "sessions":
            try:
                rows = [
                    [s["id"], s["model"], s["member"], s["tenant"],
                     s["delivered"], s["state"], s["migrations"]]
                    for s in n.gen_sessions()
                ]
            except RpcError as e:
                return f"session ledger unavailable: {e}"
            if not rows:
                return "no generation sessions"
            return format_table(
                ["session", "model", "member", "tenant", "delivered",
                 "state", "migrations"],
                rows,
            )
        if cmd == "drain":
            opts = list(args)
            try:
                deadline = pop_option(opts, "--deadline", float)
            except ValueError as e:
                return str(e)
            if len(opts) != 1:
                return "usage: drain <member_addr> [--deadline S]"
            r = n.drain(opts[0], deadline_s=deadline)
            return (
                f"draining {r['member']}: {r['resident']} resident "
                f"session(s), deadline {r['deadline_s']:.1f}s "
                "(residents finish or migrate; admission stopped)"
            )
        if cmd == "undrain":
            if len(args) != 1:
                return "usage: undrain <member_addr>"
            r = n.undrain(args[0])
            return (
                f"{r['member']}: admission reopened"
                if r.get("was") else f"{r['member']}: was not draining"
            )
        if cmd == "mesh-join":
            info = n.join_global_mesh()
            return (
                f"joined global mesh: process {info['process_id']}"
                f"/{info['num_processes']}, coordinator {info['coordinator']}"
            )
        if cmd == "export":
            if len(args) != 1:
                return "usage: export <model_name>"
            from dmlc_tpu_torch.models import export as export_lib

            v = export_lib.publish_executable(
                n.sdfs, args[0], batch_size=n.config.batch_size,
                device=getattr(n, "device", None),
            )
            return f"exported {args[0]} -> {export_lib.sdfs_executable_name(args[0])} v{v}"
        if cmd == "export-bundle":
            if len(args) != 2:
                return "usage: export-bundle <model_name> <out_dir>"
            from pathlib import Path

            from dmlc_tpu_torch.models import weights as weights_lib
            from dmlc_tpu_torch.models.aoti_bundle import export_bundle
            from dmlc_tpu_torch.ops import _build_host

            # Bundle the cluster's PUBLISHED weights when they exist (the
            # same blob the Python serving path trains/hot-swaps from);
            # random init only for clusters that never published any.
            variables, source = None, "random-init (no published weights)"
            blob = None
            sdfs = getattr(n, "sdfs", None)  # standalone/tool contexts: no cluster
            if sdfs is not None:
                try:
                    _, blob = sdfs.get_bytes(weights_lib.sdfs_weights_name(args[0]))
                except RpcError as e:
                    # Only NOT-FOUND means "never published"; a corrupt
                    # blob, wrong-model magic, or transient replica failure
                    # must surface, not silently bundle random weights
                    # under a false label (same consent rule as
                    # ExportedBackend).
                    if not weights_lib.not_published(e):
                        raise
            if blob is not None:
                _, variables = weights_lib.weights_from_bytes(blob, expect_model=args[0])
                source = "published SDFS weights"
            info = export_bundle(
                args[0], n.config.batch_size, Path(args[1]), variables=variables,
                device=getattr(n, "device", None),
            )
            host = _build_host.HOST_PATH
            return (
                f"bundle for {info['model']} (batch {info['batch']}, "
                f"{info['weight_args']} weight files, {source}) -> {args[1]}; "
                f"serve with: {host} serve {args[1]} --dir <jpegs> "
                f"(or one-shot: aoti_host run {args[1]})"
            )
        if cmd == "jobs":
            out = []
            for name, r in sorted(n.jobs_report().items()):
                qps = r.get("throughput_qps", 0.0)
                out.append(
                    f"{name}: {'RUNNING' if r['running'] else 'idle'} "
                    f"{r['finished']}/{r['total']} finished, "
                    f"accuracy {r['accuracy'] * 100:.2f}% "
                    f"({r['correct']}/{r['finished'] or 1})"
                    + (f", {qps:.1f} queries/s" if qps else "")
                )
                out.append(f"  query latency: {format_latency(r['query_latency'])}")
                out.append(f"  shard latency: {format_latency(r['shard_latency'])}")
                for m, s in sorted(r.get("member_latency", {}).items()):
                    out.append(f"    {m}: {format_latency(s)}")
            return "\n".join(out) or "no jobs"
        if cmd == "assign":
            rows = [
                [job, len(members), ", ".join(members)]
                for job, members in sorted(n.assignments().items())
            ]
            return format_table(["job", "#members", "members"], rows)
        if cmd == "status":
            s = n.status()
            out = [f"node {s['member']}  (believed leader: {s['leader']})"]
            counters = {k: v for k, v in sorted(s["counters"].items()) if v}
            out.append(
                "  counters: "
                + (", ".join(f"{k}={v}" for k, v in counters.items()) or "(all zero)")
            )
            for gate, g in sorted(s["gates"].items()):
                out.append(
                    f"  {gate} gate: active={g['active']} admitted={g['admitted']} "
                    f"shed={g['sheds']} queue_hw={g['queue_hw']} "
                    f"(max_inflight={g['max_inflight']}, max_queue={g['max_queue']})"
                )
                for tname, t in sorted((g.get("tenants") or {}).items()):
                    out.append(
                        f"    tenant {tname}: {t['active']}/{t['quota']} "
                        f"slots, debt={t['debt']}, priority={t['priority']}, "
                        f"over_quota_sheds={t['over_quota_sheds']}"
                    )
            for name, b in sorted(s.get("microbatch", {}).items()):
                out.append(
                    f"  microbatch[{name}]: requests={b['requests']} "
                    f"dispatches={b['dispatches']} shed={b['sheds']} "
                    f"queue_hw={b['queue_hw']}"
                )
            for dest, br in sorted(s.get("breakers", {}).items()):
                out.append(
                    f"  breaker {dest}: {br['state']} (opens={br['opens']}, "
                    f"consec_failures={br['consec']})"
                )
            auto = s.get("autoscaler")
            if auto:
                targets = ", ".join(
                    f"{name}={t['current']}"
                    for name, t in sorted(auto.get("targets", {}).items())
                )
                last = auto.get("last_decision")
                out.append(
                    f"  autoscaler: {targets or '(no targets)'}; last: "
                    + (_fmt_decision(last) if last else "(no decisions yet)")
                )
            cluster = s.get("cluster")
            if cluster:
                ctrs = {k: v for k, v in sorted(cluster.get("counters", {}).items()) if v}
                out.append(
                    "  leader counters: "
                    + (", ".join(f"{k}={v}" for k, v in ctrs.items()) or "(all zero)")
                )
                demoted = cluster.get("demoted", [])
                out.append(
                    "  gray-demoted: " + (", ".join(demoted) if demoted else "(none)")
                )
                for m, h in sorted(cluster.get("member_health", {}).items()):
                    ewma = h.get("ewma_s")
                    out.append(
                        f"    {m}: ewma={ewma * 1e3:.1f}ms"
                        + (f" DEMOTED ({h['reason']})" if h.get("demoted") else "")
                        if ewma is not None
                        else f"    {m}: DEMOTED ({h['reason']})"
                    )
            gen = s.get("cluster_generate")
            if gen:
                out.append(
                    f"  generation sessions: {gen.get('sessions', 0)} live"
                    f" / {gen.get('total', 0)} ledgered"
                )
                for m, d in sorted((gen.get("drains") or {}).items()):
                    out.append(
                        f"    drain {m}: "
                        + ("COMPLETE" if d.get("complete") else "draining")
                        + f" (deadline {d.get('deadline_s', 0):.1f}s,"
                        f" age {d.get('age_s', 0):.1f}s,"
                        f" reason {d.get('reason', '?')})"
                    )
            if s.get("cluster_error"):
                out.append(f"  leader unreachable: {s['cluster_error']}")
            return "\n".join(out)
        if cmd == "metrics":
            sub = args[0] if args else "show"
            if sub == "prom":
                return n.registry.prometheus_text() or "(no metrics yet)"
            if sub == "fleet":
                opts = list(args[1:])
                try:
                    top = pop_option(opts, "--top", int)
                    worst = pop_option(opts, "--worst", int)
                except ValueError as e:
                    return str(e)
                if opts:
                    return "usage: metrics fleet [--top K] [--worst K]"
                try:
                    reply = n.rpc.call(
                        n.tracker.current, "obs.fleet", {}, timeout=5.0
                    )
                except Exception as e:
                    return f"leader fleet scrape unavailable: {e}"
                fleet = reply.get("fleet") or {}
                if not fleet:
                    return "no fleet scrape yet (leader scrapes on the probe cadence)"

                # Error-shaped counters rank "worst"; total counter movement
                # ranks "top" (the busiest nodes).
                bad_keys = ("shed", "deadline_exceeded", "evicted",
                            "breaker_open", "scrape_timeouts", "errors")

                def activity(counters: dict) -> int:
                    return sum(
                        int(v or 0) for k, v in counters.items()
                        if not k.endswith("_high")
                    )

                def badness(counters: dict) -> int:
                    return sum(int(counters.get(k) or 0) for k in bad_keys)

                entries = [
                    (addr, (r.get("metrics") or {}).get("counters") or {})
                    for addr, r in sorted(fleet.items())
                ]
                if worst is not None:
                    entries.sort(key=lambda e: (-badness(e[1]), e[0]))
                    entries = entries[:worst]
                elif top is not None:
                    entries.sort(key=lambda e: (-activity(e[1]), e[0]))
                    entries = entries[:top]
                rows = []
                for addr, counters in entries:
                    nonzero = {k: v for k, v in sorted(counters.items()) if v}
                    rows.append([
                        addr,
                        ", ".join(f"{k}={v}" for k, v in nonzero.items()) or "(all zero)",
                    ])
                out = format_table(["node", "counters"], rows)
                merged = (reply.get("merged") or {}).get("counters") or {}
                if merged:
                    totals = ", ".join(
                        f"{k}={v}" for k, v in sorted(merged.items())
                        if v and not k.endswith("_high")
                    )
                    out += f"\nfleet totals (tree-merged): {totals or '(all zero)'}"
                    quota = {
                        k[len("shed_over_quota_"):]: v
                        for k, v in sorted(merged.items())
                        if k.startswith("shed_over_quota_") and v
                    }
                    if quota:
                        out += (
                            "\nquota sheds (typed over_quota, by gate): "
                            + ", ".join(f"{k}={v}" for k, v in quota.items())
                        )
                stale = reply.get("stale") or []
                if stale:
                    out += (
                        f"\nWARNING: {len(stale)} member(s) in STALE scrape "
                        f"spans (delegates dark): {', '.join(stale)}"
                    )
                return out
            if sub == "show":
                snap = n.registry.snapshot()
                out = []
                counters = {k: v for k, v in sorted(snap["counters"].items()) if v}
                out.append(
                    "counters: "
                    + (", ".join(f"{k}={v}" for k, v in counters.items()) or "(all zero)")
                )
                gauges = {k: v for k, v in sorted(snap["gauges"].items()) if v is not None}
                out.append(
                    "gauges:   "
                    + (", ".join(f"{k}={v:g}" for k, v in gauges.items()) or "(none)")
                )
                for name, s in sorted(snap["latency"].items()):
                    out.append(f"  {name}: {format_latency(s)}")
                return "\n".join(out)
            return "usage: metrics [prom|fleet]"
        if cmd == "flight":
            if args:
                wire = n.rpc.call(args[0], "obs.flight", {}, timeout=5.0)
            else:
                wire = n.flight.to_wire()
            events = wire.get("events", [])
            head = (
                f"flight ring: {len(events)} event(s) held, "
                f"{wire.get('recorded', 0)} recorded, "
                f"{wire.get('dropped', 0)} aged out"
            )
            lines = [head]
            for e in events[-50:]:
                fields = ", ".join(
                    f"{k}={v}" for k, v in sorted(e.items()) if k not in ("t", "kind")
                )
                lines.append(f"  t={e.get('t', 0):.3f} {e.get('kind')} {fields}")
            return "\n".join(lines)
        if cmd == "trace":
            from dmlc_tpu_torch.cluster import observe
            from dmlc_tpu_torch.utils.tracing import tracer

            sub = args[0] if args else "summary"
            if sub in ("on", "off", "start", "stop"):
                enable = sub in ("on", "start")
                tracer.enabled = enable
                # Arm/disarm the whole fleet (best-effort): spans only merge
                # into one timeline if every node records them.
                reached = observe.set_fleet_tracing(
                    n.rpc,
                    [a for a in n.active_member_addrs() if a != n.self_member_addr],
                    enable,
                )
                ok = sum(1 for v in reached.values() if v)
                verb = "enabled" if enable else "disabled"
                return f"tracing {verb} (fleet: {ok}/{len(reached)} peers reached)"
            if sub == "export":
                if len(args) != 2:
                    return "usage: trace export <path>"
                tracer.export(args[1])
                return f"wrote Chrome trace to {args[1]} (open in chrome://tracing)"
            if sub == "fleet":
                if len(args) != 2:
                    return "usage: trace fleet <path>"
                doc = n.export_fleet_trace(args[1])
                lanes = {e.get("pid") for e in doc["traceEvents"] if e.get("ph") == "X"}
                skew = max(
                    (float(v.get("max_skew_s") or 0.0)
                     for v in doc["otherData"].get("nodes", {}).values()),
                    default=0.0,
                )
                return (
                    f"wrote merged fleet trace to {args[1]}: "
                    f"{sum(1 for e in doc['traceEvents'] if e.get('ph') == 'X')} "
                    f"span(s) across {len(lanes)} node lane(s), "
                    f"max clamp skew {skew * 1e3:.2f}ms"
                )
            if sub == "summary":
                rows = []
                dropped = None
                for name, s in tracer.summary().items():
                    if name == "dropped_events":
                        dropped = s
                        continue
                    # format_latency already leads with n=<count>.
                    rows.append([name, format_latency(s)])
                if not rows:
                    return "no spans recorded (is tracing on?)"
                table = format_table(["span", "latency"], rows)
                if dropped:
                    table += f"\nWARNING: {dropped} span(s) dropped past max_events"
                return table
            return "usage: trace on|off|summary|export <path>|fleet <path>"
        if cmd == "profile":
            # Local snapshot by default (any node keeps one — the leader's
            # holds the fleet's lanes); `profile <member>` asks a peer.
            opts = list(args)
            try:
                top = pop_option(opts, "--top", int)
                worst = pop_option(opts, "--worst", int)
                model_filter = pop_option(opts, "--model")
            except ValueError as e:
                return str(e)
            if len(opts) > 1:
                return "usage: profile [member] [--model M] [--top K] [--worst K]"
            if opts:
                snap = n.rpc.call(opts[0], "obs.profile", {}, timeout=5.0)
            else:
                snap = n.profiler.snapshot()
            lanes = []
            for model, members in sorted(snap.get("profiles", {}).items()):
                if model_filter is not None and model != model_filter:
                    continue
                for member, stages in sorted(members.items()):
                    for stage, s in sorted(stages.items()):
                        lanes.append((model, member, stage, s))
            # --worst surfaces the slowest lanes (p99); --top the busiest.
            if worst is not None:
                lanes.sort(key=lambda x: (-float(x[3]["p99"]), x[0], x[1], x[2]))
                lanes = lanes[:worst]
            elif top is not None:
                lanes.sort(key=lambda x: (-int(x[3]["n"]), x[0], x[1], x[2]))
                lanes = lanes[:top]
            rows = [
                [
                    model, member, stage, s["n"],
                    f"{s['mean'] * 1e3:.2f}ms",
                    f"{s['p50'] * 1e3:.2f}ms",
                    f"{s['p99'] * 1e3:.2f}ms",
                    f"{s['qps']:.2f}",
                ]
                for model, member, stage, s in lanes
            ]
            if not rows:
                if model_filter is not None:
                    return f"no profile lanes for model {model_filter!r}"
                return "no profile lanes yet (profiles grow from dispatches and scrapes)"
            return format_table(
                ["model", "member", "stage", "n", "mean", "p50", "p99", "qps"], rows
            )
        if cmd == "critpath":
            # The leader's folded critical-path table: where each model's
            # request time actually goes, lane by (stage, member), with
            # the drift sentinel's per-lane verdict alongside.
            opts = list(args)
            try:
                top = pop_option(opts, "--top", int)
            except ValueError as e:
                return str(e)
            if len(opts) > 1:
                return "usage: critpath [model] [--top K]"
            model_filter = opts[0] if opts else None
            try:
                reply = n.rpc.call(
                    n.tracker.current, "obs.critpath", {}, timeout=5.0
                )
            except Exception as e:
                return f"leader critpath unavailable: {e}"
            table = reply.get("critpath") or {}
            sentinel = reply.get("sentinel") or {}
            drifting = {
                (ln.get("model"), ln.get("stage"), ln.get("member"))
                for ln in sentinel.get("lanes", ())
                if ln.get("alert")
            }
            rows = []
            for model, body in sorted((table.get("models") or {}).items()):
                if model_filter is not None and model != model_filter:
                    continue
                lanes = body.get("lanes") or []
                if top is not None:
                    lanes = lanes[:top]
                for ln in lanes:
                    p50, p99 = ln.get("p50"), ln.get("p99")
                    rows.append([
                        model, ln.get("stage"), ln.get("member"),
                        f"{float(ln.get('crit_s') or 0.0):.3f}s",
                        f"{float(ln.get('share') or 0.0) * 100:.1f}%",
                        f"{p50 * 1e3:.1f}ms"
                        if isinstance(p50, (int, float)) else "-",
                        f"{p99 * 1e3:.1f}ms"
                        if isinstance(p99, (int, float)) else "-",
                        ln.get("n", 0),
                        "DRIFT" if (model, ln.get("stage"), ln.get("member"))
                        in drifting else "",
                    ])
            if not rows:
                if model_filter is not None:
                    return f"no critical-path lanes for model {model_filter!r}"
                return ("no critical-path lanes yet (lanes grow as sampled "
                        "request traces are charged on the scrape cycle)")
            return format_table(
                ["model", "stage", "member", "crit", "share", "p50", "p99",
                 "n", "state"],
                rows,
            )
        if cmd == "slo":
            try:
                reply = n.rpc.call(n.tracker.current, "obs.slo", {}, timeout=5.0)
            except Exception as e:
                return f"leader slo status unavailable: {e}"
            slo = reply.get("slo") or {}
            out = []
            models = slo.get("models") or {}
            if not models:
                out.append("no SLO objectives configured (config.slo_objectives)")
            else:
                out.append(
                    f"windows: fast={slo['fast_window_s']:.0f}s "
                    f"(burn >= {slo['fast_burn_threshold']:.0f}x pages), "
                    f"slow={slo['slow_window_s']:.0f}s "
                    f"(burn >= {slo['slow_burn_threshold']:.0f}x pages)"
                )
                rows = []
                for model, s in sorted(models.items()):
                    p99 = s.get("p99_s")
                    culprit = s.get("culprit") or {}
                    rows.append([
                        model,
                        f"{s['objective_latency_s'] * 1e3:.0f}ms"
                        f"@{s['availability']:.3f}",
                        f"{p99 * 1e3:.1f}ms" if p99 is not None else "-",
                        f"{s['fast_burn']:.2f}x",
                        f"{s['slow_burn']:.2f}x",
                        "FAST-BURN" if s.get("fast_alert")
                        else ("slow-burn" if s.get("slow_alert") else "ok"),
                        f"{culprit.get('stage')}@{culprit.get('member')} "
                        f"{float(culprit.get('critpath_share') or 0.0) * 100:.0f}%"
                        if culprit else "-",
                    ])
                out.append(format_table(
                    ["model", "objective", "p99", "fast burn", "slow burn",
                     "state", "culprit"],
                    rows,
                ))
            placement = reply.get("placement") or {}
            if placement:
                excluded = placement.get("excluded") or []
                assignment = placement.get("assignment") or {}
                out.append(
                    f"placement: moves {placement.get('moves_used', 0)}"
                    f"/{placement.get('max_moves', 0)} this window, excluded: "
                    + (", ".join(excluded) if excluded else "(none)")
                )
                for name, ms in sorted(assignment.items()):
                    out.append(f"  {name}: {', '.join(ms)}")
            return "\n".join(out)
        if cmd == "tenants":
            # The tenant plane in one read: declared table, this node's gate
            # ledgers, the leader's per-tenant burn lanes, and the
            # autoscaler's decision ring.
            specs = n.tenant_specs
            if not specs:
                return (
                    "no tenants declared (config.tenants): every caller "
                    "rides the default tenant with the full share"
                )
            out = [format_table(
                ["tenant", "priority", "share"],
                [[name, sp.priority, f"{sp.share:.2f}"]
                 for name, sp in sorted(specs.items())],
            )]
            for gate_name, gate in (
                ("predict", n.predict_gate), ("transfer", n.transfer_gate),
            ):
                tenants = gate.summary().get("tenants") or {}
                if not tenants:
                    continue
                out.append(f"{gate_name} gate (this node):")
                out.append(format_table(
                    ["tenant", "priority", "occupancy", "debt",
                     "over-quota sheds"],
                    [[tname, t["priority"], f"{t['active']}/{t['quota']}",
                      t["debt"], t["over_quota_sheds"]]
                     for tname, t in sorted(tenants.items())],
                ))
            try:
                reply = n.rpc.call(n.tracker.current, "obs.slo", {}, timeout=5.0)
            except Exception as e:
                out.append(f"leader slo status unavailable: {e}")
                reply = {}
            lanes = []
            for model, s in sorted(
                ((reply.get("slo") or {}).get("models") or {}).items()
            ):
                for tname, lane in sorted((s.get("tenants") or {}).items()):
                    p99 = lane.get("p99_s")
                    lanes.append([
                        f"{model}@{tname}",
                        f"{p99 * 1e3:.1f}ms" if p99 is not None else "-",
                        f"{lane['fast_burn']:.2f}x",
                        f"{lane['slow_burn']:.2f}x",
                        "FAST-BURN" if lane.get("fast_alert")
                        else ("slow-burn" if lane.get("slow_alert") else "ok"),
                    ])
            if lanes:
                out.append("per-tenant burn (leader's evaluator):")
                out.append(format_table(
                    ["lane", "p99", "fast burn", "slow burn", "state"], lanes,
                ))
            auto = reply.get("autoscaler") or (
                n.autoscaler.status() if n.autoscaler is not None else {}
            )
            if auto:
                targets = ", ".join(
                    f"{name}={t['current']} (streak {t['clear_streak']}"
                    f"/{auto['clear_windows']}w)"
                    for name, t in sorted(auto.get("targets", {}).items())
                )
                out.append(f"autoscaler targets: {targets or '(none)'}")
                decisions = auto.get("decisions") or []
                out.append(
                    "autoscaler decisions: "
                    + ("; ".join(_fmt_decision(d) for d in decisions[-4:])
                       if decisions else "(none yet)")
                )
            return "\n".join(out)
        if cmd == "device":
            # Device-plane fleet table (cluster/devicemon.py, docs/
            # OBSERVABILITY.md §8), read from the leader's last obs scrape
            # so it works from any member; falls back to this node's own
            # gauges when no leader scrape is reachable.
            try:
                reply = n.rpc.call(n.tracker.current, "obs.fleet", {}, timeout=5.0)
                fleet = reply.get("fleet") or {}
            except Exception:
                fleet = {}
            if not fleet:
                fleet = {n.self_member_addr: {"metrics": n.registry.snapshot()}}
            rows = []
            for addr, r in sorted(fleet.items()):
                gauges = (r.get("metrics") or {}).get("gauges") or {}
                used = gauges.get("hbm_bytes_in_use")
                limit = gauges.get("hbm_limit_bytes")
                hbm = (
                    f"{_fmt_bytes(used)}/{_fmt_bytes(limit)}"
                    if used is not None and limit is not None
                    else "-"
                )
                mfu = ", ".join(
                    f"{k[len('mfu_'):]}={v:.3f}"
                    for k, v in sorted(gauges.items())
                    if k.startswith("mfu_") and v is not None
                )
                compiles = gauges.get("jit_compiles")
                seconds = gauges.get("jit_compile_seconds")
                rows.append([
                    addr,
                    hbm,
                    "-" if compiles is None else f"{compiles:g}",
                    "-" if seconds is None else f"{seconds:.1f}s",
                    f"{gauges.get('jit_steady_recompiles') or 0:g}",
                    mfu or "-",
                ])
            return format_table(
                ["node", "hbm used/limit", "compiles", "compile time",
                 "steady recompiles", "mfu"],
                rows,
            )
        if cmd == "help":
            return HELP
        if cmd in ("exit", "quit"):
            raise EOFError
        return f"unknown command {cmd!r} (try: help)"


def repl(node) -> None:
    cli = Cli(node)
    while True:
        try:
            line = input("> ")
        except (EOFError, KeyboardInterrupt):
            break
        try:
            out = cli.run_command(line)
        except EOFError:
            break
        if out:
            print(out)
    node.leave()
    node.stop()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="dmlc_tpu_torch cluster node")
    parser.add_argument("--config", help="path to a ClusterConfig JSON file")
    parser.add_argument("--log-file", help="override the {HOSTNAME}.log default")
    parser.add_argument("--device", help="where the engines run: cuda (default) or cpu")
    args = parser.parse_args(argv)

    config = ClusterConfig.from_json(args.config) if args.config else ClusterConfig()
    log_file = args.log_file or f"{socket.gethostname()}.log"
    logging.basicConfig(
        filename=log_file,
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )

    from dmlc_tpu_torch.cluster.node import ClusterNode

    node = ClusterNode(config, device=args.device)
    node.start()
    print(f"node up: member={node.self_member_addr} gossip={node.gossip.address}")
    if node.is_candidate:
        print(f"leader candidate at {node.self_leader_addr}")
    print("type 'help' for commands")
    repl(node)


if __name__ == "__main__":
    main()
