"""Interactive CLI / REPL over a node of this package.

Ported from ``dmlc_tpu/cli.py``: the verbs whose node parts this package
has answer as the JAX package's do — membership (list_mem/lm, list_self,
join/j, leave/l), SDFS (put/p, get/g, get-versions/gv, delete/d, ls,
store/s, scrub), ML (train/t, predict, jobs, assign), status, flight, trace
(on/off, summary, export), tenants, help and exit. ``jobs`` prints accuracy
and latency percentiles (mean/std/median/p90/p95/p99) like the reference's
histogram report (main.rs:282-309). Every other verb of the JAX package's
CLI answers with an error that names the module it waits for
(``WAITING``). Logs go to ``{HOSTNAME}.log`` (main.rs:27-28).

Run: ``python -m dmlc_tpu_torch.cli --config cluster.json [--device cuda]``
(or with no config for a single-node local cluster). The node's engines run
on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import shlex
import socket

from dmlc_tpu_torch.cluster.rpc import RpcError, RpcUnreachable
from dmlc_tpu_torch.utils.config import ClusterConfig

log = logging.getLogger(__name__)

#: Verbs of the JAX package's CLI whose node parts this package has not
#: ported yet, with the module each one waits for.
WAITING = {
    "generate": "dmlc_tpu/scheduler/genrouter.py",
    "sessions": "dmlc_tpu/scheduler/genrouter.py",
    "drain": "dmlc_tpu/scheduler/genrouter.py",
    "undrain": "dmlc_tpu/scheduler/genrouter.py",
    "export": "dmlc_tpu/models/export.py",
    "export-bundle": "dmlc_tpu/models/pjrt_bundle.py",
    "mesh-join": "dmlc_tpu/parallel/multihost.py",
    "metrics": "dmlc_tpu/cluster/observe.py",
    "profile": "dmlc_tpu/cluster/profile.py",
    "slo": "dmlc_tpu/scheduler/placement.py",
    "critpath": "dmlc_tpu/cluster/critpath.py",
    "device": "dmlc_tpu/cluster/devicemon.py",
}
#: ``trace fleet`` merges every node's spans through the observability plane.
TRACE_FLEET_WAITS = "dmlc_tpu/cluster/observe.py"


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


def format_latency(summary: dict[str, float]) -> str:
    ms = lambda k: f"{summary[k] * 1e3:.2f}ms" if summary.get("count") else "-"
    return (
        f"n={int(summary.get('count', 0))} mean={ms('mean')} std={ms('std')} "
        f"median={ms('median')} p90={ms('p90')} p95={ms('p95')} p99={ms('p99')}"
    )


def waiting_error(verb: str, module: str) -> str:
    """The answer of a verb whose node part is not ported yet."""
    return f"error: {verb!r} waits for {module}, which dmlc_tpu_torch has not ported yet"


def set_fleet_tracing(rpc, addrs: list[str], enable: bool, timeout: float = 2.0) -> dict:
    """Flip tracing on every reachable peer (``obs.trace_ctl``, best-effort;
    returns {addr: reached}). The call of ``dmlc_tpu/cluster/observe.py``'s
    function of this name: peers of this package do not serve that verb
    yet, so only peers of the JAX package are reached."""
    out: dict[str, bool] = {}
    for addr in addrs:
        try:
            rpc.call(addr, "obs.trace_ctl", {"enable": enable, "reset": False},
                     timeout=timeout)
            out[addr] = True
        except (RpcUnreachable, RpcError) as e:
            out[addr] = False
            log.warning("trace_ctl %s failed: %s", addr, e)
    return out


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
  jobs                                  job status, accuracy, latency percentiles
  assign                                per-job member assignment table
  status                                overload-control counters: sheds,
                                        deadline trips, queue high-water,
                                        breakers, gray-demoted members,
                                        per-tenant gate occupancy + quota debt
  trace on|off|summary|export <path>    span tracing: toggle (peers of the JAX
                                        package too), aggregate table, local
                                        Chrome trace
  flight [member]                       flight-recorder event ring (breaker /
                                        gray / quarantine / shed transitions)
  tenants                               tenant table: declared priorities and
                                        shares, per-gate occupancy/quota/debt
  help                                  this text
  exit | quit                           leave and stop the node
Not ported yet, each answering with the module it waits for:
  """ + ", ".join(sorted(WAITING)) + ", trace fleet\n"


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
            if s.get("cluster_error"):
                out.append(f"  leader unreachable: {s['cluster_error']}")
            return "\n".join(out)
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
            from dmlc_tpu_torch.utils.tracing import tracer

            sub = args[0] if args else "summary"
            if sub in ("on", "off", "start", "stop"):
                enable = sub in ("on", "start")
                tracer.enabled = enable
                # Arm/disarm the fleet (best-effort): spans only merge into
                # one timeline if every node records them.
                reached = set_fleet_tracing(
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
                return waiting_error("trace fleet", TRACE_FLEET_WAITS)
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
            return "usage: trace on|off|summary|export <path>"
        if cmd == "tenants":
            # The tenant plane in one read: declared table and this node's
            # gate ledgers.
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
            return "\n".join(out)
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
