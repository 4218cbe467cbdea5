"""The port stands alone: no module of dmlc_tpu_torch (nor chip_smoke.py)
imports JAX, flax, optax or the JAX package, and its entry points refuse to run
without a CUDA device unless the caller asks for the CPU."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dmlc_tpu_torch
from dmlc_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import dmlc_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(dmlc_tpu_torch.__path__, "dmlc_tpu_torch."))
for name in names:
    importlib.import_module(name)
forbidden = sorted(
    m for m in sys.modules
    if m in ("jax", "flax", "jaxlib", "optax", "dmlc_tpu")
    or m.startswith(("jax.", "flax.", "jaxlib.", "optax.", "dmlc_tpu."))
)
print(json.dumps({"modules": names, "forbidden": forbidden}))
"""


def test_port_modules_import_nothing_of_jax_or_the_jax_package():
    import json

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "dmlc_tpu_torch.parallel.inference" in report["modules"]
    assert "dmlc_tpu_torch.scheduler.worker" in report["modules"]
    for name in ("generate.kvcache", "generate.engine", "generate.slots", "generate.worker",
                 "ops.ragged_decode", "models.lm", "parallel.ring_attention",
                 "cluster.deadline", "cluster.tenant", "ops.flash", "parallel.train",
                 "parallel.trainer", "utils.checkpoint", "native", "cluster.auth",
                 "cluster.rpc", "cluster.admission", "cluster.retrypolicy", "cluster.clock",
                 "cluster.transport", "cluster.membership", "utils.config", "utils.ring",
                 "utils.metrics", "cluster.diskio", "cluster.faults", "cluster.flight",
                 "cluster.failover", "cluster.sdfs", "scheduler.dataset", "models.weights",
                 "scheduler.jobs", "cluster.node", "cluster.localcluster", "cli",
                 "cluster.profile", "cluster.critpath", "cluster.sentinel", "cluster.observe",
                 "cluster.scrapetree", "cluster.devicemon", "models.vit", "models.clip",
                 "parallel.ulysses", "parallel.sp_transformer", "parallel.pipeline",
                 "parallel.moe", "parallel.multihost", "parallel.mesh", "models.export",
                 "models.aoti_bundle", "ops._build_host"):
        assert f"dmlc_tpu_torch.{name}" in report["modules"]
    assert report["forbidden"] == []


def _imported_roots(path: Path) -> set[str]:
    import ast

    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module)
    return roots


def _forbidden(name: str) -> bool:
    return name in ("jax", "flax", "optax", "dmlc_tpu") or name.startswith(
        ("jax.", "flax.", "optax.", "dmlc_tpu."))


def test_no_source_names_a_forbidden_import():
    """Imports inside functions count too (the subprocess check above only
    sees what module import runs)."""
    files = sorted((REPO / "dmlc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    # multihost.py is JAX-free in the JAX package too; the port keeps its
    # own copy, which must not import that one.
    assert REPO / "dmlc_tpu_torch" / "parallel" / "multihost.py" in files
    for path in files:
        bad = sorted(n for n in _imported_roots(path) if _forbidden(n))
        assert bad == [], f"{path.relative_to(REPO)} imports {bad}"
    # The native sources name no path of the JAX package either.
    import re

    sources = sorted((REPO / "dmlc_tpu_torch" / "native").glob("*.cpp"))
    assert REPO / "dmlc_tpu_torch" / "native" / "aoti_host.cpp" in sources
    for path in sources:
        assert re.search(r"dmlc_tpu(?!_torch)", path.read_text()) is None, path.name


def test_package_prefix_is_not_mistaken_for_the_jax_package():
    assert not _forbidden("dmlc_tpu_torch") and not _forbidden("dmlc_tpu_torch.ops")
    assert _forbidden("dmlc_tpu") and _forbidden("dmlc_tpu.ops")
    assert _forbidden("optax") and _forbidden("optax.losses") and not _forbidden("optaxx")


def test_every_port_module_is_walked():
    names = {m.name for m in pkgutil.walk_packages(dmlc_tpu_torch.__path__, "dmlc_tpu_torch.")}
    assert {"dmlc_tpu_torch.ops.kernels", "dmlc_tpu_torch.models.convert"} <= names


def test_entry_points_refuse_without_cuda(monkeypatch, tmp_path):
    from dmlc_tpu_torch.parallel.inference import InferenceEngine
    from dmlc_tpu_torch.parallel.mesh import make_mesh
    from dmlc_tpu_torch.parallel.train import create_train_state, default_optimizer, lm_train_step
    from dmlc_tpu_torch.parallel.trainer import TrainingDriver
    from dmlc_tpu_torch.scheduler.worker import EngineBackend, ExportedBackend, LmBackend
    from dmlc_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lm = torch.nn.Linear(4, 4)
    for make in (
        lambda: InferenceEngine("resnet18"),
        lambda: InferenceEngine("alexnet", device="cuda"),
        lambda: EngineBackend("resnet18", tmp_path),
        lambda: ExportedBackend("resnet18", tmp_path, None),
        lambda: LmBackend("lm_wide"),
        lambda: make_mesh({"tp": 2}),
        lambda: resolve_device(None),
        lambda: create_train_state(torch.nn.Linear(4, 4)),
        lambda: TrainingDriver(create_train_state(torch.nn.Linear(4, 4)), lambda step: None),
        lambda: lm_train_step(lm, default_optimizer(lm.parameters()), torch.zeros(1, 2)),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_kernel_sources_are_listed_and_build_is_lazy():
    assert _build.kernel_names() == ["flash_bwd_dkv", "flash_bwd_dq", "flash_fwd", "flash_wide",
                                     "gather_pages", "jpeg_idct", "normalize_u8", "paged_decode",
                                     "softmax_top1"]
    assert _build.library_path("normalize_u8").parent == _build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    with pytest.raises(FileNotFoundError):
        _build.build(["no_such_kernel"])


def _node_config(tmp_path, **fields):
    from dmlc_tpu_torch.utils.config import ClusterConfig

    return ClusterConfig(host="127.0.0.1", gossip_port=0, member_port=0, leader_port=0,
                         storage_dir=str(tmp_path / "storage"), **fields)


def test_failover_has_the_leader_classes():
    from dmlc_tpu_torch.cluster import failover

    assert {"epoch_key", "LeaderTracker", "StandbyLeader"} <= set(vars(failover))


def test_node_refuses_without_cuda(monkeypatch, tmp_path):
    """A node that builds its resnet18 engine wants the card unless told
    ``device="cpu"``."""
    from dmlc_tpu_torch.cluster.node import ClusterNode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterNode(_node_config(tmp_path, job_models=["resnet18"]))
    node = ClusterNode(_node_config(tmp_path, job_models=["resnet18"]), device="cpu")
    try:
        assert node.worker.backends["resnet18"].device == torch.device("cpu")
        assert node._node_info({})["chips"] == 1
    finally:
        node.stop()


def test_node_builds_engine_backends_for_vit_and_clip(tmp_path):
    """Job models of the transformer image families get their
    EngineBackend (the engine built lazily, on the device asked for), the
    device monitor their FLOPs and placement their resident bytes, with
    no refusal."""
    from dmlc_tpu_torch.cluster.node import ClusterNode
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.scheduler.worker import EngineBackend

    models = ["vit_b16", "clip_vit_l14"]
    node = ClusterNode(_node_config(tmp_path, job_models=models), device="cpu")
    try:
        for name in models:
            backend = node.worker.backends[name]
            assert isinstance(backend, EngineBackend) and backend.engine is None
            assert backend.device == torch.device("cpu")
            assert node.devicemon._item_flops(name) == get_model(name).flops_per_item() > 0
            assert node._model_required_bytes(name) == get_model(name).param_bytes() > 0
    finally:
        node.stop()


@pytest.mark.parametrize("switch,value,module", [
    ("serve_from_executable", True, "ExportedBackend"),
    ("mesh_processes", 2, "parallel/multihost.py"),
])
def test_node_refuses_switches_of_unported_modules(tmp_path, switch, value, module):
    """No switch is refused any more. ``serve_from_executable`` builds an
    ``ExportedBackend`` for each image job model (lazy, on the node's
    device, wired to the node's SDFS client) and an ``LmBackend`` for a
    ``kind="lm"`` one; ``mesh_processes`` > 1 builds the leader's
    ``MeshBootstrap`` from ``parallel/multihost.py`` (not leading until
    promoted) and serves its verbs on the leader server."""
    from dmlc_tpu_torch.cluster import node as node_mod
    from dmlc_tpu_torch.cluster.node import ClusterNode

    assert not hasattr(node_mod, "refuse_unported")
    if switch == "serve_from_executable":
        from dmlc_tpu_torch.scheduler.worker import LmBackend

        node = ClusterNode(_node_config(tmp_path, job_models=["resnet18", "lm_wide"],
                                        **{switch: value}), device="cpu")
        try:
            backend = node.worker.backends["resnet18"]
            assert type(backend).__name__ == module
            assert backend.sdfs is node.sdfs and backend._server is None
            assert backend.device == torch.device("cpu")
            assert isinstance(node.worker.backends["lm_wide"], LmBackend)
        finally:
            node.stop()
        return
    from dmlc_tpu_torch.cluster.rpc import RpcError, TcpRpc
    from dmlc_tpu_torch.parallel.multihost import MeshBootstrap

    node = ClusterNode(_node_config(tmp_path, **{switch: value}), backends={}, device="cpu")
    try:
        boot = node.mesh_bootstrap
        assert isinstance(boot, MeshBootstrap) and type(boot).__module__.endswith(
            module.replace("/", ".").removesuffix(".py"))
        assert boot.num_processes == 2 and not boot.is_leading
        assert node.standby.mesh_bootstrap is boot and node._mesh_group() is None
        rpc, leader = TcpRpc(), node.leader_server.address
        with pytest.raises(RpcError, match="not the active leader"):
            rpc.call(leader, "mesh.register", {"addr": "hostA:1"}, timeout=10)
        boot.is_leading = True  # StandbyLeader's promotion does this
        info = rpc.call(leader, "mesh.register", {"addr": "hostA:1"}, timeout=10)
        assert info["process_id"] == 0 and not info["ready"]
        assert rpc.call(leader, "mesh.state", {}, timeout=10) == {"ranks": {"hostA:1": 0}}
    finally:
        node.stop()


def test_node_builds_lm_backends_for_lm_job_models(tmp_path):
    """Job models of kind "lm" get an LmBackend on the node's device, with
    the config's gang width, prompt length and HBM budget, the device
    monitor's device_work and a resident-bytes gauge (None until a program
    builds), with no refusal."""
    from dmlc_tpu_torch.cluster.node import ClusterNode, _backend_resident
    from dmlc_tpu_torch.scheduler.worker import LmBackend

    models = ["lm_small", "lm_wide"]
    node = ClusterNode(_node_config(tmp_path, job_models=models, lm_gang_devices=2,
                                    lm_prompt_len=12, lm_hbm_budget_bytes=1000),
                       device="cpu")
    try:
        for name in models:
            backend = node.worker.backends[name]
            assert isinstance(backend, LmBackend)
            assert backend._devices == [torch.device("cpu")]
            assert (backend.gang_devices, backend.prompt_len, backend.hbm_budget_bytes) == \
                (2, 12, 1000)
            assert backend.device_work == node.devicemon.device_work
            assert _backend_resident(backend) is None
    finally:
        node.stop()


@pytest.mark.parametrize("switch,value,attr", [
    ("autoscaler_enabled", True, "autoscaler"),
    ("decode_tier_enabled", True, "decode_tier"),
    ("slo_objectives", {"resnet18": {"latency_s": 0.5}}, "slo"),
])
def test_node_runs_switches_of_ported_modules(tmp_path, caplog, switch, value, attr):
    """The closed loop's switches build their module: the autoscaler, the
    fleet decode tier and the SLO evaluator, with no warning and no
    refusal."""
    from dmlc_tpu_torch.cluster.node import ClusterNode

    with caplog.at_level("WARNING", logger="dmlc_tpu_torch.cluster.node"):
        node = ClusterNode(_node_config(tmp_path, **{switch: value}), backends={}, device="cpu")
    try:
        assert getattr(node, attr) is not None
        assert not [r for r in caplog.records if "running without" in r.getMessage()]
        if attr == "slo":
            reply = node.leader_server.methods["obs.slo"]({})
            assert set(reply["slo"]["models"]) == {"resnet18"}
        if attr == "autoscaler":
            # The advisor's replica targets, one a job model (no decode
            # tier and no generation backends on this config).
            targets = node.status(remote=False)["autoscaler"]["targets"]
            assert sorted(targets) == [f"replicas_{m}" for m in sorted(node.config.job_models)]
    finally:
        node.stop()


def test_node_names_the_default_switches_it_runs_without(tmp_path, caplog):
    """Every switch of a default config now builds its module: the node
    warns of nothing it runs without, and the leader candidate has its
    placement advisor, its generation router and the observability plane."""
    from dmlc_tpu_torch.cluster import node as node_mod

    with caplog.at_level("WARNING", logger="dmlc_tpu_torch.cluster.node"):
        node = node_mod.ClusterNode(_node_config(tmp_path), backends={})
    node.stop()
    assert not [r for r in caplog.records if "running without" in r.getMessage()]
    assert not hasattr(node_mod, "DEFAULT_ON_LEFT_OUT")
    assert node.advisor is not None and node.genrouter is not None
    assert node.scheduler.advisor is node.advisor
    assert node.standby.genrouter is node.genrouter
    assert node.critpath is not None and node.sentinel is not None
    assert node.profile_path().exists()  # saved at stop: profile_persist is on
    quiet = node_mod.ClusterNode(_node_config(tmp_path / "quiet", placement_enabled=False),
                                 backends={})
    quiet.stop()
    assert quiet.advisor is None and quiet.scheduler.advisor is None
