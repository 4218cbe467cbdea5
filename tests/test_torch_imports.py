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
                 "cluster.scrapetree", "cluster.devicemon"):
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
    for path in files:
        bad = sorted(n for n in _imported_roots(path) if _forbidden(n))
        assert bad == [], f"{path.relative_to(REPO)} imports {bad}"


def test_package_prefix_is_not_mistaken_for_the_jax_package():
    assert not _forbidden("dmlc_tpu_torch") and not _forbidden("dmlc_tpu_torch.ops")
    assert _forbidden("dmlc_tpu") and _forbidden("dmlc_tpu.ops")
    assert _forbidden("optax") and _forbidden("optax.losses") and not _forbidden("optaxx")


def test_every_port_module_is_walked():
    names = {m.name for m in pkgutil.walk_packages(dmlc_tpu_torch.__path__, "dmlc_tpu_torch.")}
    assert {"dmlc_tpu_torch.ops.kernels", "dmlc_tpu_torch.models.convert"} <= names


def test_entry_points_refuse_without_cuda(monkeypatch, tmp_path):
    from dmlc_tpu_torch.parallel.inference import InferenceEngine
    from dmlc_tpu_torch.parallel.train import create_train_state, default_optimizer, lm_train_step
    from dmlc_tpu_torch.parallel.trainer import TrainingDriver
    from dmlc_tpu_torch.scheduler.worker import EngineBackend
    from dmlc_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lm = torch.nn.Linear(4, 4)
    for make in (
        lambda: InferenceEngine("resnet18"),
        lambda: InferenceEngine("alexnet", device="cuda"),
        lambda: EngineBackend("resnet18", tmp_path),
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
                                     "gather_pages", "normalize_u8", "paged_decode",
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


@pytest.mark.parametrize("switch,value,module", [
    ("autoscaler_enabled", True, "scheduler/autoscaler.py"),
    ("decode_tier_enabled", True, "cluster/decodetier.py"),
    ("serve_from_executable", True, "ExportedBackend"),
    ("mesh_processes", 2, "parallel/multihost.py"),
    ("slo_objectives", {"resnet18": {"latency_s": 0.5}}, "scheduler/placement.py"),
    ("job_models", ["lm_small"], "LmBackend"),
])
def test_node_refuses_switches_of_unported_modules(tmp_path, switch, value, module):
    from dmlc_tpu_torch.cluster.node import ClusterNode

    with pytest.raises(NotImplementedError, match=module):
        ClusterNode(_node_config(tmp_path, **{switch: value}), backends={}, device="cpu")


def test_node_names_the_default_switches_it_runs_without(tmp_path, caplog):
    from dmlc_tpu_torch.cluster.node import DEFAULT_ON_LEFT_OUT, ClusterNode

    with caplog.at_level("WARNING", logger="dmlc_tpu_torch.cluster.node"):
        node = ClusterNode(_node_config(tmp_path), backends={})
    node.stop()
    warned = [r.getMessage() for r in caplog.records if "running without" in r.getMessage()]
    assert len(warned) == 1
    # Only the placement advisor is left out: the observability plane and
    # the device monitor run on a default config.
    assert DEFAULT_ON_LEFT_OUT == {"placement_enabled": "dmlc_tpu/scheduler/placement.py"}
    for switch, module in DEFAULT_ON_LEFT_OUT.items():
        assert switch in warned[0] and module in warned[0]
    for switch in ("critpath_enabled", "sentinel_enabled", "profile_persist",
                   "devicemon_poll_interval_s"):
        assert switch not in warned[0]
    assert node.critpath is not None and node.sentinel is not None
    assert node.profile_path().exists()  # saved at stop: profile_persist is on
    with caplog.at_level("WARNING", logger="dmlc_tpu_torch.cluster.node"):
        caplog.clear()
        quiet = ClusterNode(_node_config(tmp_path / "quiet", placement_enabled=False),
                            backends={})
    quiet.stop()
    assert not [r for r in caplog.records if "running without" in r.getMessage()]
