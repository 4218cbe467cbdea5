"""One process of a port gang for tests/test_torch_multihost.py: it joins a
port leader's ``MeshBootstrap`` through ``join_global_mesh`` (gloo on the
CPU), then either trains over the process mesh or serves gang shards.

    python torch_mesh_worker.py train LEADER SELF_ADDR WEIGHTS.npz OUT.npz
    python torch_mesh_worker.py gang LEADER CORPUS_DIR

``train``: this rank's half of a seeded batch through three steps over
``{dp: 2}`` across the two processes: two steps of the tiny ViT, one
``grad_accum=2`` step of another, and one step of the tiny BatchNorm
ResNet; the losses, the ResNet's running statistics and the ViT's
parameters go to OUT.npz; this mode imports nothing of JAX. ``gang``:
serves the tinynet ``EngineBackend`` (registered for the port by
tests/test_torch_engine.py, which imports the JAX package's too) over
TCP, prints ``{"ready", "addr", "rank", "backend"}`` once the group has
formed and serves until its stdin closes.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from dmlc_tpu_torch.cluster.rpc import TcpRpc, TcpRpcServer  # noqa: E402
from dmlc_tpu_torch.parallel.multihost import join_global_mesh  # noqa: E402

VIT = {"patch_size": 8, "hidden_size": 32, "num_layers": 2, "num_heads": 4, "mlp_dim": 64}
IMAGE, CLASSES, BATCH, LR = 16, 8, 8, 1e-3
DATA_SEED = 21


def batch() -> tuple[np.ndarray, np.ndarray]:
    """The global batch every rank draws alike; rank r trains rows
    ``r * BATCH/2 …``."""
    rng = np.random.default_rng(DATA_SEED)
    images = rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    return images, rng.integers(0, CLASSES, BATCH).astype(np.int64)


def train(leader: str, weights: str, out: str) -> None:
    from dmlc_tpu_torch.models.resnet import BasicBlock, ResNet
    from dmlc_tpu_torch.models.vit import ViT
    from dmlc_tpu_torch.parallel.mesh import make_mesh
    from dmlc_tpu_torch.parallel.train import (
        create_train_state,
        default_optimizer,
        make_train_step,
        state_dicts,
    )

    torch.set_num_threads(1)
    info = join_global_mesh(TcpRpc(), leader, sys.argv[3], timeout_s=40.0, device="cpu")
    rank = int(info["process_id"])
    mesh = make_mesh({"dp": 2}, device="cpu")
    assert mesh.process_count == 2 and mesh.local_positions() == [(rank,)]
    saved = np.load(weights)
    images, labels = batch()
    half = slice(rank * BATCH // 2, (rank + 1) * BATCH // 2)
    x, y = torch.from_numpy(images[half]), torch.from_numpy(labels[half])
    result: dict = {"rank": np.int64(rank), "backend": np.array(info["backend"])}

    def state_of(model, prefix):
        model.load_state_dict({k[len(prefix):]: torch.from_numpy(saved[k])
                               for k in saved.files if k.startswith(prefix)})
        return create_train_state(model, default_optimizer(model.parameters(), lr=LR),
                                  device="cpu")

    def vit():
        return ViT(num_classes=CLASSES, dtype=torch.float32, image_size=IMAGE, **VIT)

    state, step = make_train_step(state_of(vit(), "vit."), mesh=mesh)
    losses = []
    for _ in range(2):
        state, metrics = step(state, x, y)
        losses.append(float(metrics["loss"]))
    result["vit_losses"] = np.array(losses)
    for k, v in state_dicts(state)[0].items():
        result[f"vit.{k}"] = v.numpy()

    state, step = make_train_step(state_of(vit(), "vit."), mesh=mesh, grad_accum=2)
    _, metrics = step(state, x, y)
    result["accum_loss"] = np.float64(metrics["loss"])

    resnet = ResNet([1, 1], BasicBlock, num_classes=CLASSES, num_filters=8, dtype=torch.float32)
    state, step = make_train_step(state_of(resnet, "resnet."), mesh=mesh)
    _, metrics = step(state, x, y)
    result["resnet_loss"] = np.float64(metrics["loss"])
    for k, v in state_dicts(state)[0].items():
        if k.endswith(("running_mean", "running_var")):
            result[f"resnet.{k}"] = v.numpy()
    np.savez(out, **result)


def gang(leader: str, corpus_dir: str) -> None:
    import torch.distributed as dist

    from test_torch_engine import tiny_variables  # registers the port's tinynet
    from dmlc_tpu_torch.scheduler.worker import EngineBackend, PredictWorker

    torch.set_num_threads(1)
    backend = EngineBackend("tinynet", corpus_dir, batch_size=8, device="cpu",
                            variables=tiny_variables(0), dtype=torch.float32)
    server = TcpRpcServer("127.0.0.1", 0, PredictWorker({"tinynet": backend}).methods())
    info = join_global_mesh(TcpRpc(), leader, server.address, timeout_s=40.0, device="cpu")
    print(json.dumps({"ready": True, "addr": server.address, "rank": info["process_id"],
                      "backend": info["backend"]}), flush=True)
    sys.stdin.read()  # serve until the test closes our stdin
    server.close()
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "train":
        train(sys.argv[2], sys.argv[4], sys.argv[5])
    else:
        gang(sys.argv[2], sys.argv[3])
