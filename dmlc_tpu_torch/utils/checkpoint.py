"""Checkpoint and resume of a train state, in a local directory or in SDFS.

Counterpart of ``dmlc_tpu/utils/checkpoint.py``. The payload is the
``torch.save`` bytes of ``{"step", "model", "optimizer"}`` (the model's and
the optimizer's state dicts: parameters, BatchNorm statistics, AdamW
moments); flax cannot read it, nor this package flax's. A state placed on a
mesh is gathered into whole leaves first (``train.state_dicts``), so the
payload is the one-device state's whatever the mesh. Restoring loads the
bytes into the given state's model and optimizer in place, onto the
state's device, re-sharding them where that state is placed on a mesh
(``train.load_state_dicts``).

- local: ``save_local`` writes ``checkpoint_<step>.pt`` through a temporary
  file and an atomic rename, so a crash never leaves a torn checkpoint;
  ``latest_local`` finds the newest and ``restore_local`` loads it.
- SDFS: ``SdfsCheckpointer`` stores every save as a new version of one file
  through any client with ``put_bytes(data, name)`` and ``get_bytes(name,
  version=)``, behind the JAX package's ``DMLCCKPT`` header and 8-byte
  big-endian step.
"""

from __future__ import annotations

import io
import logging
import os
from pathlib import Path

import torch

from dmlc_tpu_torch.cluster.rpc import RpcError
from dmlc_tpu_torch.parallel.train import TrainState, load_state_dicts, state_dicts

log = logging.getLogger(__name__)


class CheckpointNotFound(LookupError):
    """There is no checkpoint to restore."""


def state_to_bytes(state: TrainState) -> bytes:
    model, optimizer = state_dicts(state)
    buf = io.BytesIO()
    torch.save({"step": int(state.step), "model": model, "optimizer": optimizer}, buf)
    return buf.getvalue()


def state_from_bytes(template: TrainState, data: bytes) -> TrainState:
    """Load ``data`` into ``template``'s model and optimizer; returns it."""
    payload = torch.load(io.BytesIO(data), map_location=template.device, weights_only=True)
    load_state_dicts(template, payload["model"], payload["optimizer"])
    template.step = int(payload["step"])
    return template


# ---------------------------------------------------------------------------
# local directory checkpoints
# ---------------------------------------------------------------------------


def save_local(state: TrainState, directory: str | Path, step: int) -> Path:
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"checkpoint_{step:08d}.pt"
    tmp = path.with_suffix(".tmp")
    tmp.write_bytes(state_to_bytes(state))
    os.replace(tmp, path)  # atomic publish
    return path


def latest_local(directory: str | Path) -> tuple[int, Path] | None:
    d = Path(directory)
    ckpts = sorted(d.glob("checkpoint_*.pt")) if d.exists() else []
    if not ckpts:
        return None
    return int(ckpts[-1].stem.split("_")[1]), ckpts[-1]


def restore_local(template: TrainState, directory: str | Path) -> tuple[TrainState, int]:
    """-> (state, step) from the newest checkpoint, or (template, 0)."""
    found = latest_local(directory)
    if found is None:
        return template, 0
    step, path = found
    return state_from_bytes(template, path.read_bytes()), step


class LocalCheckpointer:
    """``save``/``restore`` over a local directory, for ``TrainingDriver``."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)

    def save(self, state: TrainState, step: int) -> Path:
        return save_local(state, self.directory, step)

    def restore(self, template: TrainState) -> tuple[TrainState, int]:
        return restore_local(template, self.directory)


# ---------------------------------------------------------------------------
# SDFS-backed checkpoints (replicated and versioned)
# ---------------------------------------------------------------------------


class SdfsCheckpointer:
    """Checkpoints as versions of one SDFS file: ``save`` puts a new
    version, ``restore`` pulls the latest or a given one."""

    MAGIC = b"DMLCCKPT"

    def __init__(self, sdfs_client, name: str = "checkpoints/train_state"):
        self.sdfs = sdfs_client
        self.name = name

    def save(self, state: TrainState, step: int) -> int:
        payload = self.MAGIC + int(step).to_bytes(8, "big") + state_to_bytes(state)
        reply = self.sdfs.put_bytes(payload, self.name)
        log.info("checkpoint step %d -> %s v%d", step, self.name, reply["version"])
        return reply["version"]

    def restore(self, template: TrainState, version: int | None = None
                ) -> tuple[TrainState, int]:
        """-> (state, step). Raises ``CheckpointNotFound`` when the store
        has no such file or version."""
        try:
            _, payload = self.sdfs.get_bytes(self.name, version=version)
        except (KeyError, RpcError) as e:
            raise CheckpointNotFound(f"{self.name} v{version}: {e}") from e
        if payload[: len(self.MAGIC)] != self.MAGIC:
            raise ValueError(f"{self.name} is not a dmlc checkpoint")
        off = len(self.MAGIC)
        step = int.from_bytes(payload[off: off + 8], "big")
        return state_from_bytes(template, payload[off + 8:]), step
