"""Checkpointed training driver: the train step in a restartable loop.

Counterpart of ``dmlc_tpu/parallel/trainer.py``, on one device or over a
``{dp, tp}`` mesh (``mesh=``, passed through to ``make_train_step``).
Every ``checkpoint_every`` steps, and once at the end, the whole train
state (parameters, BatchNorm statistics, AdamW moments, step) goes to the
checkpointer (``utils/checkpoint.py``: a local directory or SDFS),
gathered from its shards into whole leaves, as the JAX package saves host
arrays; over several processes rank 0 saves it. A ``TrainingDriver``
started later restores it into its one-device template before its first
step, re-shards it onto its own mesh and continues where training
stopped, so a checkpoint saved under one mesh restores under another or
under none.

``data_fn(step) -> (images, labels)`` stands for the input pipeline.
"""

from __future__ import annotations

import logging
from typing import Callable

from dmlc_tpu_torch.parallel import train as train_lib
from dmlc_tpu_torch.parallel.mesh import Mesh, process_index_count
from dmlc_tpu_torch.utils.checkpoint import CheckpointNotFound

log = logging.getLogger(__name__)


class TrainingDriver:
    """Drive train steps with periodic checkpoints.

    ``checkpointer`` is anything with ``save(state, step)`` and
    ``restore(template) -> (state, step)`` (``LocalCheckpointer``,
    ``SdfsCheckpointer``), or None to disable checkpoints."""

    def __init__(
        self,
        state: train_lib.TrainState,
        data_fn: Callable[[int], tuple],
        checkpointer=None,
        checkpoint_every: int = 100,
        remat: bool = False,
        grad_accum: int = 1,
        *,
        mesh: Mesh | None = None,
    ):
        self.mesh = mesh
        self.data_fn = data_fn
        self.checkpointer = checkpointer
        self.saves = process_index_count()[0] == 0
        self.checkpoint_every = int(checkpoint_every)
        self.history: list[dict] = []
        self.start_step = 0
        if checkpointer is not None:
            try:
                state, self.start_step = checkpointer.restore(state)
                log.info("restored checkpoint at step %d", self.start_step)
            except CheckpointNotFound as e:
                log.info("no checkpoint to restore (%s); starting fresh", e)
        self.state, self.step_fn = train_lib.make_train_step(
            state, remat=remat, grad_accum=grad_accum, mesh=mesh
        )

    def run(self, steps: int) -> dict:
        """Train until the step counter reaches ``start + steps``. Returns
        the last metrics as floats. Checkpoints every ``checkpoint_every``
        steps and once more at the end."""
        step = self.start_step
        last: dict = {}
        for _ in range(steps):
            images, labels = self.data_fn(step)
            self.state, metrics = self.step_fn(self.state, images, labels)
            step += 1
            last = {k: float(v) for k, v in metrics.items()}
            self.history.append({"step": step, **last})
            if step % self.checkpoint_every == 0:
                self._save(step)
        if step % self.checkpoint_every != 0:
            self._save(step)
        self.start_step = step
        return last

    def _save(self, step: int) -> None:
        if self.checkpointer is not None and self.saves:
            self.checkpointer.save(self.state, step)
