"""Parallel execution: the batched inference engine, the partition-rule
engine with its meshes (sharded serving), the train step on one device and
over a dp x tp mesh, multi-process meshes (``multihost``), and sequence
(ring, ring-flash, Ulysses), pipeline and expert parallelism over a mesh.

The names below are those ``dmlc_tpu/parallel/__init__.py`` exports for
the mesh, the train step and the multi-host join. They load on first use
(PEP 562): ``ops/flash.py`` imports from this package, and the train step
imports the models, which import ``ops/flash.py``, so an eager import here
would close that loop into a circular-import error.
"""

from importlib import import_module

_EXPORTS = {
    "batch_sharding": "mesh", "make_mesh": "mesh", "param_shardings": "mesh",
    "param_spec": "mesh", "replicated": "mesh", "shard_params": "mesh",
    "MeshBootstrap": "multihost", "initialize_global_runtime": "multihost",
    "join_global_mesh": "multihost", "register_until_ready": "multihost",
    "TrainState": "train", "create_train_state": "train", "default_optimizer": "train",
    "make_train_step": "train", "state_shardings": "train",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(import_module(f"dmlc_tpu_torch.parallel.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
