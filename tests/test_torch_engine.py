"""The port's InferenceEngine on the CPU against the JAX InferenceEngine.

Both engines serve "tinynet" (registered for the JAX package by
tests/tiny_model.py, and for the port below) with the same numpy-drawn
weights, carried to the port with the engine's load_variables. The JAX
engine runs its Pallas kernels (use_pallas=True, interpret mode on the CPU)
so the two compute the same normalization.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tiny_model import N_CLASSES  # registers the JAX tinynet
from torch import nn

from dmlc_tpu.parallel.inference import InferenceEngine as JaxEngine
from dmlc_tpu_torch.models import registry as t_registry
from dmlc_tpu_torch.models.convert import conv_weight, dense_weight, state_dict_to_jax
from dmlc_tpu_torch.models.layers import Conv2d, Linear
from dmlc_tpu_torch.parallel.inference import INGEST_STAGES, InferenceEngine

# Both engines run float32 on the CPU. Top-1 indices must be identical; the
# top-1 probability differs only by summation order in a 27-term conv and
# an 8-term dense layer.
PROB_RTOL = 1e-5
BATCH = 8
SIZE = 32


class TorchTinyNet(nn.Module):
    """Counterpart of tests/tiny_model.TinyNet: 3x3 conv (same padding,
    bias) -> ReLU -> global mean -> dense head."""

    def __init__(self, num_classes: int = N_CLASSES, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 8, 3, 1, 1, compute_dtype=dtype)
        self.head = Linear(8, num_classes, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv1(x.permute(0, 3, 1, 2).to(self.dtype)))
        return self.head(x.mean(dim=(2, 3))).to(torch.float32)


def tiny_from_jax(variables):
    p = variables["params"]
    return {
        "conv1.weight": conv_weight(p["conv1"]["kernel"]),
        "conv1.bias": torch.from_numpy(np.asarray(p["conv1"]["bias"], np.float32)),
        "head.weight": dense_weight(p["head"]["kernel"]),
        "head.bias": torch.from_numpy(np.asarray(p["head"]["bias"], np.float32)),
    }


def _tiny_locate(module):
    return (module,), {"conv1": "conv", "head": "dense"}[module]


def tiny_to_jax(sd):
    return state_dict_to_jax(sd, _tiny_locate)


if "tinynet" not in t_registry.list_models():
    t_registry.register(
        t_registry.ModelSpec("tinynet", TorchTinyNet, SIZE, N_CLASSES, from_jax=tiny_from_jax,
                             to_jax=tiny_to_jax)
    )


def tiny_variables(seed: int = 0) -> dict:
    """Seeded numpy weights in the JAX tinynet's variables layout."""
    rng = np.random.default_rng(seed)
    return {"params": {
        "conv1": {"kernel": (rng.normal(size=(3, 3, 3, 8)) / np.sqrt(27)).astype(np.float32),
                  "bias": (0.1 * rng.normal(size=8)).astype(np.float32)},
        "head": {"kernel": (3 * rng.normal(size=(8, N_CLASSES)) / np.sqrt(8)).astype(np.float32),
                 "bias": (0.1 * rng.normal(size=N_CLASSES)).astype(np.float32)},
    }}


def seeded_pixels(paths, size: int = SIZE) -> np.ndarray:
    """A decode source: one seeded uint8 image per path, from its name."""
    out = np.empty((len(paths), size, size, 3), np.uint8)
    for i, p in enumerate(paths):
        seed = int(str(p).rsplit("_", 1)[-1])
        out[i] = np.random.default_rng(seed).integers(0, 256, (size, size, 3), np.uint8)
    return out


def _engines(seed: int = 0):
    variables = tiny_variables(seed)
    jax_engine = JaxEngine("tinynet", batch_size=BATCH, dtype=jnp.float32,
                           use_pallas=True, variables=jax.tree_util.tree_map(jnp.asarray, variables))
    engine = InferenceEngine("tinynet", device="cpu", batch_size=BATCH, dtype=torch.float32,
                             variables=variables)
    return jax_engine, engine


def _same(got, want):
    np.testing.assert_array_equal(got.top1_index, want.top1_index)
    np.testing.assert_allclose(got.top1_prob, want.top1_prob, rtol=PROB_RTOL)


@pytest.mark.parametrize("n", [BATCH, 5], ids=["full", "padded"])
def test_run_batch_matches_jax(n):
    jax_engine, engine = _engines()
    batch = seeded_pixels([f"img_{i}" for i in range(n)])
    got, want = engine.run_batch(batch), jax_engine.run_batch(batch)
    assert got.top1_index.shape == (n,) and got.top1_index.dtype == np.int32
    _same(got, want)
    assert engine.latency_summary()["count"] == 1


def test_run_paths_stream_with_decode_source_matches_jax():
    jax_engine, engine = _engines(1)
    paths = [f"img_{i}" for i in range(2 * BATCH + 3)]  # three batches, last padded
    got = engine.run_paths_stream(paths, decode_source=seeded_pixels)
    want = jax_engine.run_paths_stream(paths, decode_source=seeded_pixels)
    assert got.top1_index.shape == (len(paths),)
    _same(got, want)
    # Batch by batch through run_batch gives the same answers.
    per_batch = np.concatenate([
        engine.run_batch(seeded_pixels(paths[s:s + BATCH])).top1_index
        for s in range(0, len(paths), BATCH)
    ])
    np.testing.assert_array_equal(got.top1_index, per_batch)
    summary = engine.ingest_summary()
    assert set(summary) == set(INGEST_STAGES)
    assert summary["decode"]["count"] == 3 and summary["pipeline"]["count"] == 1


def test_load_variables_carries_jax_weights():
    variables = tiny_variables(2)
    engine = InferenceEngine("tinynet", device="cpu", batch_size=BATCH, dtype=torch.float32,
                             seed=5)
    jax_engine = JaxEngine("tinynet", batch_size=BATCH, dtype=jnp.float32, use_pallas=True,
                           variables=jax.tree_util.tree_map(jnp.asarray, variables))
    batch = seeded_pixels([f"img_{i}" for i in range(BATCH)])
    engine.load_variables(variables)
    _same(engine.run_batch(batch), jax_engine.run_batch(batch))
    # A state dict in the port's own names loads too.
    engine.load_variables(tiny_from_jax(tiny_variables(3)))
    engine.load_variables(variables)
    _same(engine.run_batch(batch), jax_engine.run_batch(batch))


def test_load_variables_rejects_mismatch():
    engine = InferenceEngine("tinynet", device="cpu", batch_size=BATCH, dtype=torch.float32)
    sd = tiny_from_jax(tiny_variables())
    with pytest.raises(ValueError):
        engine.load_variables({k: v for k, v in sd.items() if k != "head.bias"})
    sd["head.bias"] = torch.zeros(N_CLASSES + 1)
    with pytest.raises(ValueError):
        engine.load_variables(sd)


def test_run_batch_rejects_empty_and_oversize():
    engine = InferenceEngine("tinynet", device="cpu", batch_size=BATCH, dtype=torch.float32)
    with pytest.raises(ValueError):
        engine.run_batch(np.zeros((0, SIZE, SIZE, 3), np.uint8))
    with pytest.raises(ValueError):
        engine.run_batch(np.zeros((BATCH + 1, SIZE, SIZE, 3), np.uint8))
    with pytest.raises(ValueError):
        engine.run_paths_stream([])


def test_engine_accounting():
    engine = InferenceEngine("tinynet", device="cpu", batch_size=BATCH, dtype=torch.float32)
    assert engine.warmup() >= 0.0
    n_params = 8 * 3 * 3 * 3 + 8 + 8 * N_CLASSES + N_CLASSES
    assert engine.resident_bytes() == 4 * n_params
    seen = []
    engine.device_work = lambda model, n, dt: seen.append((model, n))
    engine.run_batch(seeded_pixels(["img_1", "img_2"]))
    assert seen == [("tinynet", 2)]
