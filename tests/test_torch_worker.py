"""job.predict / job.decode through the port's PredictWorker + EngineBackend
against the JAX package's, on a JPEG corpus made by the port's
utils/corpus.py. Both backends serve tinynet with the same numpy weights.

Both packages prefer their native libjpeg pipeline when it is built
(decode backend "auto"); the JPEG tests run once with both sides on the
native decoder and once with both held to PIL, so each pair is fed the same
pixels. Predictions must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import BATCH, SIZE, seeded_pixels, tiny_variables

from dmlc_tpu import native as jax_native
from dmlc_tpu.scheduler.worker import EngineBackend as JaxBackend
from dmlc_tpu.scheduler.worker import PredictWorker as JaxWorker
from dmlc_tpu.scheduler.worker import gang_slice as jax_gang_slice
from dmlc_tpu_torch import native
from dmlc_tpu_torch.cluster.rpc import DecodeError, RpcError
from dmlc_tpu_torch.ops import preprocess as tpp
from dmlc_tpu_torch.scheduler.worker import EngineBackend, PredictWorker, gang_slice
from dmlc_tpu_torch.utils import corpus

N_CLASSES_CORPUS = 12


class SeededTier:
    """A decode tier whose pixels are seeded from each path's name."""

    def __init__(self):
        self.calls = 0

    def decode_paths(self, paths, size):
        self.calls += 1
        return seeded_pixels(paths, size)


@pytest.fixture(scope="module")
def jpeg_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_corpus")
    data_dir, synset_path = corpus.generate(
        root, n_classes=N_CLASSES_CORPUS, images_per_class=1, size=48, seed=3
    )
    return data_dir, [s for s, _ in tpp.load_synset_words(synset_path)]


@pytest.fixture(params=["native", "pil"])
def decode_backend(request, monkeypatch):
    """Both packages' "auto" decode held to one backend: the native
    libraries (built for the run), or PIL with both reported unbuilt."""
    if request.param == "native":
        if not jax_native.ensure_built():
            pytest.skip("the JAX package's native decoder is not built (g++ or libjpeg missing)")
        assert native.ensure_built(), "the port's native decoder failed to build"
    else:
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


def _workers(data_dir, image_source=None):
    variables = tiny_variables(4)
    port = EngineBackend("tinynet", data_dir, batch_size=BATCH, variables=variables,
                         dtype=torch.float32, device="cpu", image_source=image_source)
    ref = JaxBackend("tinynet", data_dir, batch_size=BATCH, dtype=jnp.float32,
                     variables=jax.tree_util.tree_map(jnp.asarray, variables),
                     image_source=image_source)
    return (PredictWorker({"tinynet": port}), port), (JaxWorker({"tinynet": ref}), ref)


def test_predict_on_jpeg_corpus_matches_jax(jpeg_corpus, decode_backend):
    data_dir, synsets = jpeg_corpus
    (worker, _), (ref, _) = _workers(data_dir)
    for shard in (synsets[:BATCH], synsets[:5]):  # one full batch, one padded
        req = {"model": "tinynet", "synsets": shard}
        got = worker.methods()["job.predict"](req)
        want = ref.methods()["job.predict"](req)
        assert len(got["predictions"]) == len(shard)
        assert got == want


def test_multi_batch_predict_goes_through_decode_tier(tmp_path):
    names = [f"syn_{i}" for i in range(2 * BATCH + 5)]
    (worker, port), (ref, jax_backend) = _workers(tmp_path, image_source=lambda s: list(s))
    port.decode_tier, jax_backend.decode_tier = SeededTier(), SeededTier()
    req = {"model": "tinynet", "synsets": names}
    got = worker.methods()["job.predict"](req)
    assert got == ref.methods()["job.predict"](req)
    assert len(got["predictions"]) == len(names)
    assert port.decode_tier.calls == 3  # three batches, all from the tier


def test_decode_matches_jax(jpeg_corpus, decode_backend):
    data_dir, synsets = jpeg_corpus
    blobs = [tpp.class_image_path(data_dir, s).read_bytes() for s in synsets[:4]]
    req = {"blobs": blobs, "size": SIZE}
    got = PredictWorker({}).methods()["job.decode"](req)
    want = JaxWorker({}).methods()["job.decode"](req)
    assert got == want and got["n"] == 4
    with pytest.raises(DecodeError, match="indices \\[1\\]"):
        PredictWorker({}).methods()["job.decode"]({"blobs": [blobs[0], b"junk"], "size": SIZE})


def test_load_variables_through_backend(jpeg_corpus, decode_backend):
    data_dir, synsets = jpeg_corpus
    (worker, port), (ref, jax_backend) = _workers(data_dir)
    new = tiny_variables(9)
    port.load_variables(new)
    jax_backend.load_variables(jax.tree_util.tree_map(jnp.asarray, new))
    req = {"model": "tinynet", "synsets": synsets[:BATCH]}
    assert worker.methods()["job.predict"](req) == ref.methods()["job.predict"](req)


def test_unknown_model_and_bad_backend_raise(tmp_path):
    worker = PredictWorker({"short": lambda s: [0] * (len(s) - 1)})
    with pytest.raises(RpcError, match="not loaded"):
        worker.methods()["job.predict"]({"model": "nope", "synsets": ["a"]})
    with pytest.raises(RpcError, match="returned"):
        worker.methods()["job.predict"]({"model": "short", "synsets": ["a", "b"]})


@pytest.mark.parametrize("n,world", [(0, 3), (7, 3), (8, 4), (5, 8)])
def test_gang_slice_matches_jax(n, world):
    for rank in range(world):
        assert gang_slice(n, rank, world) == jax_gang_slice(n, rank, world)


def test_decode_lanes_idle_gauge():
    worker = PredictWorker({}, decode_lanes=3)
    assert worker.decode_lane_idle() == 3
    blob = np.zeros(1, np.uint8).tobytes()
    with pytest.raises(DecodeError):
        worker.methods()["job.decode"]({"blobs": [blob], "size": 4})
    assert worker.decode_lane_idle() == 3
