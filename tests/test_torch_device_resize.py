"""Every case of tests/test_device_resize.py, run against both packages (the
``pkg`` fixture; the port's engine on the CPU): row-stochastic weights,
the resize against the numpy reference and PIL, and the engine's
raw-staging mode. Beside them, the port's ``resize_batch`` against the JAX
package's on the same pixels (within ``RESIZE_ATOL`` grey levels), and an
``EngineBackend(device_resize_from=...)`` of each package over one JPEG
corpus with the same weights giving the same top-1 answers.

The names imported below are the JAX package's; ``sided`` rebinds each to
the object of the same name in the package under test, for each case.
"""

import numpy as np
import pytest
import torch
from torch_sides import JAX, PORT, bind_sides, pkg  # noqa: F401  (pkg: fixture)

from dmlc_tpu.ops import device_resize
from tiny_model import N_CLASSES  # registers tinynet

sided = bind_sides(globals(), {
    "device_resize": None,
})


def smooth_images(n, size, seed=0):
    """Low-frequency uint8 fields — photograph-like, so resample parity is
    meaningful (pure noise makes every resampler disagree at the tolerance)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        base = rng.integers(0, 256, (size // 8, size // 8, 3), np.uint8)
        out.append(np.asarray(Image.fromarray(base).resize((size, size), Image.BILINEAR)))
    return np.stack(out)


def test_weights_are_row_stochastic():
    for in_size, out_size in ((256, 224), (64, 224), (224, 224), (17, 5)):
        w = device_resize.triangle_weights(in_size, out_size)
        assert w.shape == (out_size, in_size)
        np.testing.assert_allclose(w.sum(axis=1), 1.0, rtol=1e-6)
        # A flat image stays flat through any row-stochastic resample.
        flat = np.full((1, in_size, in_size, 3), 137, np.uint8)
        res = np.asarray(device_resize.resize_batch(flat, out_size))
        np.testing.assert_allclose(res, 137.0, atol=1e-3)


def test_jax_matches_numpy_reference():
    imgs = smooth_images(2, 64)
    got = np.asarray(device_resize.resize_batch(imgs, 48))
    want = device_resize.reference_resize(imgs, 48)
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_close_to_pil_bilinear():
    from PIL import Image

    imgs = smooth_images(3, 256, seed=1)
    got = np.asarray(device_resize.resize_batch(imgs, 224))
    pil = np.stack(
        [
            np.asarray(Image.fromarray(im).resize((224, 224), Image.BILINEAR))
            for im in imgs
        ]
    ).astype(np.float32)
    # Same triangle-filter family; implementations differ in fixed-point
    # detail. Mean within a fraction of a grey level, max within a few.
    assert np.mean(np.abs(got - pil)) < 0.6
    assert np.max(np.abs(got - pil)) < 6.0


def test_engine_raw_staging_mode(pkg):
    """device_resize_from: the engine stages RAW pixels and resizes on
    device; predictions track the host-resized path."""
    if pkg.name == "port":
        import test_torch_engine  # noqa: F401  (registers the port's "tinynet")
        from dmlc_tpu_torch.parallel.inference import InferenceEngine as Engine

        def InferenceEngine(*a, **kw):  # noqa: N802  (the reference's name)
            return Engine(*a, device="cpu", **kw)
    else:
        from dmlc_tpu.parallel.inference import InferenceEngine

    raw = smooth_images(8, 48, seed=2)
    host = InferenceEngine("tinynet", batch_size=8, seed=7)
    dev = InferenceEngine("tinynet", batch_size=8, seed=7, device_resize_from=48)
    assert dev.input_size == 48 and host.input_size == 32

    host_in = np.asarray(device_resize.resize_batch(raw, 32)).round().clip(0, 255).astype(np.uint8)
    want = host.run_batch(host_in)
    got = dev.run_batch(raw)
    # Same weights (same seed); inputs differ only by u8 rounding of the
    # staged pixels, so top-1 agreement should be essentially total.
    agree = np.mean(got.top1_index == want.top1_index)
    assert agree >= 0.9, agree
    np.testing.assert_allclose(got.top1_prob, want.top1_prob, atol=0.05)


#: Both packages resample in float32 with the same weights; they differ
#: only in summation order, far below one grey level.
RESIZE_ATOL = 1e-3


@pytest.mark.parametrize("shape", [(2, 64, 64, 48), (3, 256, 256, 224), (1, 17, 40, 32)])
def test_port_resize_matches_jax(shape):
    n, h, w, out = shape
    rng = np.random.default_rng(h + w)
    imgs = rng.integers(0, 256, (n, h, w, 3), np.uint8)
    want = np.asarray(JAX.device_resize.resize_batch(imgs, out))
    got = PORT.device_resize.resize_batch(torch.from_numpy(imgs), out)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, out, out, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_ATOL, rtol=0)


def test_engine_backend_device_resize_top1_matches_jax(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    from test_torch_engine import tiny_variables

    from dmlc_tpu import native as jax_native
    from dmlc_tpu_torch import native as port_native
    from dmlc_tpu_torch.utils import corpus

    # Both sides decode through PIL so the raw pixels are the same.
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(port_native, "available", lambda: False)
    data_dir, synset_path = corpus.generate(
        tmp_path, n_classes=12, images_per_class=1, size=48, seed=3
    )
    synsets = [s for s, _ in PORT.preprocess.load_synset_words(synset_path)]
    variables = tiny_variables(4)
    port = PORT.worker.EngineBackend(
        "tinynet", data_dir, batch_size=8, variables=variables, dtype=torch.float32,
        device="cpu", device_resize_from=48,
    )
    ref = JAX.worker.EngineBackend(
        "tinynet", data_dir, batch_size=8, dtype=jnp.float32, device_resize_from=48,
        variables=jax.tree_util.tree_map(jnp.asarray, variables),
    )
    got, want = port(synsets), ref(synsets)
    assert port.engine.input_size == 48
    assert len(got) == len(synsets)
    assert list(got) == list(want)
