"""The port's native JPEG decoder (dmlc_tpu_torch/native) and the three
decode backends of its ops/preprocess.py against the JAX package's: the same
C++ source built with the same flags on this machine must give the same
pixels and the same status, and load_batch, load_batch_into and
decode_blobs must give the same arrays under "auto", "native" and "pil",
the fallbacks of "auto" included. (-march=native makes no promise across
machines, so pixels are compared only within one.)"""

import io
import os
import threading
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from dmlc_tpu import native as jax_native
from dmlc_tpu.ops import preprocess as jpp
from dmlc_tpu_torch import native
from dmlc_tpu_torch.ops import preprocess as tpp
from dmlc_tpu_torch.utils import corpus

REPO = Path(__file__).resolve().parent.parent
PHOTOS = sorted((Path(__file__).parent / "fixtures" / "photos").glob("*.jpg"))
BACKENDS = ("auto", "native", "pil")


@pytest.fixture(scope="module")
def built():
    if not jax_native.ensure_built():
        pytest.skip("the JAX package's native decoder is not built (g++ or libjpeg missing)")
    assert native.ensure_built(), "the port's native decoder failed to build"


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory, built):
    """A corpus of generated JPEGs plus the committed photographs."""
    root = tmp_path_factory.mktemp("native_corpus")
    data_dir, _ = corpus.generate(root, n_classes=10, images_per_class=2, size=96, seed=4)
    return sorted(p for p in data_dir.rglob("*.jpg")) + PHOTOS


@pytest.fixture(scope="module")
def odd_files(tmp_path_factory):
    """A truncated JPEG, a PNG and a path that does not exist."""
    root = tmp_path_factory.mktemp("native_odd")
    truncated = root / "truncated.jpg"
    raw = PHOTOS[0].read_bytes()
    truncated.write_bytes(raw[: len(raw) // 3])
    png = root / "img.png"
    rng = np.random.default_rng(2)
    Image.fromarray(rng.integers(0, 256, (40, 52, 3), np.uint8)).save(png)
    return {"truncated": truncated, "png": png, "missing": root / "missing.jpg"}


@pytest.mark.parametrize("size", [224, 48, 37])
def test_decode_resize_batch_equals_the_jax_package(jpegs, odd_files, size):
    paths = jpegs + list(odd_files.values())
    got, got_status = native.decode_resize_batch(paths, size)
    want, want_status = jax_native.decode_resize_batch(paths, size)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_status, want_status)
    # libjpeg decodes what it has of the truncated file; the PNG and the
    # missing path are refused, and a refused slot is zeros.
    assert not got_status[: len(jpegs)].any() and got_status[-2:].all()
    assert not got[-2:].any()
    out = np.full_like(got, 255)
    assert native.decode_resize_batch(paths, size, workers=3, out=out)[0] is out
    np.testing.assert_array_equal(out, want)
    assert native.pool_size() >= 3


def test_decode_resize_batch_checks_its_arena(built):
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        native.decode_resize_batch(PHOTOS, 32, out=np.zeros((4, 32, 32, 3), np.float32))
    out, status = native.decode_resize_batch([], 32)
    assert out.shape == (0, 32, 32, 3) and status.shape == (0,)


def test_native_is_within_jpeg_noise_of_pil(built):
    """The committed photographs at the serving size: the bound the JAX
    package states for its fixture corpus (dmlc_tpu/ops/preprocess.py,
    mean |diff| < 0.5/255)."""
    a = tpp.load_batch(PHOTOS, size=224, backend="native").astype(np.int16)
    b = tpp.load_batch(PHOTOS, size=224, backend="pil").astype(np.int16)
    assert np.abs(a - b).mean() < 0.5


@pytest.mark.parametrize("backend", BACKENDS)
def test_load_batch_equals_the_jax_package(jpegs, backend):
    got = tpp.load_batch(jpegs, size=56, backend=backend)
    np.testing.assert_array_equal(got, jpp.load_batch(jpegs, size=56, backend=backend))
    out = np.zeros((len(jpegs), 56, 56, 3), np.uint8)
    assert tpp.load_batch_into(out, jpegs, size=56, workers=2, backend=backend) is out
    np.testing.assert_array_equal(out, got)
    one = tpp.load_batch(jpegs[:1], size=56, workers=1, backend=backend)
    np.testing.assert_array_equal(one, jpp.load_batch(jpegs[:1], size=56, workers=1,
                                                      backend=backend))


@pytest.mark.parametrize("backend", BACKENDS)
def test_load_batch_with_a_png_equals_the_jax_package(jpegs, odd_files, backend):
    """A PNG in the batch: "auto" redoes the whole batch through PIL,
    "native" refuses it, "pil" decodes it; as the JAX package does."""
    paths = jpegs[:5] + [odd_files["png"]]
    if backend == "native":
        for pp in (tpp, jpp):
            with pytest.raises(ValueError, match="native decode failed for .*img.png"):
                pp.load_batch(paths, size=40, backend=backend)
        return
    got = tpp.load_batch(paths, size=40, backend=backend)
    np.testing.assert_array_equal(got, jpp.load_batch(paths, size=40, backend=backend))
    np.testing.assert_array_equal(got, tpp.load_batch(paths, size=40, backend="pil"))
    assert got[-1].any()


def _blobs(jpegs, odd_files) -> list[bytes]:
    buf = io.BytesIO()
    Image.open(odd_files["png"]).save(buf, format="PNG")
    return ([p.read_bytes() for p in jpegs[:4]] + [buf.getvalue(), b"poison",
            odd_files["truncated"].read_bytes()] + [PHOTOS[1].read_bytes()])


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_blobs_equals_the_jax_package(jpegs, odd_files, backend):
    """Blobs with a PNG, a poison blob and a truncated JPEG: the native
    path redoes only the refused slots through PIL, which has the last word
    on the poison; the statuses and pixels are the JAX package's."""
    blobs = _blobs(jpegs, odd_files)
    got, got_status = tpp.decode_blobs(blobs, size=44, backend=backend)
    want, want_status = jpp.decode_blobs(blobs, size=44, backend=backend)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_status, want_status)
    assert got_status.tolist() == [0, 0, 0, 0, 0, 1, want_status[6], 0]
    assert not got[5].any() and got[4].any()
    if backend != "pil":  # the JPEGs came through the native decoder
        np.testing.assert_array_equal(got[:4], native.decode_resize_batch(jpegs[:4], 44)[0])


@pytest.mark.parametrize("call", ["load_batch", "decode_blobs"])
def test_without_the_library_native_raises_and_auto_is_pil(jpegs, odd_files, monkeypatch,
                                                          call):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", True)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    assert not native.available()
    if call == "load_batch":
        args = (jpegs[:6],)
    else:
        args = (_blobs(jpegs, odd_files),)
    fn_port, fn_jax = getattr(tpp, call), getattr(jpp, call)
    for fn in (fn_port, fn_jax):
        with pytest.raises(RuntimeError, match="native image pipeline not built"):
            fn(*args, size=32, backend="native")
    got = fn_port(*args, size=32, backend="auto")
    pil = fn_port(*args, size=32, backend="pil")
    want = fn_jax(*args, size=32, backend="auto")
    for a, b in ((got, pil), (got, want)):
        for x, y in zip(*(v if isinstance(v, tuple) else (v,) for v in (a, b))):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("call", ["load_batch", "decode_blobs"])
def test_unknown_backend_is_refused(call):
    with pytest.raises(ValueError, match="unknown backend 'cuda'"):
        getattr(tpp, call)([b"x"], backend="cuda")


def _tree(root: Path) -> dict:
    return {p: p.stat().st_mtime_ns for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts and "_build" not in p.parts}


def test_build_writes_only_under_the_port_build_dir(built):
    """Two builds at once (as two test workers may run them): both succeed,
    the library loads, nothing beside either package's decoder source
    changes, and no temporary file is left."""
    roots = [REPO / "native", REPO / "dmlc_tpu" / "native", REPO / "dmlc_tpu_torch" / "native"]
    before = [_tree(r) for r in roots]
    lib_before = native._LIB_PATH.stat().st_mtime_ns
    errors = []

    def run():
        try:
            native.build()
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert [_tree(r) for r in roots] == before
    assert native._LIB_PATH == REPO / "dmlc_tpu_torch" / "_build" / "libdmlc_native.so"
    assert native._LIB_PATH.stat().st_mtime_ns >= lib_before
    assert not list(native._LIB_PATH.parent.glob(f".libdmlc_native.so.{os.getpid()}.*"))
    assert native.available() and not native._stale()
