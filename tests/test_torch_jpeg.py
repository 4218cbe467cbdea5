"""The port's JPEG decoder for the card's machine: the host entropy decoder
(dmlc_tpu_torch/native/jpeg_entropy.cpp, no libjpeg) and the device stage
(ops/jpeg.py, whose plain version runs here on the CPU).

- Coefficients: the entropy decoder's quantized DCT coefficients and
  quantization tables equal libjpeg's ``jpeg_read_coefficients`` exactly,
  on the committed photos and on JPEGs PIL makes from seeded pixels
  (4:4:4, 4:2:2, 4:2:0, grayscale, odd sizes, restart markers, qualities
  50 and 95, 16-bit tables). A helper compiled against ``-ljpeg`` here
  reads libjpeg's; the tests skip where libjpeg is absent.
- Pixels: ``load_batch_device(..., device="cpu")`` against the JAX
  package's ``decode_resize_batch`` (libjpeg) and its PIL ``load_batch``,
  within the bounds the JAX package's own test holds libjpeg to against PIL
  (tests/test_real_jpeg_fixture.py): mean |diff| < 1.0, 99th percentile
  <= 10, max <= 32 uint8 steps; and the scale M of every image equal to
  the reference's rule.
- The plain IDCT at M = 8 against a float64 oracle; refusals (progressive,
  PNG, CMYK, truncated, bit-flipped) that never crash and whose rows are
  PIL's; no fallback from a CUDA request; a build that links no libjpeg.
"""

import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from dmlc_tpu import native as jax_native
from dmlc_tpu.ops import preprocess as jpp
from dmlc_tpu_torch.native import jpeg as nj
from dmlc_tpu_torch.ops import jpeg as jo
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.ops import preprocess as tpp

PHOTOS = sorted((Path(__file__).parent / "fixtures" / "photos").glob("*.jpg"))

_COEF_DUMP = r"""
#include <stdio.h>
#include <jpeglib.h>
/* argv[1]: a JPEG; argv[2]: out. Per component: width and height in
   blocks, then the quantization table (natural order, uint16) and the
   blocks' coefficients (int16, natural order, row by row). */
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  FILE* o = fopen(argv[2], "wb");
  struct jpeg_decompress_struct d;
  struct jpeg_error_mgr e;
  if (!f || !o) return 2;
  d.err = jpeg_std_error(&e);
  jpeg_create_decompress(&d);
  jpeg_stdio_src(&d, f);
  jpeg_read_header(&d, TRUE);
  jvirt_barray_ptr* arr = jpeg_read_coefficients(&d);
  int nc = d.num_components;
  fwrite(&nc, 4, 1, o);
  for (int c = 0; c < nc; ++c) {
    jpeg_component_info* ci = &d.comp_info[c];
    int g[2] = {(int)ci->width_in_blocks, (int)ci->height_in_blocks};
    unsigned short q[64];
    fwrite(g, 4, 2, o);
    for (int k = 0; k < 64; ++k) q[k] = ci->quant_table->quantval[k];
    fwrite(q, 2, 64, o);
    for (JDIMENSION r = 0; r < ci->height_in_blocks; ++r) {
      JBLOCKARRAY row = (*d.mem->access_virt_barray)((j_common_ptr)&d, arr[c], r, 1, FALSE);
      fwrite(row[0], sizeof(JCOEF) * 64, ci->width_in_blocks, o);
    }
  }
  jpeg_finish_decompress(&d);
  jpeg_destroy_decompress(&d);
  fclose(f);
  fclose(o);
  return 0;
}
"""


def _smooth(rng: np.random.Generator, h: int, w: int, coarse: int = 8, gray: bool = False):
    """A seeded smooth field (coarse noise upsampled bilinearly): photo-like
    JPEG statistics."""
    base = rng.integers(0, 256, (max(2, h // coarse), max(2, w // coarse), 3), np.uint8)
    img = Image.fromarray(base).resize((w, h), Image.BILINEAR)
    return img.convert("L") if gray else img


#: name -> (height, width, save options, grayscale)
MADE = {
    "s444_q50": (64, 48, dict(quality=50, subsampling=0), False),
    "s444_q95": (64, 48, dict(quality=95, subsampling=0), False),
    "s422_q50": (64, 48, dict(quality=50, subsampling=1), False),
    "s422_q95": (64, 48, dict(quality=95, subsampling=1), False),
    "s420_q50": (64, 48, dict(quality=50, subsampling=2), False),
    "s420_q95": (64, 48, dict(quality=95, subsampling=2), False),
    "gray": (61, 75, dict(quality=90), True),
    "odd_131x97_s420": (97, 131, dict(quality=90, subsampling=2), False),
    "odd_131x97_s422": (97, 131, dict(quality=75, subsampling=1), False),
    "restart_blocks4": (97, 131, dict(quality=90, restart_marker_blocks=4), False),
    "restart_rows1": (70, 45, dict(quality=80, restart_marker_rows=1), False),
    "restart_gray": (50, 83, dict(quality=85, restart_marker_blocks=3), True),
    "tables16": (40, 56, dict(qtables=[[300] * 64, [400] * 64]), False),
    "optimized": (48, 80, dict(quality=70, optimize=True), False),
}


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpeg_made")
    rng = np.random.default_rng(30)
    out = {}
    for name, (h, w, opts, gray) in MADE.items():
        p = root / f"{name}.jpg"
        _smooth(rng, h, w, gray=gray).save(p, "JPEG", **opts)
        out[name] = p
    return out


@pytest.fixture(scope="module")
def coef_dump(tmp_path_factory):
    if shutil.which("gcc") is None:
        pytest.skip("no gcc")
    root = tmp_path_factory.mktemp("coef_dump")
    (root / "dump.c").write_text(_COEF_DUMP)
    done = subprocess.run(["gcc", "-O1", str(root / "dump.c"), "-o", str(root / "dump"), "-ljpeg"],
                          capture_output=True, text=True)
    if done.returncode:
        pytest.skip(f"libjpeg is not available here: {done.stderr.strip()[:200]}")
    return root / "dump"


def _libjpeg_coefficients(dump: Path, path: Path, tmp: Path):
    out = tmp / f"{path.stem}.bin"
    subprocess.run([str(dump), str(path), str(out)], check=True, timeout=60)
    raw = out.read_bytes()
    nc = int(np.frombuffer(raw, np.int32, 1, 0)[0])
    pos, comps = 4, []
    for _ in range(nc):
        wb, hb = (int(v) for v in np.frombuffer(raw, np.int32, 2, pos))
        pos += 8
        q = np.frombuffer(raw, np.uint16, 64, pos).astype(np.int32)
        pos += 128
        blocks = np.frombuffer(raw, np.int16, wb * hb * 64, pos).reshape(hb, wb, 64)
        pos += wb * hb * 128
        comps.append((q, blocks))
    return comps


def _decode(srcs, size=224, arena=None):
    return nj.decode(srcs, size, arena or nj.JpegArena())


@pytest.mark.parametrize("case", [p.name for p in PHOTOS] + list(MADE))
def test_coefficients_equal_libjpeg(case, made, coef_dump, tmp_path):
    path = made[case] if case in made else next(p for p in PHOTOS if p.name == case)
    want = _libjpeg_coefficients(coef_dump, path, tmp_path)
    co = _decode([path])
    assert int(co.status[0]) == 0, nj.STATUS[int(co.status[0])]
    assert int(co.images[0, 3]) == len(want)
    coef = co.region("coef", torch.int16, co.total_blocks * 64).numpy()
    qt = co.region("qt", torch.int32, nj.MAX_COMPS * 64).numpy().reshape(nj.MAX_COMPS, 64)
    for c, (q, blocks) in enumerate(want):
        rec = dict(zip(nj.COMP_FIELDS, co.comps[c]))
        got = coef[rec["block_off"] * 64:(rec["block_off"] + rec["bw"] * rec["bh"]) * 64]
        got = got.reshape(rec["bh"], rec["bw"], 64)
        hb, wb = blocks.shape[:2]
        assert rec["bh"] >= hb and rec["bw"] >= wb
        np.testing.assert_array_equal(got[:hb, :wb], blocks, err_msg=f"component {c}")
        np.testing.assert_array_equal(qt[c], q, err_msg=f"table of component {c}")


def test_bytes_and_paths_decode_alike(made):
    paths = list(made.values()) + PHOTOS
    a = _decode(paths)
    b = _decode([p.read_bytes() for p in paths])
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.comps, b.comps)
    assert a.nbytes == b.nbytes
    np.testing.assert_array_equal(a.data[:a.nbytes].numpy(), b.data[:b.nbytes].numpy())


def _reference_scale(w: int, h: int, size: int) -> int:
    """native/image_pipeline.cpp decode_jpeg's choice of M, in Python."""
    for m in range(1, 9):
        if (w * m + 7) // 8 >= size and (h * m + 7) // 8 >= size:
            return m
    return 8


@pytest.mark.parametrize("size", [224, 96, 37, 500])
def test_scale_follows_the_reference_rule(made, size):
    paths = list(made.values()) + PHOTOS
    co = _decode(paths, size)
    for rec, p in zip(co.images, paths):
        w, h = Image.open(p).size
        assert (int(rec[1]), int(rec[2])) == (w, h)
        m = _reference_scale(w, h, size)
        assert int(rec[4]) == m, p.name
        assert (int(rec[5]), int(rec[6])) == (math.ceil(w * m / 8), math.ceil(h * m / 8))


@pytest.fixture(scope="module")
def smooth_photos(tmp_path_factory):
    """Photograph-like JPEGs PIL makes from seeded pixels, at the sizes a
    serving corpus holds, in each chroma subsampling."""
    root = tmp_path_factory.mktemp("jpeg_smooth")
    rng = np.random.default_rng(31)
    out = []
    for k, (h, w, sub) in enumerate([(256, 256, 2), (480, 640, 2), (300, 400, 1), (256, 320, 0),
                                     (231, 250, 2)]):
        p = root / f"smooth{k}.jpg"
        _smooth(rng, h, w, coarse=32).save(p, "JPEG", quality=90, subsampling=sub)
        out.append(p)
    return out


def _assert_within_bounds(got: np.ndarray, want: np.ndarray, what: str) -> None:
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert float(diff.mean()) < 1.0, f"{what}: mean |diff| {diff.mean():.3f}"
    assert float(np.quantile(diff, 0.99)) <= 10.0, f"{what}: p99 {np.quantile(diff, 0.99)}"
    assert int(diff.max()) <= 32, f"{what}: max {diff.max()}"


@pytest.mark.parametrize("size", [224, 96])
@pytest.mark.parametrize("corpus", ["photos", "smooth"])
def test_pixels_match_the_jax_package(size, corpus, smooth_photos):
    paths = PHOTOS if corpus == "photos" else smooth_photos
    got, status = tpp.load_batch_device(paths, size, "cpu")
    assert not status.any()
    assert got.dtype == torch.uint8 and tuple(got.shape) == (len(paths), size, size, 3)
    got = got.numpy()
    pil = jpp.load_batch(paths, size=size, backend="pil")
    _assert_within_bounds(got, pil, "against PIL")
    if not jax_native.ensure_built():
        pytest.skip("the JAX package's native decoder is not built (g++ or libjpeg missing)")
    ref, ref_status = jax_native.decode_resize_batch(paths, size)
    assert not ref_status.any()
    _assert_within_bounds(got, ref, "against decode_resize_batch")
    assert got.std() > 10  # not equal because blank


@pytest.mark.parametrize("photo", [p.name for p in PHOTOS])
def test_plain_idct_matches_a_float64_oracle(photo):
    """Every block of a photo's every component at M = 8."""
    co = _decode([next(p for p in PHOTOS if p.name == photo)])
    coef_all = co.region("coef", torch.int16, co.total_blocks * 64).numpy()
    qt = co.region("qt", torch.int32, nj.MAX_COMPS * 64).numpy().reshape(nj.MAX_COMPS, 64)
    basis = torch.from_numpy(nj.idct_basis())
    for c in range(int(co.images[0, 3])):
        rec = dict(zip(nj.COMP_FIELDS, co.comps[c]))
        coef = coef_all[rec["block_off"] * 64:(rec["block_off"] + rec["bw"] * rec["bh"]) * 64]
        coef = coef.reshape(-1, 64)
        _check_idct(coef, qt[c], basis)


def _check_idct(coef: np.ndarray, q: np.ndarray, basis: torch.Tensor) -> None:
    got = jo.idct_blocks(torch.from_numpy(coef), torch.from_numpy(q), 8, basis).numpy()
    f = (coef.astype(np.float64) * q).reshape(-1, 8, 8)
    x = np.arange(8)
    c = np.where(np.arange(8) == 0, 1 / math.sqrt(2), 1.0)
    cos = np.cos((2 * x[:, None] + 1) * np.arange(8)[None, :] * np.pi / 16) * c[None, :]
    want = 0.25 * np.einsum("yv,nvu,xu->nyx", cos, f, cos)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_points", [1, 2, 4, 7])
def test_scaled_idct_keeps_the_dc_and_the_basis_is_orthogonal(n_points):
    """An N-point IDCT of a DC-only block is flat at DC / 8 (libjpeg's
    scaling), and its basis rows are orthogonal with equal norms."""
    basis = torch.from_numpy(nj.idct_basis())
    coef = torch.zeros(1, 64, dtype=torch.int16)
    coef[0, 0] = 96
    out = jo.idct_blocks(coef, torch.ones(64, dtype=torch.int32), n_points, basis)
    np.testing.assert_allclose(out.numpy(), 12.0, atol=1e-5)
    b = nj.idct_basis()[n_points - 1, :n_points, :n_points].astype(np.float64)
    gram = b.T @ b
    np.testing.assert_allclose(gram, np.eye(n_points) * gram[0, 0], atol=1e-6)


def test_resample_taps_are_the_reference_weights():
    from dmlc_tpu_torch.ops.device_resize import triangle_weights

    for src, dst in ((256, 224), (240, 224), (112, 224), (225, 224), (224, 224), (1000, 37)):
        idx, w = jo.resample_taps(src, dst)
        dense = np.zeros((dst, src), np.float64)
        for o in range(dst):
            np.add.at(dense[o], idx[o], w[o])
        np.testing.assert_allclose(dense, triangle_weights(src, dst), rtol=0, atol=2e-7)


def test_identity_resample_is_exact():
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.integers(0, 256, (37, 41, 3)).astype(np.float32))
    np.testing.assert_array_equal(jo.resample(x, 37, 41).numpy(), x.numpy())


def _refusals(tmp: Path) -> dict:
    rng = np.random.default_rng(34)
    img = _smooth(rng, 48, 64)
    out = {}
    for name, save in (("progressive", dict(format="JPEG", progressive=True)),
                       ("png", dict(format="PNG"))):
        p = tmp / f"{name}.img"
        img.save(p, **save)
        out[name] = p
    p = tmp / "cmyk.jpg"
    img.convert("CMYK").save(p, "JPEG")
    out["cmyk"] = p
    return out


def test_refused_images_are_decoded_by_pil_and_counted(tmp_path, made):
    odd = _refusals(tmp_path)
    paths = [made["s420_q95"], odd["progressive"], made["gray"], odd["png"], odd["cmyk"]]
    before = tpp.jpeg_refused_images
    got, status = tpp.load_batch_device(paths, 40, "cpu")
    assert [nj.STATUS[int(s)] for s in status] == ["ok", "progressive", "ok", "not_jpeg",
                                                   "color_space"]
    assert tpp.jpeg_refused_images - before == 3
    for i in (1, 3, 4):
        np.testing.assert_array_equal(got[i].numpy(), tpp.decode_resize(paths[i], 40))
    alone, _ = tpp.load_batch_device([paths[0], paths[2]], 40, "cpu")
    np.testing.assert_array_equal(got[[0, 2]].numpy(), alone.numpy())


def test_missing_file_is_refused_and_raises_like_pil(tmp_path):
    co = _decode([tmp_path / "missing.jpg"])
    assert nj.STATUS[int(co.status[0])] == "read_failed"
    with pytest.raises(FileNotFoundError):
        tpp.load_batch_device([tmp_path / "missing.jpg"], 32, "cpu")


def test_truncated_inside_the_scan_is_refused():
    raw = PHOTOS[0].read_bytes()
    srcs = [raw[:n] for n in (0, 1, 2, 3, 100, 600, len(raw) // 2, len(raw) - 16)]
    co = _decode(srcs, 64)
    assert all(int(s) != 0 for s in co.status), [nj.STATUS[int(s)] for s in co.status]


def _with_dht(raw: bytes, counts: dict[int, int]) -> bytes:
    """``raw`` with one DC table (class 0, id 0) inserted after SOI whose
    code-length counts are ``counts`` ({length: count}, lengths 1-16)."""
    lengths = bytes(counts.get(n, 0) for n in range(1, 17))
    body = bytes([0x00]) + lengths + bytes(range(sum(lengths)))
    return raw[:2] + b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big") + body + raw[2:]


@pytest.mark.parametrize("counts", [
    {1: 3},                  # over-full at length 1
    {1: 255},                # over-full at length 1 by most of the lookup table
    {1: 1, 2: 1, 9: 200},    # over-full at length 9, the last length the lookup holds
    {1: 2},                  # an all-ones code
    {**{n: 1 for n in range(1, 12)}, 12: 3},  # over-full past the lookup's lengths
], ids=["len1", "len1_255", "len9", "all_ones", "len12"])
def test_overfull_huffman_table_is_refused(counts):
    co = _decode([_with_dht(PHOTOS[0].read_bytes(), counts)] * 4, 48)
    assert [nj.STATUS[int(s)] for s in co.status] == ["corrupt"] * 4


def _pil_or_error(data: bytes, size: int):
    try:
        return tpp.decode_blob(data, size), None
    except Exception as e:  # PIL refuses it too
        return None, e


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(cut=st.integers(0, 10_000), flip=st.integers(0, 10_000), bit=st.integers(0, 7))
def test_damaged_jpegs_never_crash(cut, flip, bit):
    """A fixture cut anywhere inside its scan, or with one bit flipped
    anywhere: the decoder answers a status (nonzero for the cut), never
    crashes, and a refused image's row is PIL's where PIL decodes it."""
    raw = bytearray(PHOTOS[1].read_bytes())
    truncated = bytes(raw[:cut % (len(raw) - 16)])
    pos = flip % len(raw)
    raw[pos] ^= 1 << bit
    flipped = bytes(raw)
    co = _decode([truncated, flipped], 48)
    assert int(co.status[0]) != 0
    assert int(co.status[1]) in nj.STATUS
    if co.status[1] == 0:
        out = jo.jpeg_idct_reference(co)
        assert tuple(out[1].shape) == (48, 48, 3)
    else:
        want, error = _pil_or_error(flipped, 48)
        if error is None:
            before = tpp.jpeg_refused_images
            got, _ = tpp.load_batch_device([flipped], 48, "cpu")
            np.testing.assert_array_equal(got[0].numpy(), want)
            assert tpp.jpeg_refused_images == before + 1
        else:
            with pytest.raises(type(error)):
                tpp.load_batch_device([flipped], 48, "cpu")


def test_a_cuda_request_raises_without_the_kernel_and_never_decodes_on_the_cpu(monkeypatch):
    from dmlc_tpu_torch.ops import _build

    def no_build(name):
        raise RuntimeError(f"no kernel library for {name}")

    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran for a CUDA request")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.delitem(kernels._ENTRIES, "jpeg_idct", raising=False)
    monkeypatch.setattr(jo, "jpeg_idct_reference", no_plain)
    monkeypatch.setattr("dmlc_tpu_torch.utils.device.resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="no kernel library for jpeg_idct"):
        tpp.load_batch_device(PHOTOS, 224, "cuda")


def test_the_build_links_no_libjpeg():
    cmd = nj.build_command()
    assert cmd[0] == "g++" and str(nj._SRC) in cmd
    assert not any("jpeg" in a for a in cmd if a.startswith("-l"))
    nj.load()
    if shutil.which("ldd"):
        linked = subprocess.run(["ldd", str(nj._LIB_PATH)], capture_output=True, text=True).stdout
        assert "libjpeg" not in linked
    assert "jpeglib.h" not in nj._SRC.read_text()


def test_arena_is_reused_and_grows(made):
    arena = nj.JpegArena()
    small = _decode([made["s420_q50"]], 32, arena)
    first = arena.tensor.data_ptr()
    _decode([made["gray"]], 32, arena)
    assert arena.tensor.data_ptr() == first
    big = _decode(PHOTOS * 8, 224, arena)
    assert arena.tensor.numel() >= big.nbytes > small.nbytes
    basis = arena.tensor[nj.layout(0)["basis"]:][:2048].view(torch.float32).numpy()
    np.testing.assert_array_equal(basis, nj.idct_basis().reshape(-1))
    assert nj.pool_size() > 0


def test_records_match_the_kernel_source():
    text = (Path(kernels.__file__).resolve().parent.parent / "csrc" / "jpeg_idct.cu").read_text()
    assert f"constexpr int kImgInts = {nj.IMG_INTS};" in text
    assert f"constexpr int kCompInts = {nj.COMP_INTS};" in text
    src = nj._SRC.read_text()
    assert f"constexpr int kImgInts = {nj.IMG_INTS};" in src
    assert f"constexpr int kCompInts = {nj.COMP_INTS};" in src
    assert "jpeg_idct" in kernels.launch_counts()
    assert kernels.KERNELS["jpeg_idct"] is jo.jpeg_idct


@pytest.mark.parametrize("size", [224, 64])
def test_engine_device_decode_path_on_the_cpu(size, smooth_photos):
    """InferenceEngine's device decode path (run_paths on a CUDA engine),
    driven on a CPU engine: the batch padded on the device, the same
    answer as run_batch of load_batch_device's pixels."""
    from dmlc_tpu_torch.parallel.inference import InferenceEngine

    engine = InferenceEngine("resnet18", device="cpu", dtype=torch.float32, batch_size=4,
                             device_resize_from=size)
    paths = smooth_photos[:3]
    got = engine._run_paths_device(paths)
    pixels, _ = tpp.load_batch_device(paths, size, "cpu")
    want = engine.run_batch(pixels.numpy())
    np.testing.assert_array_equal(got.top1_index, want.top1_index)
    np.testing.assert_allclose(got.top1_prob, want.top1_prob, rtol=1e-5)
    assert len(got.top1_index) == 3
