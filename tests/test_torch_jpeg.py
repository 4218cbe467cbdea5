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
import re
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


@pytest.fixture(scope="module")
def many_sizes(tmp_path_factory):
    """64 photos of 64 sizes, no two widths or heights alike (256x192 up to
    697x507, 4:2:0), as chip_smoke.jpeg_sizes makes them: M from 4 to 8,
    chroma resampled to the scaled grid."""
    root = tmp_path_factory.mktemp("jpeg_sizes")
    out = []
    for k in range(64):
        with Image.open(PHOTOS[k % len(PHOTOS)]) as im:
            p = root / f"{k}.jpg"
            im.convert("RGB").resize((256 + 7 * k, 192 + 5 * k), Image.BILINEAR).save(
                p, "JPEG", quality=90, subsampling=2)
            out.append(p)
    return out


@pytest.mark.parametrize("size", [224, 96])
def test_pixels_of_many_sizes_match_the_jax_package(size, many_sizes):
    """The port's pixels against the JAX package's decoder on 64 sizes.
    PIL is not the yardstick here: the JAX package's own decode (libjpeg's
    scaled IDCT and the triangle filter) is farther from PIL's than the
    bounds on some of these."""
    if not jax_native.ensure_built():
        pytest.skip("the JAX package's native decoder is not built (g++ or libjpeg missing)")
    got, status = tpp.load_batch_device(many_sizes, size, "cpu")
    ref, ref_status = jax_native.decode_resize_batch(many_sizes, size)
    assert not status.any() and not ref_status.any()
    _assert_within_bounds(got.numpy(), ref, "against decode_resize_batch")


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
    assert cmd[0] == "g++" and str(nj._SRC) in cmd and str(nj._PLAN_SRC) in cmd
    assert "-ffp-contract=off" in cmd  # the plan's weights round as Python's
    assert not any("jpeg" in a for a in cmd if a.startswith("-l"))
    nj.load()
    if shutil.which("ldd"):
        linked = subprocess.run(["ldd", str(nj._LIB_PATH)], capture_output=True, text=True).stdout
        assert "libjpeg" not in linked
    assert "jpeglib.h" not in nj._SRC.read_text() + nj._PLAN_SRC.read_text()


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
    # The plan's records, as native/jpeg_plan.cpp writes them and the kernel
    # reads them, and the limits the plan keeps.
    plan = nj._PLAN_SRC.read_text()
    for name, value in (("kPlanHdr", jo.PLAN_HDR), ("kGeomInts", jo.GEOM_INTS),
                        ("kTileInts", jo.TILE_INTS), ("kRunBlocks", jo.RUN_BLOCKS)):
        assert f"constexpr int {name} = {value};" in text, name
        assert f"constexpr int {name} = {value};" in plan, name
    for name, value in (("kTileRows", jo.TILE_ROWS), ("kSmemBudget", jo.SMEM_BUDGET),
                        ("kSmemMax", jo.SMEM_MAX), ("kMaxComps", nj.MAX_COMPS)):
        assert f"constexpr int {name} = {value};" in plan, name
    enums = [re.findall(r"enum (?:Geom|Tile) \{([^}]*)\}", src) for src in (text, plan)]
    assert enums[0] == enums[1] and len(enums[0]) == 2
    fields = {}
    for enum in enums[0]:
        fields.update((k.strip(), int(v)) for k, v in (f.split("=") for f in enum.split(",")))
    assert fields == {
        "kNTiles": jo.G_NTILES, "kTiles": jo.G_TILES, "kResize": jo.G_RESIZE, "kFY": jo.G_FY,
        "kFX": jo.G_FX, "kCY": jo.G_CY, "kCX": jo.G_CX, "kS": jo.G_S, "kF": jo.G_F, "kH": jo.G_H,
        "kQ": jo.G_Q, "kP": jo.G_P, "kT": jo.G_T, "kO": jo.G_O, "kSmem": jo.G_SMEM,
        "kTwin": jo.G_TWIN, "kOut": jo.T_OUT, "kScaled": jo.T_SCALED, "kSrc": jo.T_SRC,
        "kBox": jo.T_BOX}
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


# ---------------------------------------------------------------------------
# the kernel's plan (ops/jpeg.py batch_plan, geometry_plan): what
# csrc/jpeg_idct.cu reads, checked here where the kernel cannot run
# ---------------------------------------------------------------------------

#: name -> (height, width, save options, grayscale): the geometries the
#: plan must cover beside the photos: upsampled, a wide strip (column
#: tiles), odd-sized 4:2:0 and 4:2:2 (chroma resampled at M = 7), grey.
EXTREMES = {
    "tiny_40x30": (30, 40, dict(quality=90, subsampling=2), False),
    "strip_4096x256": (256, 4096, dict(quality=85, subsampling=2), False),
    "odd_301x257_s420": (257, 301, dict(quality=90, subsampling=2), False),
    "odd_287x263_s422": (263, 287, dict(quality=90, subsampling=1), False),
    "gray_291x259": (259, 291, dict(quality=90), True),
}


@pytest.fixture(scope="module")
def extremes(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpeg_extremes")
    rng = np.random.default_rng(35)
    out = []
    for name, (h, w, opts, gray) in EXTREMES.items():
        p = root / f"{name}.jpg"
        _smooth(rng, h, w, coarse=16, gray=gray).save(p, "JPEG", **opts)
        out.append(p)
    return out


def _geometry(co, i: int) -> tuple:
    """The arguments of ``geometry_plan`` for image ``i`` of the batch."""
    ncomp, ws, hs, first = (int(co.images[i, k]) for k in (3, 5, 6, 7))
    comps = tuple(tuple(int(co.comps[first + c, k]) for k in (12, 13, 8, 9))
                  for c in range(ncomp))
    return ncomp, ws, hs, comps, co.size


def _plan_sets(extremes, smooth_photos):
    return {"photos": PHOTOS, "smooth": smooth_photos, "extremes": extremes}


def _fancy_grids(co, i: int) -> list[np.ndarray]:
    """Each component of image ``i`` on its source grid, by the plain
    stages (the IDCT, the level shift, fancy upsampling)."""
    _, _, _, ncomp, _, _, _, first = (int(v) for v in co.images[i])
    basis = co.region("basis", torch.float32, 512).view(8, 8, 8)
    qt = co.region("qt", torch.int32, co.n * nj.MAX_COMPS * 64).view(-1, 64)
    coef = co.region("coef", torch.int16, co.total_blocks * 64)
    grids = []
    for c in range(ncomp):
        rec = co.comps[first + c]
        block_off, bw, bh = (int(v) for v in rec[:3])
        nx, ny, srcw, srch = (int(v) for v in rec[10:14])
        o = jo.idct_blocks(coef[block_off * 64:(block_off + bw * bh) * 64].view(-1, 64),
                           qt[first + c], nx, basis, ny)
        pix = (o + 128.0).round().clamp(0, 255).to(torch.int32)
        plane = pix.view(bh, bw, ny, nx).permute(0, 2, 1, 3).reshape(bh * ny, bw * nx)
        grids.append(jo._fancy(plane, rec, srch, srcw).numpy())
    return grids


def _tap_pass(x: np.ndarray, taps, lo: int, hi: int, start: int, axis: int) -> np.ndarray:
    """Outputs [lo, hi) of one resample pass along ``axis`` of float32
    ``x``, whose ``axis`` holds source indices [start, start + len): the
    trimmed taps in order, each product and sum rounded to float32 as the
    kernel's __fmul_rn / __fadd_rn are. Every tap must lie in ``x``."""
    first, count, w = taps
    size = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = hi - lo
    acc = None
    for k in range(w.shape[1]):
        idx = first[lo:hi].astype(np.int64) + k - start
        live = k < count[lo:hi]
        assert ((idx >= 0) & (idx < size))[live].all(), "a tap outside the staged extent"
        term = w[lo:hi, k].reshape(shape) * np.take(x, np.clip(idx, 0, size - 1), axis=axis)
        acc = term if acc is None else acc + term
    return acc


def _tiled_decode(co, i: int) -> np.ndarray:
    """Image ``i`` by the kernel's stages, tile by tile over its geometry
    plan: each component on the tile's scaled extent (resampled from the
    tile's source extent), the colour conversion, the resample to size x
    size; assembled into uint8 [size, size, 3]."""
    g = jo.geometry_plan(*_geometry(co, i))
    grids = _fancy_grids(co, i)
    ncomp, size = len(grids), co.size
    out = np.zeros((size, size, 3), np.uint8)
    for t in g.tiles:
        oy0, oy1, ox0, ox1, y0, y1, x0, x1 = (int(v) for v in t[:8])
        comps = []
        for c, grid in enumerate(grids):
            if f"cy{c}" not in g.tables:
                comps.append(grid[y0:y1, x0:x1].astype(np.int32))
                continue
            sy0, sy1, sx0, sx1 = (int(v) for v in t[jo.T_SRC + 4 * c:jo.T_SRC + 4 * c + 4])
            f = grid[sy0:sy1, sx0:sx1].astype(np.float32)
            h = _tap_pass(f, g.tables[f"cx{c}"], x0, x1, sx0, axis=1)
            s = _tap_pass(h, g.tables[f"cy{c}"], y0, y1, sy0, axis=0)
            comps.append(np.clip(np.rint(s), 0, 255).astype(np.int32))
        if ncomp == 1:
            rgb = np.repeat(comps[0][..., None], 3, -1)
        else:
            rgb = jo.ycbcr_to_rgb(*(torch.from_numpy(a) for a in comps)).numpy()
        if "fy" in g.tables:
            h = _tap_pass(rgb.astype(np.float32), g.tables["fx"], ox0, ox1, x0, axis=1)
            rgb = np.clip(np.rint(_tap_pass(h, g.tables["fy"], oy0, oy1, y0, axis=0)), 0, 255)
        out[oy0:oy1, ox0:ox1] = rgb.astype(np.uint8)
    return out


@pytest.mark.parametrize("which", ["photos", "smooth", "extremes"])
def test_the_tiled_stages_give_the_plain_versions_bytes(which, extremes, smooth_photos):
    """The kernel's stage order (fancy samples over a tile's source
    extent, chroma resampled, colour, the resample to size x size) run on
    the plain stages tile by tile over the plan: every tap inside its
    tile's staged extent, and the bytes of jpeg_idct_reference."""
    paths = _plan_sets(extremes, smooth_photos)[which]
    for size in (224, 96):
        co = _decode(paths, size)
        assert not co.status.any()
        want = jo.jpeg_idct_reference(co).numpy()
        for i in range(co.n):
            np.testing.assert_array_equal(_tiled_decode(co, i), want[i],
                                          err_msg=f"{paths[i].name} at {size}")


def _live_ranges(g, tile) -> list[dict[str, tuple[int, int]]]:
    """Byte ranges of shared memory the kernel touches for ``tile``, for
    each of its stages: the plane boxes, the fancy samples, the horizontal
    chroma pass, the vertical pass with the colour conversion, the
    resample to size x size."""
    oy0, oy1, ox0, ox1, y0, y1, x0, x1 = (int(v) for v in tile[:8])
    head = g.record[:jo.GEOM_INTS]
    scaled, out_px = (y1 - y0) * (x1 - x0), (oy1 - oy0) * (ox1 - ox0)
    ncomp = sum(1 for c in range(3) if tile[jo.T_SRC + 4 * c + 1] > tile[jo.T_SRC + 4 * c])
    s, f, h, q = {}, {}, {}, {}
    for c in range(ncomp):
        r0, r1, c0, c1 = (int(v) for v in tile[jo.T_BOX + 4 * c:jo.T_BOX + 4 * c + 4])
        if head[jo.G_Q + c] >= 0:
            q[f"Q{c}"] = (head[jo.G_Q + c], head[jo.G_Q + c] + (r1 - r0) * (c1 - c0))
        if head[jo.G_CY + c] < 0:
            s[f"S{c}"] = (head[jo.G_S + c], head[jo.G_S + c] + scaled)
            continue
        sy0, sy1, sx0, sx1 = (int(v) for v in tile[jo.T_SRC + 4 * c:jo.T_SRC + 4 * c + 4])
        f[f"F{c}"] = (head[jo.G_F + c], head[jo.G_F + c] + (sy1 - sy0) * (sx1 - sx0))
        h[f"H{c}"] = (head[jo.G_H + c], head[jo.G_H + c] + 4 * (sy1 - sy0) * (x1 - x0))
    p = {"P": (head[jo.G_P], head[jo.G_P] + 3 * scaled + 16)}
    stages = [{**s, **q}, {**s, **q, **f}, {**s, **f, **h}, {**s, **h, **p}]
    if head[jo.G_RESIZE]:
        stages.append({**p, "T": (head[jo.G_T], head[jo.G_T] + 12 * (y1 - y0) * (ox1 - ox0)),
                       "O": (head[jo.G_O], head[jo.G_O] + 3 * out_px + 16)})
    return stages


def _fancy_reads(lo: int, hi: int, factor: int, src: int) -> np.ndarray:
    """The plane samples libjpeg's fancy filter reads for source samples
    [lo, hi) along an axis of ``factor`` (the plain ``_fancy``'s rule)."""
    j = np.arange(lo, hi)
    if factor == 1:
        return j
    near = j >> 1
    other = np.clip(np.where(j & 1, near + 1, near - 1), 0, (src + 1) // 2 - 1)
    return np.concatenate([near, other])


def _check_geometry_plan(g, size: int, comps: tuple) -> None:
    """Tiles cover the output once; every tap of every output pixel and of
    every resampled component sample falls inside its tile's staged
    extent, and every plane sample a fancy sample reads inside its box;
    what a stage touches does not overlap, and all fits."""
    assert g.smem <= jo.SMEM_BUDGET <= jo.SMEM_MAX
    cover = np.zeros((size, size), np.int32)
    for t in g.tiles:
        oy0, oy1, ox0, ox1, y0, y1, x0, x1 = (int(v) for v in t[:8])
        cover[oy0:oy1, ox0:ox1] += 1
        for c, (srcw, srch, fx, fy) in enumerate(comps):
            sy0, sy1, sx0, sx1 = (int(v) for v in t[jo.T_SRC + 4 * c:jo.T_SRC + 4 * c + 4])
            r0, r1, c0, c1 = (int(v) for v in t[jo.T_BOX + 4 * c:jo.T_BOX + 4 * c + 4])
            rows, cols = _fancy_reads(sy0, sy1, fy, srch), _fancy_reads(sx0, sx1, fx, srcw)
            assert rows.min() >= r0 and rows.max() < r1 and cols.min() >= c0 and cols.max() < c1
        checks = [("fy", oy0, oy1, y0, y1), ("fx", ox0, ox1, x0, x1)]
        for c in range(3):
            sy0, sy1, sx0, sx1 = (int(v) for v in t[jo.T_SRC + 4 * c:jo.T_SRC + 4 * c + 4])
            checks += [(f"cy{c}", y0, y1, sy0, sy1), (f"cx{c}", x0, x1, sx0, sx1)]
        for name, lo, hi, s0, s1 in checks:
            if name not in g.tables:
                continue
            first, count, w = g.tables[name]
            assert (first[lo:hi] >= s0).all() and (first[lo:hi] + count[lo:hi] <= s1).all(), name
            assert (w[lo:hi, 0] != 0).all() and (w[lo:hi][np.arange(hi - lo), count[lo:hi] - 1]
                                                  != 0).all()
        for live in _live_ranges(g, t):
            spans = sorted(live.values())
            assert all(0 <= a <= b <= g.smem for a, b in spans), live
            assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), live
    np.testing.assert_array_equal(cover, 1)


def test_the_tile_plan_covers_every_tap(extremes, smooth_photos, made):
    co = _decode(PHOTOS + smooth_photos + extremes + [made["gray"], made["odd_131x97_s420"]], 224)
    assert not co.status.any()
    seen = {_geometry(co, i) for i in range(co.n)}
    # made-up geometries at the host decoder's limits (2^26 pixels, 16-bit
    # sides): a 65535x1024 4:2:0 at M = 2, a 65535x447 one at M = 4 whose
    # chroma is resampled, and a 1x65535 grey column at M = 8.
    seen |= {(3, 16384, 256, ((16384, 256, 1, 1),) * 3, 224),
             (3, 32768, 224, ((32768, 224, 1, 1), (65535, 447, 2, 2), (65535, 447, 2, 2)), 224),
             (1, 1, 65535, ((1, 65535, 1, 1),), 224)}
    for geometry in seen:
        _check_geometry_plan(jo.geometry_plan(*geometry), geometry[-1], geometry[3])
    serve = jo.geometry_plan(3, 224, 224, ((224, 224, 1, 1), (256, 256, 2, 2), (256, 256, 2, 2)),
                             224)
    assert (serve.rows, serve.cols) == (jo.TILE_ROWS, 224)  # full-width rows: 16-byte stores


#: (in, out) resamples: up, down, by up to 300x, and sizes from a seed.
TAP_PAIRS = [(256, 224), (224, 224), (40, 224), (3584, 224), (1000, 37), (1, 224), (2, 3),
             (7, 1), (65535, 224), (224, 1000), (447, 224), (129, 112)] + [
    (int(a), int(b)) for a, b in np.random.default_rng(36).integers(1, 2500, (24, 2))]


def test_trimmed_taps_drop_only_zero_weights():
    """native/jpeg_plan.cpp's tables carry resample_taps' float32 weights
    exactly (the same double operations), in order, without zero taps."""
    for src, dst in TAP_PAIRS:
        idx, w = jo.resample_taps(src, dst)
        first, count, tw = jo.trimmed_taps(src, dst)
        dense = np.zeros((dst, src), np.float32)
        trimmed = np.zeros((dst, src), np.float32)
        for o in range(dst):
            np.add.at(dense[o], idx[o], w[o])
            trimmed[o, first[o]:first[o] + count[o]] = tw[o, :count[o]]
        np.testing.assert_array_equal(trimmed, dense)
        assert (tw[np.arange(dst), count - 1] != 0).all() and (tw[:, 0] != 0).all()


def test_a_geometry_past_the_shared_memory_limit_is_refused():
    # a 292x downscale: a 1x1 tile's extent is 586 x 586 scaled samples
    with pytest.raises(ValueError, match=f"past {jo.SMEM_MAX}"):
        jo.geometry_plan(1, 65535, 65535, ((65535, 65535, 1, 1),), 224)


def test_a_batch_like_a_recent_one_reuses_its_plan_and_copy(made):
    co = _decode([made["s420_q95"], made["gray"]], 224)
    plan = jo.batch_plan(co)
    again = _decode([made["s420_q95"], made["gray"]], 224)
    assert jo.batch_plan(again) is plan
    on = plan.to(torch.device("cpu"))
    assert plan.to(torch.device("cpu")) is on
    np.testing.assert_array_equal(on.numpy(), plan.data)


def test_kept_geometries_give_the_plan_a_fresh_batch_would(made):
    """A batch whose geometries were made for an earlier batch copies their
    kept records; its plan equals the one made with nothing kept."""
    first = _decode([made["s420_q95"], made["gray"]], 224)
    mixed = _decode([made["gray"], made["s422_q50"], made["s420_q95"]], 224)
    jo.forget_plans()
    fresh = jo.batch_plan(mixed).data
    jo.forget_plans()
    jo.batch_plan(first)
    np.testing.assert_array_equal(jo.batch_plan(mixed).data, fresh)


def test_batch_plan_runs_every_block_once_and_skips_refused_images(tmp_path, made):
    odd = _refusals(tmp_path)
    paths = [made["s420_q95"], odd["progressive"], made["gray"], made["s422_q50"], odd["png"]]
    co = _decode(paths, 64)
    plan = jo.batch_plan(co)
    n = co.n
    data = plan.data
    assert tuple(data[:jo.PLAN_HDR]) == (n, plan.runs, plan.tiles, plan.smem)
    tile_start = data[jo.PLAN_HDR:jo.PLAN_HDR + n + 1]
    geom_at = data[jo.PLAN_HDR + n + 1:jo.PLAN_HDR + 2 * n + 1]
    run_start = data[jo.PLAN_HDR + 2 * n + 1:jo.PLAN_HDR + 5 * n + 2]
    assert tile_start[-1] == plan.tiles and run_start[-1] == plan.runs
    covered = np.zeros(co.total_blocks, np.int32)
    for r in range(plan.runs):  # the kernel's lookup: the last record starting at or before r
        ci = int(np.searchsorted(run_start[:-1], r, side="right") - 1)
        rec = co.comps[ci]
        block_off, bw = int(rec[0]), int(rec[1])
        per_row = -(-bw // jo.RUN_BLOCKS)
        by, bx0 = divmod(r - int(run_start[ci]), per_row)
        bx0 *= jo.RUN_BLOCKS
        nb = min(jo.RUN_BLOCKS, bw - bx0)
        assert nb >= 1  # no CTA launches idle
        covered[block_off + by * bw + bx0:block_off + by * bw + bx0 + nb] += 1
    np.testing.assert_array_equal(covered, 1)
    for i in range(n):
        ntiles = tile_start[i + 1] - tile_start[i]
        if co.status[i]:
            assert ntiles == 0 and geom_at[i] == -1
            continue
        g = jo.geometry_plan(*_geometry(co, i))
        assert ntiles == len(g.tiles) and plan.smem >= g.smem
        np.testing.assert_array_equal(data[geom_at[i]:geom_at[i] + g.record.size], g.record)
