"""The native AOTInductor host (dmlc_tpu_torch/native/aoti_host.cpp) and its
bundle (dmlc_tpu_torch/models/aoti_bundle.py), on the CPU torch.

The host builds at first use against this torch install; the bundle of
tinynet is compiled by AOTInductor for the CPU once, in a module fixture.
The manifest must match the program's inputs (order, dtype, shape, raw
file sizes), the exporter's guards must raise, and the host's verbs keep
the reference's contracts: the usage exit, ``probe``'s one JSON line,
``frame-check``'s line framing, ``stage``'s bytes equal to the port's
``load_batch`` on tests/fixtures/photos, and ``run``'s top-1 equal to the
Python ``ExportedServer`` on the same bundle, its probabilities within
PROB_RTOL (AOTInductor fuses the float32 arithmetic in its own order).
"""

import json
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_engine import SIZE, tiny_variables  # registers the port's tinynet
from tiny_model import N_CLASSES  # registers the JAX tinynet

from dmlc_tpu_torch import native
from dmlc_tpu_torch.models import export as export_lib
from dmlc_tpu_torch.models.aoti_bundle import export_bundle
from dmlc_tpu_torch.ops import _build_host
from dmlc_tpu_torch.ops import preprocess as pp

REPO = Path(__file__).resolve().parent.parent
PHOTOS = REPO / "tests" / "fixtures" / "photos"
BATCH = 8
PROB_RTOL = 1e-5
ITEMSIZE = {"u8": 1, "f32": 4, "i32": 4, "bf16": 2}


def photo_paths() -> list[str]:
    return sorted(str(p) for p in PHOTOS.glob("*.jpg"))


@pytest.fixture(scope="module")
def host():
    return _build_host.ensure_host()


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    out = tmp_path_factory.mktemp("aoti_bundle")
    variables = tiny_variables(5)
    info = export_bundle("tinynet", BATCH, out, variables=variables,
                         image_paths=photo_paths()[:3], device="cpu")
    return out, info, variables


def _run(host, *args, **kw):
    return subprocess.run([str(host), *map(str, args)], capture_output=True, text=True,
                          timeout=300, **kw)


def _manifest(out: Path) -> list[tuple[str, tuple[int, ...], str]]:
    rows = []
    for line in (out / "args.txt").read_text().splitlines():
        spec, _, fname = line.partition("=")
        dt, _, dims = spec.partition(":")
        rows.append((dt, tuple(int(d) for d in dims.split(",")) if dims else (), fname))
    return rows


def test_bundle_layout(bundle):
    out, info, _ = bundle
    assert (out / "program.pt2").stat().st_size == info["program_bytes"] > 0
    assert (out / "args.txt").exists() and (out / "image.raw").exists()
    assert not (out / "compile_options.pb").exists()
    assert not (out / "client_options.txt").exists()
    assert info["weight_args"] == info["inputs"] - 1 == 4
    assert info["device"] == "cpu" and info["compile_s"] > 0


def test_manifest_matches_program_inputs(bundle):
    """args.txt is the host's staging contract: each line's dtype and shape
    equal the program's inputs in order, and every weight file holds
    exactly shape x itemsize bytes of the weights given."""
    out, _, variables = bundle
    ep = export_lib.export_program("tinynet", batch_size=BATCH, device="cpu")
    avals = [n.meta["val"] for n in ep.graph.nodes if n.op == "placeholder"]
    rows = _manifest(out)
    assert len(rows) == len(avals)
    names = {torch.float32: "f32", torch.uint8: "u8"}
    for (dt, shape, fname), aval in zip(rows, avals):
        assert dt == names[aval.dtype] and shape == tuple(aval.shape)
        want = int(np.prod(shape, dtype=np.int64)) * ITEMSIZE[dt]
        assert (out / fname).stat().st_size == want
    assert [r[2] for r in rows] == ["arg0.raw", "arg1.raw", "arg2.raw", "arg3.raw", "image.raw"]
    kernel = np.asarray(variables["params"]["conv1"]["kernel"])  # HWIO -> OIHW
    raw = np.frombuffer((out / "arg0.raw").read_bytes(), np.float32)
    np.testing.assert_array_equal(raw, np.transpose(kernel, (3, 2, 0, 1)).ravel())


def test_image_staging(bundle, tmp_path):
    """image.raw holds the decoded photos padded by repetition to the
    batch; more photos than the batch fail loudly."""
    out, _, _ = bundle
    raw = np.frombuffer((out / "image.raw").read_bytes(), np.uint8).reshape(BATCH, SIZE, SIZE, 3)
    want = pp.load_batch(photo_paths()[:3], size=SIZE)
    np.testing.assert_array_equal(raw[:3], want)
    np.testing.assert_array_equal(raw[3], raw[0])
    assert raw.std() > 10
    with pytest.raises(ValueError, match="silently"):
        export_bundle("tinynet", 2, tmp_path / "b2", image_paths=photo_paths()[:3], device="cpu")


@pytest.mark.parametrize("kind,match", [("shape", "flatten order drifted"),
                                        ("dtype", "dtype"),
                                        ("count", "leaves")])
def test_export_bundle_guards_raise(kind, match, tmp_path):
    """A leaf of another shape, a kind-crossing dtype and a leaf count that
    differs from the program's inputs each raise before any compile."""
    from dmlc_tpu_torch.models.convert import variables_from_jax

    sd = variables_from_jax("tinynet", tiny_variables(1))
    if kind == "shape":
        sd["head.bias"] = torch.zeros(N_CLASSES + 1)
    elif kind == "dtype":
        sd["conv1.bias"] = torch.zeros(8, dtype=torch.int32)
    else:
        sd["extra.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match=match):
        export_bundle("tinynet", 2, tmp_path / "b", variables=sd, device="cpu")
    assert not (tmp_path / "b" / "program.pt2").exists()


def test_host_built_by_another_command_is_stale(host):
    """A binary whose recorded g++ command differs from this machine's (say,
    linked against another torch install) is rebuilt at first use."""
    assert not _build_host.stale()
    recorded = _build_host.HOST_STAMP.read_text()
    try:
        _build_host.HOST_STAMP.write_text(recorded.replace("-ltorch", "-ltorch_other"))
        assert _build_host.stale()
    finally:
        _build_host.HOST_STAMP.write_text(recorded)
    assert not _build_host.stale()


def test_usage_exit(host):
    r = _run(host)
    assert r.returncode == 2
    for verb in ("probe", "run", "serve", "stage", "frame-check"):
        assert verb in r.stderr


def test_probe_reports_libtorch_and_the_package(host, bundle):
    out, _, _ = bundle
    report = json.loads(_run(host, "probe", out / "program.pt2").stdout)
    assert report["libtorch"] == re.match(r"\d+\.\d+\.\d+", torch.__version__).group(0)
    assert report["cuda"] is False and report["device_count"] == 0
    assert report["loaded"] is True and report["package_device"] == "cpu"
    assert report["decoder"] is (_build_host.jpeg_toolchain() is None)


def test_probe_bad_package_reports_json(host, tmp_path):
    bogus = tmp_path / "not_a_package.pt2"
    bogus.write_bytes(b"PK junk")
    r = _run(host, "probe", bogus)
    assert r.returncode == 0  # the report IS the product
    report = json.loads(r.stdout)
    assert report["loaded"] is False and report["error"]


def test_run_matches_exported_server(host, bundle):
    """The host runs the bundle with no Python in its process; its top-1 is
    the Python ExportedServer's on the same pixels and weights."""
    out, _, variables = bundle
    r = _run(host, "run", out)
    assert r.returncode == 0, r.stderr[-2000:]
    reply = json.loads(r.stdout.splitlines()[0])
    assert reply["device"] == "cpu"
    idx, prob = reply["outputs"]
    assert idx["shape"] == [BATCH] and idx["dtype"] == "i32" and prob["dtype"] == "f32"
    _, exp = export_lib.load_serving(export_lib.export_serving("tinynet", BATCH, device="cpu"))
    pixels = np.frombuffer((out / "image.raw").read_bytes(), np.uint8).reshape(
        BATCH, SIZE, SIZE, 3).copy()
    want_idx, want_prob = export_lib.ExportedServer(exp, variables)(pixels)
    assert idx["values"] == want_idx.tolist()
    np.testing.assert_allclose(prob["values"], want_prob, rtol=PROB_RTOL)


def test_run_iters_prints_a_rate(host, bundle):
    out, _, _ = bundle
    r = _run(host, "run", out, "--iters", "5")
    assert r.returncode == 0, r.stderr[-2000:]
    rate = json.loads(r.stdout.splitlines()[1])
    assert rate["iters"] == 5 and rate["batch"] == BATCH and rate["images_per_s"] > 0


def test_run_refuses_a_short_weight_file(host, bundle, tmp_path):
    out, _, _ = bundle
    broken = tmp_path / "broken"
    broken.mkdir()
    for f in out.iterdir():
        (broken / f.name).write_bytes(f.read_bytes())
    (broken / "arg2.raw").write_bytes(b"\0" * 8)
    r = _run(host, "run", broken)
    assert r.returncode == 1 and "arg2.raw is 8 bytes" in r.stderr


class TestStage:
    """`stage` is the hermetic half of serve: the exact bytes serve hands
    the program for a directory of JPEGs."""

    @pytest.fixture(scope="class")
    def staged(self, host, bundle, tmp_path_factory):
        if not native.ensure_built():
            pytest.skip("the port's native decoder does not build here (g++ or libjpeg)")
        out, _, _ = bundle
        raw = tmp_path_factory.mktemp("stage") / "staged.raw"
        r = _run(host, "stage", out, "--dir", PHOTOS, "--out", raw)
        assert r.returncode == 0, r.stderr[-2000:]
        return json.loads(r.stdout), raw

    def test_geometry_and_padding(self, staged):
        meta, raw = staged
        n = len(photo_paths())
        assert meta["batch"] == BATCH and meta["files"] == n and meta["padded"] == BATCH - n
        assert meta["decode_failures"] == 0
        assert raw.stat().st_size == meta["bytes"] == BATCH * meta["size"] ** 2 * 3

    def test_bytes_equal_load_batch(self, staged):
        """The port's load_batch (its native decoder, the same C code) and
        the exporter's repeat-padding give these bytes exactly."""
        meta, raw = staged
        files = photo_paths()
        got = np.frombuffer(raw.read_bytes(), np.uint8).reshape(BATCH, SIZE, SIZE, 3)
        ref = pp.load_batch(files, size=SIZE, backend="native")
        np.testing.assert_array_equal(got[: len(files)], ref)
        reps = -(-BATCH // len(files))
        np.testing.assert_array_equal(got, np.tile(ref, (reps, 1, 1, 1))[:BATCH])

    def test_bytes_near_pil(self, staged):
        meta, raw = staged
        files = photo_paths()
        got = np.frombuffer(raw.read_bytes(), np.uint8).reshape(BATCH, SIZE, SIZE, 3)
        pil = pp.load_batch(files, size=SIZE, backend="pil")
        diff = np.abs(got[: len(files)].astype(np.int32) - pil.astype(np.int32))
        assert diff.mean() < 0.5

    def test_requires_dir_and_out(self, host, tmp_path):
        r = _run(host, "stage", tmp_path)
        assert r.returncode == 2 and "--dir" in r.stderr

    def test_empty_dir_fails_loudly(self, host, bundle, tmp_path):
        out, _, _ = bundle
        empty = tmp_path / "empty"
        empty.mkdir()
        r = _run(host, "stage", out, "--dir", empty, "--out", tmp_path / "x.raw")
        assert r.returncode == 1 and "no JPEGs" in r.stderr


def test_serve_dir_and_stdin_requests(host, bundle):
    """The resident loop answers --dir batch-wise and then one JSON line a
    stdin request, with the top-1 of ExportedServer on the same pixels."""
    if not native.ensure_built():
        pytest.skip("the port's native decoder does not build here (g++ or libjpeg)")
    out, _, variables = bundle
    files = photo_paths()
    request = " ".join(files[:2]) + "\n"
    r = _run(host, "serve", out, "--dir", PHOTOS, input=request)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(line) for line in r.stdout.splitlines()]
    assert len(lines) == 2
    _, exp = export_lib.load_serving(export_lib.export_serving("tinynet", BATCH, device="cpu"))
    server = export_lib.ExportedServer(exp, variables)
    want, _ = server(pp.load_batch(files, size=SIZE, backend="native"))
    assert lines[0]["top1"] == want.tolist()
    assert lines[0]["files"] == [Path(f).name for f in files]
    assert lines[1]["top1"] == want[:2].tolist()


def test_serve_repeat_needs_dir(host, bundle):
    out, _, _ = bundle
    r = _run(host, "serve", out, "--repeat", "2")
    assert r.returncode == 2 and "--repeat needs --dir" in r.stderr


class TestServeRequestFraming:
    """`frame-check` runs serve's exact stdin framing with no package."""

    def _frames(self, host, payload: bytes):
        r = subprocess.run([str(host), "frame-check"], input=payload, capture_output=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        return [json.loads(line) for line in r.stdout.decode().splitlines()]

    def test_long_request_line_is_one_request(self, host):
        paths = [f"/data/corpus/img{i:06d}.jpg" for i in range(8000)]
        line = " ".join(paths)
        assert len(line) > 3 * 65536
        replies = self._frames(host, (line + "\n").encode())
        assert len(replies) == 1 and replies[0]["paths"] == len(paths)

    def test_path_at_buffer_seam_not_mangled(self, host):
        replies = self._frames(host, f"{'a' * 65530} {'b' * 100}\n".encode())
        assert len(replies) == 1 and replies[0]["paths"] == 2

    def test_many_lines_map_one_to_one(self, host):
        replies = self._frames(host, b"x.jpg y.jpg\n\n   \nz.jpg\n")
        assert [r["paths"] for r in replies] == [2, 1]

    def test_final_unterminated_line_still_answers(self, host):
        replies = self._frames(host, b"x.jpg y.jpg")
        assert [r["paths"] for r in replies] == [2]


def test_cli_export_bundle_verb(tmp_path):
    """The port CLI writes the host bundle (export from the REPL, serve with
    the native host, no Python)."""
    from dmlc_tpu_torch.cli import Cli

    class StubNode:
        device = "cpu"

        class config:
            batch_size = 4

    out = Cli(StubNode()).run_command(f"export-bundle tinynet {tmp_path / 'b'}")
    assert "bundle for tinynet" in out and "aoti_host serve" in out, out
    for name in ("program.pt2", "args.txt", "arg0.raw"):
        assert (tmp_path / "b" / name).exists()
    assert "random-init" in out  # the stub node has no SDFS weights
    assert "usage:" in Cli(StubNode()).run_command("export-bundle tinynet")


def test_cli_export_bundle_uses_published_weights(tmp_path):
    """With weights published in SDFS, the verb bundles THOSE."""
    from dmlc_tpu_torch.cli import Cli
    from dmlc_tpu_torch.models import weights as weights_lib
    from dmlc_tpu_torch.models.convert import variables_from_jax

    variables = tiny_variables(42)
    blob = weights_lib.weights_to_bytes("tinynet", variables)

    class StubSdfs:
        def get_bytes(self, name):
            assert name == weights_lib.sdfs_weights_name("tinynet")
            return 1, blob

    class StubNode:
        device = "cpu"
        sdfs = StubSdfs()

        class config:
            batch_size = 4

    out = Cli(StubNode()).run_command(f"export-bundle tinynet {tmp_path / 'b'}")
    assert "published SDFS weights" in out, out
    first = variables_from_jax("tinynet", variables)["conv1.weight"]
    raw = np.frombuffer((tmp_path / "b" / "arg0.raw").read_bytes(), np.float32)
    np.testing.assert_array_equal(raw, first.numpy().ravel())
