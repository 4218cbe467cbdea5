"""The port's flash attention (ops/flash.py) on the CPU, where its wrappers
run the plain versions, against the JAX package's Pallas flash attention
run in interpret mode, as tests/test_pallas_kernels.py runs it.

Same numpy-seeded float32 inputs through both:

- ``flash_attention``'s out and its autograd gradients (through ``_Flash``:
  the plain forward, then the plain dq and dkv) against JAX's out and
  ``jax.grad`` through its custom VJP, causal and not, S in {32, 192, 193,
  512}; against the resident forward and against the streamed one (forced
  by shrinking ``_RESIDENT_KV_BYTES`` at test time);
- ``flash_attention_with_lse``'s lse and ``flash_attention_block_bwd``'s
  blockwise gradients against theirs;
- out and gradients at head dim 64 (the registry's other head dim, which
  the kernels are built for beside 128) against the same;
- at head dims 32 and 96, which the public functions zero-pad to 64 and
  128: out and gradients, lse and the blockwise gradients against the
  same; past 128 (160, 256 and 130, padded to 136) the head dims the wide
  kernels run at; the wrappers see the padded head dim, past 512 the CPU
  runs the plain versions at the head dim given and a CUDA device refuses
  it (``_kernel_head_dim``, ``_run_head_dim``); the wide kernels' limit
  and entry points are their source's;
- the same ``ValueError`` for a length with no legal block (the backward's
  block rule in ``flash_attention_block_bwd`` too), and the same
  ``auto_picks_dense`` answers;
- each flash entry point dispatches head dims 64 and 128 in both dtypes
  (bf16 to ``sm90::``, float32 to ``f32::``), the set
  ``KERNEL_HEAD_DIMS`` the wrappers accept on the card;
- each fault of ``tools/flash_fault_check.py`` (the paged decode kernel's
  too) and each lever of ``tools/flash_levers.py`` finds its line once in
  its kernel's source;
- every kernel source built on ``csrc/flash_sm90.cuh`` is one that
  ``chip_smoke.py``'s build phase checks, and exports its shared memory.

Tolerances: out and gradients atol 5e-5, rtol 1e-4 (float32 sums taken in
another order and blockwise online softmax against one dense softmax); lse
atol 1e-5.
"""

import ast
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.ops import pallas_kernels as pk
from dmlc_tpu_torch.ops import flash
from dmlc_tpu_torch.ops import kernels as K
from dmlc_tpu_torch.parallel.ring_attention import dense_attention

ATOL, RTOL = 5e-5, 1e-4
LSE_ATOL = 1e-5
B, H, D = 1, 2, 32
LENGTHS = [32, 192, 193, 512]


def _inputs(s: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, s, D), dtype=np.float32) for _ in range(4)]


def _ours(q, k, v, g, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash.flash_attention(qt, kt, vt, causal=causal)
    (out * torch.from_numpy(g)).sum().backward()
    return [t.detach().numpy() for t in (out, qt.grad, kt.grad, vt.grad)]


def _theirs(q, k, v, g, causal):
    def loss(q, k, v):
        out = pk.flash_attention(q, k, v, causal=causal)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    return [np.asarray(x) for x in (out, *grads)]


def _assert_close(got, want, what):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", LENGTHS)
def test_out_and_grads_match_the_resident_forward(s, causal):
    q, k, v, g = _inputs(s)
    _assert_close(_ours(q, k, v, g, causal), _theirs(q, k, v, g, causal), f"S={s}")


@pytest.mark.parametrize("s", [193, 256])
def test_out_and_grads_match_at_head_dim_64(s):
    rng = np.random.default_rng(4)
    q, k, v, g = (rng.standard_normal((B, H, s, 64), dtype=np.float32) for _ in range(4))
    _assert_close(_ours(q, k, v, g, True), _theirs(q, k, v, g, True), f"Dh 64 S={s}")


def _heads(s: int, dh: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, s, dh), dtype=np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", [32, 193])
@pytest.mark.parametrize("dh", [32, 96])
def test_out_and_grads_match_at_padded_head_dims(dh, s, causal):
    """Head dims the kernels are not built for run zero-padded to the next
    of KERNEL_HEAD_DIMS; the scale stays the original head dim's."""
    q, k, v, g = _heads(s, dh, seed=5)
    _assert_close(_ours(q, k, v, g, causal), _theirs(q, k, v, g, causal), f"Dh {dh} S={s}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_lse_and_block_backward_match_at_head_dim_96(causal):
    q, k, v, g = _heads(193, 96, seed=6)
    out, lse = flash.flash_attention_with_lse(*(torch.from_numpy(x) for x in (q, k, v)),
                                              causal=causal)
    j_out, j_lse = pk.flash_attention_with_lse(q, k, v, causal=causal)
    assert tuple(out.shape) == q.shape and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=LSE_ATOL, rtol=0)
    got = flash.flash_attention_block_bwd(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, j_out, j_lse, g)), causal=causal)
    want = pk.flash_attention_block_bwd(q, k, v, j_out, j_lse, g, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert tuple(a.shape) == q.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL, err_msg=name)


def test_kernel_head_dim_is_the_next_one_built():
    for dh in range(1, 130):
        want = 64 if dh <= 64 else 128 if dh <= 128 else None
        assert flash._kernel_head_dim(dh) == want, dh


def test_head_dims_past_128_run_plain_on_the_cpu_and_are_refused_on_the_card():
    """Past 128 the wide kernels take the head dim (rounded up to a
    multiple of 8) on every device; past their limit, 512, the CPU runs
    the plain versions at the head dim given and the card refuses it."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert flash._run_head_dim(96, cuda, "f") == 128 and flash._run_head_dim(32, cpu, "f") == 64
    assert flash._run_head_dim(160, cpu, "f") == 160
    assert flash._run_head_dim(160, cuda, "flash_attention") == 160
    assert flash._run_head_dim(130, cuda, "f") == 136 and flash._run_head_dim(512, cuda, "f") == 512
    assert flash._run_head_dim(520, cpu, "f") == 520
    with pytest.raises(ValueError, match="head dim 513 is past 512"):
        flash._run_head_dim(513, cuda, "flash_attention")
    q, k, v, g = _heads(32, 160, seed=7)
    _assert_close(_ours(q, k, v, g, True), _theirs(q, k, v, g, True), "Dh 160")


def test_every_head_dim_up_to_the_wide_limit_runs_on_the_card():
    """Each head dim in (128, WIDE_MAX_HEAD_DIM] runs at a head dim the
    wide kernels take, at most 7 wider; none past the limit does."""
    cuda = torch.device("cuda")
    for dh in range(129, flash.WIDE_MAX_HEAD_DIM + 1):
        run = flash._run_head_dim(dh, cuda, "f")
        assert flash._is_wide(run) and dh <= run < dh + flash.WIDE_HEAD_DIM_STEP, dh
    assert not any(flash._is_wide(dh) for dh in (*range(1, 129), flash.WIDE_MAX_HEAD_DIM + 8))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dh", [256, 130])
def test_out_and_grads_match_past_head_dim_128(dh, causal):
    """Head dims the wide kernels run (130 zero-padded to 136) against
    JAX's Pallas flash attention."""
    q, k, v, g = _heads(40, dh, seed=9)
    _assert_close(_ours(q, k, v, g, causal), _theirs(q, k, v, g, causal), f"Dh {dh}")


def test_wide_kernels_limit_and_entry_points_are_their_sources():
    """WIDE_MAX_HEAD_DIM is the source's kWideMaxDh, and each wide entry
    point the wrappers call exists there with its kernel's arguments (text
    only, no nvcc)."""
    text = (Path(flash.__file__).resolve().parent.parent / "csrc" / "flash_wide.cu").read_text()
    assert f"constexpr int kWideMaxDh = {flash.WIDE_MAX_HEAD_DIM};" in text
    assert "dh % 8 != 0" in text and flash.WIDE_HEAD_DIM_STEP == 8
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        wide = name.replace("flash_", "flash_wide_", 1)
        assert f'extern "C" int dmlc_{wide}(' in text
        assert K._SIGNATURES[wide][1] == K._SIGNATURES[name][1]
        assert K._LIBRARY[wide] == "flash_wide"


@pytest.mark.parametrize("dh, run", [(32, 64), (96, 128), (64, 64), (160, 160), (130, 136),
                                     (256, 256)])
def test_public_functions_hand_the_wrappers_the_padded_head_dim(dh, run, monkeypatch):
    """Every public entry point pads q, k, v, out and dO with zero columns
    before the wrappers (which launch the kernels on the card) and slices
    what they return."""
    seen = []

    def spy(fn):
        def call(*args, **kw):
            seen.append((fn.__name__, {a.shape[-1] for a in args if a.dim() == 3 and
                                       a.shape[-1] != 1}))
            return fn(*args, **kw)
        return call

    for name in ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv"):
        monkeypatch.setattr(flash, name, spy(getattr(flash, name)))
    q, k, v, g = (torch.from_numpy(x) for x in _heads(32, dh, seed=8))
    qg = q.clone().requires_grad_()
    out = flash.flash_attention(qg, k, v, causal=True)
    out.backward(g)
    o2, lse = flash.flash_attention_with_lse(q, k, v, causal=True)
    grads = flash.flash_attention_block_bwd(q, k, v, o2, lse, g, causal=True)
    assert [n for n, _ in seen] == ["flash_forward", "flash_bwd_dq", "flash_bwd_dkv"] * 2
    assert all(dims == {run} for _, dims in seen), seen
    assert all(tuple(x.shape) == (B, H, 32, dh) for x in (out, qg.grad, o2, *grads))
    assert torch.equal(out.detach(), o2)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", [192, 512])
def test_out_and_grads_match_the_streamed_forward(s, causal, monkeypatch):
    monkeypatch.setattr(pk, "_RESIDENT_KV_BYTES", 1)
    q, k, v, g = _inputs(s, seed=1)
    _assert_close(_ours(q, k, v, g, causal), _theirs(q, k, v, g, causal), f"streamed S={s}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", LENGTHS)
def test_lse_and_block_backward_match(s, causal):
    q, k, v, g = _inputs(s, seed=2)
    out, lse = flash.flash_attention_with_lse(*(torch.from_numpy(x) for x in (q, k, v)),
                                              causal=causal)
    j_out, j_lse = pk.flash_attention_with_lse(q, k, v, causal=causal)
    assert tuple(lse.shape) == (B, H, s, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=LSE_ATOL, rtol=0)
    # Blockwise gradients against the same (JAX) out and lse.
    got = flash.flash_attention_block_bwd(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, j_out, j_lse, g)), causal=causal)
    want = pk.flash_attention_block_bwd(q, k, v, j_out, j_lse, g, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL, err_msg=name)


def test_the_same_lengths_are_refused():
    """A length past the single-block cap with no block divisor that is a
    multiple of 8 (8209 is prime) raises the same ValueError in both."""
    x = np.zeros((1, 1, 8209, 16), np.float32)
    with pytest.raises(ValueError, match="pad the sequence"):
        pk.flash_attention(x, x, x)
    t = torch.from_numpy(x)
    for call in (flash.flash_attention, flash.flash_attention_with_lse):
        with pytest.raises(ValueError, match="pad the sequence"):
            call(t, t, t)
    with pytest.raises(ValueError, match="pad the sequence"):
        flash.flash_attention(t, t, t, blk_q=4096)
    # The backward's own rule: the blockwise backward refuses the length too.
    with pytest.raises(ValueError, match="pad the sequence"):
        pk.flash_attention_block_bwd(x, x, x, x, x[..., :1], x)
    with pytest.raises(ValueError, match="pad the sequence"):
        flash.flash_attention_block_bwd(t, t, t, t, t[..., :1], t)
    # An odd length up to the cap runs as one block in both.
    assert flash._auto_block(193, None, 128) == pk._auto_block(193, None, 128) == 193


def test_auto_block_rule_is_the_jax_packages():
    for s in (8, 96, 192, 193, 1000, 1024, 1032, 2048, 4104, 16384):
        for req in (None, 8, 64, 100, 256, 4096):
            for default in (128, 256):
                try:
                    want = pk._auto_block(s, req, default)
                except ValueError:
                    with pytest.raises(ValueError):
                        flash._auto_block(s, req, default)
                else:
                    assert flash._auto_block(s, req, default) == want, (s, req, default)


def test_auto_dispatch_predicate_matches():
    assert flash.AUTO_FLASH_MIN_S == pk.AUTO_FLASH_MIN_S
    assert flash.AUTO_DENSE_SCORES_CAP_BYTES == pk.AUTO_DENSE_SCORES_CAP_BYTES
    for b in (1, 2, 8, 32):
        for h in (1, 6, 12):
            for s in (128, 1024, 2048, 2049, 4095, 4096, 8192):
                assert flash.auto_picks_dense(b, h, s) == pk.auto_picks_dense(b, h, s), (b, h, s)


def test_attention_dispatches_to_dense_below_the_crossover():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(64, seed=3))
    want = dense_attention(q, k, v, causal=True)
    assert torch.equal(flash.attention(q, k, v, causal=True), want)
    np.testing.assert_allclose(flash.flash_attention(q, k, v, causal=True).numpy(), want.numpy(),
                               atol=ATOL, rtol=RTOL)


def test_gradient_dtypes_follow_the_inputs():
    """dq, dk, dv come back in q's, k's and v's dtype (bfloat16 here)."""
    q, k, v, _ = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in _inputs(32))
    flash.flash_attention(q, k, v, causal=True).float().sum().backward()
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16


def test_wrappers_check_operands_and_count_no_cpu_launch():
    K.reset_launch_counts()
    q = torch.zeros(2, 16, 64)
    lse = torch.zeros(2, 16, 1)
    flash.flash_forward(q, q, q, causal=True, scale=0.125)
    flash.flash_bwd_dq(q, q, q, q, lse, lse, causal=True, scale=0.125)
    flash.flash_bwd_dkv(q, q, q, q, lse, lse, causal=True, scale=0.125)
    counts = K.launch_counts()
    assert {counts[n] for n in ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")} == {0}
    with pytest.raises(ValueError, match="B\\*H, S, Dh"):
        flash.flash_forward(q[None], q[None], q[None], causal=False, scale=1.0)
    with pytest.raises(ValueError, match="expected"):
        flash.flash_forward(q, q[:, :8], q, causal=False, scale=1.0)
    with pytest.raises(ValueError, match="float32"):
        flash.flash_bwd_dq(q, q, q, q, lse.double(), lse, causal=False, scale=1.0)
    with pytest.raises(ValueError, match="device"):
        flash.flash_forward(q.to("meta"), q.to("meta"), q.to("meta"), causal=False, scale=1.0)


def _tool(name: str = "flash_fault_check"):
    path = Path(flash.__file__).resolve().parent.parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("fault", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_f32",
                                   "flash_bwd_dq_f32", "flash_bwd_dkv_f32", "flash_fwd_dh64"])
def test_fault_check_finds_its_loop_once(fault):
    """flash_fault_check.py plants each fault by replacing one line of its
    kernel's source, and refuses unless that line occurs exactly once: a
    rewrite of the kernel must carry the pattern along (text only, no
    nvcc). Each fault runs the check in its kernel's dtype, at its head
    dim."""
    tool = _tool()
    case = tool.FAULTS[fault]
    text = (tool.REPO / "dmlc_tpu_torch" / "csrc" / f"{case.source}.cu").read_text()
    assert text.count(case.old) == 1
    assert case.old != case.new and text.replace(case.old, case.new).count(case.new) == 1
    assert case.dtype in ("bfloat16", "float32") and case.shape[3] in flash.KERNEL_HEAD_DIMS
    assert fault.endswith("_f32") == (case.dtype == "float32")
    assert fault.endswith("_dh64") == (case.shape[3] == 64)
    assert case.check == "flash"


@pytest.mark.parametrize("fault", ["paged_past_length", "paged_page0", "paged_split_twice"])
def test_paged_fault_finds_its_line_once(fault):
    """The paged decode kernel's planted faults: one line of
    csrc/paged_decode.cu each, run by chip_smoke.paged_check at a geometry
    it holds (text only, no nvcc)."""
    tool = _tool()
    case = tool.FAULTS[fault]
    text = (tool.REPO / "dmlc_tpu_torch" / "csrc" / f"{case.source}.cu").read_text()
    assert case.source == "paged_decode" and case.check == "paged"
    assert text.count(case.old) == 1
    assert case.old != case.new and text.replace(case.old, case.new).count(case.new) == 1
    geometry, dh = case.shape
    tree = ast.parse((tool.REPO / "chip_smoke.py").read_text())
    names = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert "paged_check" in names and geometry in ("lm_wide", "bench_decode") and dh == 128
    assert set(tool.CHECKS) == {"flash", "paged"}


def _lever_sources_apply(group: str, lever: str) -> None:
    """flash_levers.py makes each variant by replacing text of the group's
    kernel sources and refuses unless each piece occurs exactly once (text
    only, no nvcc); a variant patches only kernels the group times, and one
    with no replacement is the checkout's sources."""
    tool = _tool("flash_levers")
    table = tool.GROUPS[group]
    assert lever in table.order and set(table.levers[lever]) <= set(table.kernels)
    sources = tool.variant_sources(group, lever)
    csrc = tool.REPO / "dmlc_tpu_torch" / "csrc"
    assert set(sources) == {f"{k}.cu" for k in table.levers[lever]}
    for name, text in sources.items():
        pieces = table.levers[lever][name[:-3]]
        assert pieces and all(new in text for _, new in pieces)
        assert text != (csrc / name).read_text()


@pytest.mark.parametrize("lever", ["a", "a0", "b", "c", "bc"])
def test_lever_tool_finds_its_lines_once(lever):
    """The bf16 flash_bwd_dq variants (group dq)."""
    _lever_sources_apply("dq", lever)


@pytest.mark.parametrize("lever", ["ship", "sync", "ring", "rows128", "keys64", "quad"])
def test_f32_lever_tool_finds_its_lines_once(lever):
    """The float32 forward and dK/dV variants (group f32)."""
    _lever_sources_apply("f32", lever)


@pytest.mark.parametrize("lever", ["ship", "ring", "rows32", "keys32", "keys64"])
def test_dq_f32_lever_tool_finds_its_lines_once(lever):
    """The float32 flash_bwd_dq variants (group dq_f32)."""
    _lever_sources_apply("dq_f32", lever)


@pytest.mark.parametrize("lever", ["ship", "split16", "warps8", "split64", "split128"])
def test_paged_lever_tool_finds_its_lines_once(lever):
    """The paged decode kernel's variants (group paged)."""
    _lever_sources_apply("paged", lever)


def test_every_hopper_kernel_is_checked_by_the_build_phase():
    """Each csrc/*.cu that includes flash_sm90.cuh is named in
    chip_smoke.SM90_KERNELS (so the build phase reports its registers,
    spills and wgmma/TMA instructions) and exports dmlc_<name>_smem_bytes
    (read there for its shared memory a block). chip_smoke.py is read with
    ast, not imported."""
    tool = _tool()
    tree = ast.parse((tool.REPO / "chip_smoke.py").read_text())
    listed = next(ast.literal_eval(node.value) for node in tree.body
                  if isinstance(node, ast.Assign)
                  and any(getattr(tg, "id", None) == "SM90_KERNELS" for tg in node.targets))
    csrc = tool.REPO / "dmlc_tpu_torch" / "csrc"
    hopper = sorted(p.stem for p in csrc.glob("*.cu")
                    if '#include "flash_sm90.cuh"' in p.read_text())
    assert hopper == sorted(listed)
    assert {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"} <= set(hopper)
    for name in hopper:
        text = (csrc / f"{name}.cu").read_text()
        assert f'extern "C" int dmlc_{name}_smem_bytes(int dh, int is_bf16)' in text


def test_each_entry_point_dispatches_both_head_dims_in_both_dtypes():
    """Each flash source's C entry point launches a kernel for head dim 64
    and 128 in bf16 (the Hopper kernels, flash::sm90) and in float32 (the
    FMA kernels, flash::f32), each instantiated at the head dim it is
    dispatched for; the wrappers accept exactly those head dims on the card
    (text only, no nvcc)."""
    assert flash.KERNEL_HEAD_DIMS == (64, 128)
    csrc = Path(flash.__file__).resolve().parent.parent / "csrc"
    pattern = re.compile(r"if \((!?)is_bf16 && dh == (\d+)\)\s*return \(int\)(sm90::|f32::)?"
                         r"launch_\w+<(\d+)>\(")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        text = (csrc / f"{name}.cu").read_text()
        body = text[text.index(f'extern "C" int dmlc_{name}('):]
        body = body[:body.index("\n}\n")]
        found = set()
        for neg, dh, ns, inst in pattern.findall(body):
            assert dh == inst, (name, dh, inst)
            assert ns == ("f32::" if neg else "sm90::"), (name, ns)
            found.add((neg == "", int(dh)))
        assert found == {(bf16, dh) for bf16 in (True, False) for dh in flash.KERNEL_HEAD_DIMS}
