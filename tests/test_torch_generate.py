"""The port's paged-KV generation engine on the CPU, against itself and
against the JAX package's engine on the same carried weights.

- allocator: the JAX allocator's cases (tests/test_generate.py);
- paged == contiguous == the full-sequence forward (logits 1e-4, tokens
  equal), and the port's engine == the JAX engine (greedy tokens identical,
  logits 1e-4) for lm_small and lm_wide at full width;
- multi-slot independence, page reuse without contamination, typed
  exhaustion, cache and allocator built once;
- temperature > 0: the draw is a pure function of (seed, position), its
  uniforms are jax.random.uniform's bit for bit, and its tokens are the
  JAX engine's.

Logits tolerance 1e-4: float32 sums in another order through two layers
(the JAX package's own paged-vs-full-forward bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.generate.engine import GenerationEngine as JaxEngine
from dmlc_tpu.models.registry import get_model as jax_get_model
from dmlc_tpu_torch.generate.engine import GenerationEngine, sample, sampling_uniforms
from dmlc_tpu_torch.generate.kvcache import SCRATCH_PAGE, PageAllocator, PagePoolExhausted
from dmlc_tpu_torch.models.convert import lm_from_jax
from dmlc_tpu_torch.models.registry import get_model

ATOL = 1e-4
VOCAB = get_model("lm_small").num_outputs


@pytest.fixture(scope="module")
def jax_variables():
    cache = {}

    def get(name):
        if name not in cache:
            _, v = jax_get_model(name).init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
            cache[name] = jax.tree_util.tree_map(np.asarray, v)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def variables(jax_variables):
    return jax_variables("lm_small")


ENGINE_KW = dict(max_slots=4, page_size=8, num_pages=64, max_prefill=16, return_logits=True)


def make_engine(variables, model="lm_small", **kw):
    return GenerationEngine(model, variables=variables, device="cpu", **{**ENGINE_KW, **kw})


def greedy_run(engine, slot, prompt, n_steps):
    """Join + n_steps greedy decode; returns (tokens, per-step logits)."""
    toks = [engine.join(slot, prompt)]
    logits = []
    for _ in range(n_steps):
        engine.ensure_capacity(slot)
        out = engine.step()
        toks.append(int(out[slot]))
        logits.append(np.array(engine.last_logits[slot]))
    return toks, logits


def _prompt(seed, n, vocab=VOCAB):
    return np.random.default_rng(seed).integers(0, vocab, size=n).astype(np.int32)


# ---------------------------------------------------------------------------
# allocator
# ---------------------------------------------------------------------------


def _scratch_never_allocated():
    a = PageAllocator(num_pages=5, page_size=4)
    got = a.alloc(4)
    assert SCRATCH_PAGE not in got and sorted(got) == [1, 2, 3, 4]


def _exhaustion_typed_all_or_nothing():
    a = PageAllocator(num_pages=4, page_size=4)
    a.alloc(2)
    with pytest.raises(PagePoolExhausted):
        a.alloc(2)  # only 1 free: no partial grant
    assert a.pages_free == 1 and a.summary()["exhaustions"] == 1


def _free_recycles_and_guards_double_free():
    a = PageAllocator(num_pages=8, page_size=4)
    got = a.alloc(3)
    a.free(got)
    assert a.pages_free == 7
    assert a.alloc(1) == [got[-1]]  # LIFO: the last page freed comes back first
    with pytest.raises(ValueError):
        a.free([got[0]])
    with pytest.raises(ValueError):
        a.free([SCRATCH_PAGE])


def _pages_for():
    a = PageAllocator(num_pages=8, page_size=4)
    assert [a.pages_for(n) for n in (0, 1, 4, 5, 8)] == [0, 1, 1, 2, 2]


@pytest.mark.parametrize("case", [
    _scratch_never_allocated, _exhaustion_typed_all_or_nothing,
    _free_recycles_and_guards_double_free, _pages_for,
], ids=lambda f: f.__name__.strip("_"))
def test_page_allocator(case):
    case()


def test_allocator_state_matches_jax():
    from dmlc_tpu.generate.kvcache import PageAllocator as JaxAllocator

    ours, theirs = PageAllocator(9, 4), JaxAllocator(9, 4)
    for n in (3, 2):
        assert ours.alloc(n) == theirs.alloc(n)
    ours.free([2, 5])
    theirs.free([2, 5])
    assert ours.alloc(3) == theirs.alloc(3)
    assert ours.summary() == theirs.summary()


# ---------------------------------------------------------------------------
# paged-KV correctness
# ---------------------------------------------------------------------------


def test_paged_matches_contiguous_and_full_forward(variables):
    paged = make_engine(variables)
    contig = make_engine(variables, cache="contiguous")
    prompt = _prompt(7, 9)
    t_p, logits_p = greedy_run(paged, 0, prompt, 5)
    t_c, logits_c = greedy_run(contig, 0, prompt, 5)
    assert t_p == t_c
    seq = list(prompt)
    model = paged.model
    for i, (lp, lc) in enumerate(zip(logits_p, logits_c)):
        np.testing.assert_allclose(lp, lc, rtol=0, atol=ATOL)
        seq.append(t_p[i])
        with torch.no_grad():
            full = model(torch.tensor([seq]))[0, -1].numpy()
        np.testing.assert_allclose(lp, full, rtol=0, atol=ATOL)


@pytest.mark.parametrize("model", ["lm_small", "lm_wide"])
def test_engine_matches_jax_engine(model, jax_variables):
    """Same weights, same prompts on 2 slots: greedy tokens identical to the
    JAX engine's for 6 steps, logits within 1e-4, prefill's first token
    included. lm_wide runs at full width."""
    var = jax_variables(model)
    vocab = get_model(model).num_outputs
    ours = make_engine(var, model=model)
    ref = JaxEngine(model, variables=var, **ENGINE_KW)
    prompts = [_prompt(11, 5, vocab), _prompt(12, 13, vocab)]
    for slot, p in enumerate(prompts):
        assert ours.join(slot, p) == ref.join(slot, p)
    for _ in range(6):
        for slot in range(2):
            ours.ensure_capacity(slot)
            ref.ensure_capacity(slot)
        got, want = ours.step(), ref.step()
        assert got[:2].tolist() == np.asarray(want)[:2].tolist()
        np.testing.assert_allclose(ours.last_logits[:2], ref.last_logits[:2], rtol=0, atol=ATOL)
    assert ours.cache.page_table.tolist() == ref.cache.page_table.tolist()
    assert ours.lengths.tolist() == ref.lengths.tolist()


def test_multi_slot_rows_are_independent(variables):
    """A slot's tokens do not change when strangers share the batch."""
    eng = make_engine(variables)
    p0, p1 = _prompt(3, 6), _prompt(4, 11)
    eng.join(0, p0)
    eng.join(1, p1)
    shared = []
    for _ in range(4):
        eng.ensure_capacity(0)
        eng.ensure_capacity(1)
        out = eng.step()
        shared.append((int(out[0]), int(out[1])))
    t0, _ = greedy_run(make_engine(variables), 0, p0, 4)
    t1, _ = greedy_run(make_engine(variables), 0, p1, 4)
    assert [a for a, _ in shared] == t0[1:]
    assert [b for _, b in shared] == t1[1:]


def test_page_reuse_after_exit_no_contamination(variables):
    """A new slot riding recycled pages produces exactly the tokens and
    logits of a fresh cache."""
    eng = make_engine(variables, num_pages=8)  # 7 usable pages
    greedy_run(eng, 0, _prompt(11, 15), 6)
    used = eng.cache.slot_pages(0)
    assert used
    freed = eng.release(0)
    assert sorted(freed) == sorted(used)
    pb = _prompt(12, 14)
    t_recycled, logits_recycled = greedy_run(eng, 0, pb, 6)
    assert set(eng.cache.slot_pages(0)) & set(freed)
    t_fresh, logits_fresh = greedy_run(make_engine(variables, num_pages=8), 0, pb, 6)
    assert t_recycled == t_fresh
    for lr, lf in zip(logits_recycled, logits_fresh):
        np.testing.assert_allclose(lr, lf, rtol=0, atol=1e-5)


def test_reserve_exhaustion_typed(variables):
    eng = make_engine(variables, num_pages=4)  # 3 usable 8-token pages
    eng.reserve(15)  # 15 + 1 tokens: 2 pages
    with pytest.raises(PagePoolExhausted):
        eng.reserve(15)


def test_cache_and_allocator_are_built_once(variables):
    eng = make_engine(variables)
    cache, allocator = eng.cache, eng.cache.allocator
    k_pool, v_pool = eng.cache.k_pages, eng.cache.v_pages
    rng = np.random.default_rng(5)
    for round_ in range(3):
        for slot in range(2):
            eng.join(slot, rng.integers(0, VOCAB, size=3 + round_ + slot).astype(np.int32))
        for _ in range(3):
            for slot in range(2):
                eng.ensure_capacity(slot)
            eng.step()
        for slot in range(2):
            eng.release(slot)
    assert eng.cache is cache and eng.cache.allocator is allocator
    # The step writes K/V in place: the pools are the ones built at start.
    assert eng.cache.k_pages is k_pool and eng.cache.v_pages is v_pool
    assert allocator.pages_free == allocator.pages_total


def test_corrupt_page_table_is_caught_on_the_host(variables):
    eng = make_engine(variables)
    eng.join(0, _prompt(1, 4))
    eng.cache.page_table[0, 1] = 64  # one past the pool
    with pytest.raises(IndexError, match="outside"):
        eng.step()


def test_entry_checks(variables):
    with pytest.raises(ValueError, match="not a language model"):
        GenerationEngine("resnet18", device="cpu")
    with pytest.raises(ValueError, match="cache"):
        make_engine(variables, cache="ring")
    eng = make_engine(variables)
    with pytest.raises(ValueError, match="max_prefill"):
        eng.join(0, np.arange(17, dtype=np.int32))
    eng.join(0, [1, 2])
    with pytest.raises(ValueError, match="already active"):
        eng.join(0, [3])
    assert eng.summary()["slots_active"] == 1
    assert eng.resident_bytes() > 2 * eng.cache.k_pages.numel() * 4


def test_load_variables_swaps_weights(jax_variables):
    var = jax_variables("lm_small")
    eng = GenerationEngine("lm_small", device="cpu", **ENGINE_KW)
    seeded = {k: v.clone() for k, v in eng.model.state_dict().items()}
    eng.load_variables(var)
    for key, value in lm_from_jax(var).items():
        assert torch.equal(eng.model.state_dict()[key], value), key
    eng.load_variables(seeded)
    assert torch.equal(eng.model.head.weight, seeded["head.weight"])
    with pytest.raises(ValueError, match="mismatch"):
        eng.load_variables({"head.weight": seeded["head.weight"]})


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _sampled_run(variables, seed, slot=0, steps=8):
    eng = make_engine(variables)
    for other in range(slot):  # strangers in the rows before ours
        eng.join(other, _prompt(50 + other, 3), temperature=0.7, seed=99 + other)
    toks = [eng.join(slot, np.arange(4, dtype=np.int32), temperature=1.5, seed=seed)]
    for _ in range(steps):
        for s in range(slot + 1):
            eng.ensure_capacity(s)
        toks.append(int(eng.step()[slot]))
    return toks


def test_temperature_sampling_is_a_function_of_seed_and_position(variables):
    a, b, c = (_sampled_run(variables, s) for s in (123, 123, 321))
    assert all(0 <= t < VOCAB for t in a + c)
    assert a == b  # same seed, same stream
    assert a != c  # another seed diverges
    # The same request in another slot row, beside other sampled slots.
    assert _sampled_run(variables, 123, slot=2) == a


def test_greedy_rows_ignore_the_noise_and_take_the_first_maximum():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 0.0, 5.0, 0.0]])
    seeds, positions = np.array([1, 2], np.uint32), np.array([0, 3])
    assert sample(logits, seeds, positions, np.zeros(2, np.float32)).tolist() == [1, 0]
    mixed = sample(logits, seeds, positions, np.array([0.0, 1.0], np.float32))
    assert int(mixed[0]) == 1


def test_sampling_uniforms_are_pure_and_in_range():
    seeds, positions = np.array([7, 7, 8], np.uint32), np.array([3, 3, 3])
    u = sampling_uniforms(seeds, positions, 4096, torch.device("cpu"))
    assert tuple(u.shape) == (3, 4096) and u.dtype == torch.float32
    tiny = float(np.finfo(np.float32).tiny)
    assert float(u.min()) >= tiny and float(u.max()) < 1.0
    assert torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    again = sampling_uniforms(np.array([8], np.uint32), np.array([3]), 4096, torch.device("cpu"))
    assert torch.equal(again[0], u[2])
    # 23 mantissa bits: every draw is a multiple of 2**-23.
    assert torch.equal(u * 2.0**23, torch.round(u * 2.0**23))
    # Roughly uniform: each decile holds about a tenth of the draws.
    counts = torch.histc(u.flatten(), bins=10, min=0.0, max=1.0)
    assert float((counts / u.numel() - 0.1).abs().max()) < 0.02


def test_sampling_uniforms_equal_jax_random_uniform_bit_for_bit():
    """The threefry draw of the JAX engine's key fold_in(fold_in(PRNGKey(0),
    seed), position): bit-identical float32 values (tolerance 0)."""
    seeds = np.array([0, 7, 123, 2**32 - 1, 1000, 1003], np.uint32)
    positions = np.array([0, 3, 17, 5, 127, 2**31 - 1], np.int32)
    vocab = 2048
    got = sampling_uniforms(seeds, positions, vocab, torch.device("cpu")).numpy()
    base = jax.random.PRNGKey(0)
    for b, (seed, pos) in enumerate(zip(seeds, positions)):
        key = jax.random.fold_in(jax.random.fold_in(base, seed), pos)
        want = np.asarray(jax.random.uniform(key, (vocab,), jnp.float32,
                                             minval=np.finfo(np.float32).tiny, maxval=1.0))
        assert np.array_equal(got[b].view(np.uint32), want.view(np.uint32)), b


# Sampled rows whose top two of logits / temperature + gumbel lie within
# this gap are not compared: float32 log rounds differently in the two
# frameworks, which can swap such a pair.
SAMPLE_TIE_GAP = 1e-5


def _score_gap(logits: np.ndarray, seeds, positions, temps) -> np.ndarray:
    u = sampling_uniforms(seeds, positions, logits.shape[-1], torch.device("cpu"))
    scores = (torch.from_numpy(logits) / torch.from_numpy(np.maximum(temps, 1e-6))[:, None]
              - torch.log(-torch.log(u)))
    top2 = scores.topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).numpy()


@pytest.mark.parametrize("model", ["lm_small", "lm_wide"])
def test_temperature_tokens_equal_the_jax_engine(model, jax_variables):
    """Temperature 0.8 on 4 slots, same weights, prompts and seeds: the
    port's tokens equal the JAX engine's at every step, rows within
    SAMPLE_TIE_GAP excluded (a slot stops being compared after such a row)
    and counted; none of the draws here comes that close."""
    var = jax_variables(model)
    vocab = get_model(model).num_outputs
    ours = make_engine(var, model=model)
    ref = JaxEngine(model, variables=var, **ENGINE_KW)
    slots = range(4)
    seeds = np.array([5, 6, 2**31 + 7, 12345], np.uint32)
    temps = np.full(4, 0.8, np.float32)
    for slot in slots:
        p = _prompt(20 + slot, 3 + 3 * slot, vocab)
        assert (ours.join(slot, p, temperature=0.8, seed=int(seeds[slot]))
                == ref.join(slot, p, temperature=0.8, seed=int(seeds[slot])))
    compared, excluded = 0, set()
    for _ in range(8):
        positions = ours.lengths[:4].copy()
        for slot in slots:
            ours.ensure_capacity(slot)
            ref.ensure_capacity(slot)
        got, want = ours.step()[:4], np.asarray(ref.step())[:4]
        gaps = _score_gap(np.asarray(ours.last_logits[:4]), seeds, positions, temps)
        excluded |= {s for s in slots if gaps[s] <= SAMPLE_TIE_GAP}
        for slot in slots:
            if slot not in excluded:
                assert int(got[slot]) == int(want[slot]), (slot, positions[slot])
                compared += 1
    assert compared >= 28 and len(excluded) <= 1, (compared, excluded)
