"""GenerationEngine: autoregressive decode over a paged KV cache.

Counterpart of ``dmlc_tpu/generate/engine.py``. One engine serves one
registry LM (kind="lm") at a fixed batch shape: every decode step runs all
``max_slots`` rows whether or not a request occupies them, so slots join
and leave between steps without reshaping anything.

- prefill (``join``): one slot's padded prompt ([1, max_prefill]) through
  the full causal forward; K/V of the real positions go into the slot's
  pages (padding lands on the scratch page), and the last real position's
  logits give the first sampled token. Exact because padding sits at the
  end under a causal mask: no real position can attend to it.
- ``step``: one token per slot ([max_slots]) — embed, then per layer: write
  K/V at position ``lengths[s]``, attention over ``lengths[s]+1`` positions
  read from the slot's pages through the page table
  (``ops/ragged_decode.paged_decode_attention``: one hand-written CUDA
  kernel a layer on the card, no gathered view), MLP — then the head and
  sampling.

The JAX engine donates the pools to its jitted programs and gets new ones
back. This engine writes each step's K/V into the pools in place
(``index_put_``), so one copy of the cache exists in device memory.
Inactive rows all write to the scratch page; those duplicate writes go
nowhere else, and the scratch page is never attended to by an active row.

The forward math is the module's own (``models/lm.TransformerLM``'s
submodules, ``Block.attend_out``), so decode logits match the full-sequence
forward within float tolerance. ``cache="contiguous"`` swaps the page pool
for a dense per-slot cache, read by the same attention as a pool of one
page a slot (table ``[[0], [1], ...]``): the parity reference for the
paged path. The kernel's sums depend on positions only, so on the card
both caches give the same bits for the same state.

Sampling is per-slot and position-seeded: greedy (first-index argmax) at
temperature <= 0; otherwise the JAX engine's draw, ``jax.random.categorical``
under ``fold_in(fold_in(PRNGKey(0), seed), position)``: Gumbel noise from
threefry bits computed in integer tensor ops (``sampling_uniforms``), added
to the logits over the temperature, argmax. It is a pure function of (seed,
position), independent of batch composition, step count and slot row, and
gives the JAX engine's tokens up to the rounding of ``log`` (rows whose
top two scores lie within that rounding can differ).
"""

from __future__ import annotations

import time
from typing import Any, Mapping

import numpy as np
import torch

from dmlc_tpu_torch.generate.kvcache import SCRATCH_PAGE, PagedKVCache
from dmlc_tpu_torch.models.convert import load_into
from dmlc_tpu_torch.models.registry import get_model
from dmlc_tpu_torch.ops.ragged_decode import check_page_table, paged_decode_attention
from dmlc_tpu_torch.parallel.ring_attention import dense_attention
from dmlc_tpu_torch.utils.device import resolve_device

_M32 = 0xFFFFFFFF
# Threefry-2x32's rotation schedule (two groups of four, alternating) and
# key-schedule parity constant, as jax.random's implementation has them.
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA
# float32's smallest normal number: jax.random.gumbel's uniform lower bound.
_F32_TINY = float(np.finfo(np.float32).tiny)


def _threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                  x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values,
    broadcast against each other: the hash under ``jax.random``'s default
    PRNG. Every sum is masked back to 32 bits, so nothing overflows int64."""
    ks = (k0, k1, k0 ^ k1 ^ _THREEFRY_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for group in range(5):
        for r in _THREEFRY_ROTATIONS[group % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _M32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & _M32
    return x0, x1


def sampling_uniforms(seeds: np.ndarray, positions: np.ndarray, vocab: int,
                      device: torch.device) -> torch.Tensor:
    """[B, vocab] float32 uniforms in [tiny, 1): row b is, bit for bit,
    ``jax.random.uniform(fold_in(fold_in(PRNGKey(0), seeds[b]),
    positions[b]), (vocab,), minval=finfo(float32).tiny, maxval=1)`` under
    the partitionable threefry (JAX's default), in integer tensor ops, so
    the CPU and the card draw the same values.

    ``fold_in(key, d)`` hashes the counter pair (0, d) under ``key``; the
    bits of entry v hash (0, v) under the row's key and XOR the two output
    words; the top 23 bits become a float32 mantissa in [1, 2), minus 1.
    Zero is raised to ``tiny``, as ``uniform``'s final ``max`` does."""
    seed = torch.from_numpy(np.asarray(seeds, np.int64) & _M32).to(device)
    pos = torch.from_numpy(np.asarray(positions, np.int64) & _M32).to(device)
    zero = torch.zeros_like(seed)
    k0, k1 = _threefry2x32(zero, zero, zero, seed)  # fold_in(PRNGKey(0), seed)
    k0, k1 = _threefry2x32(k0, k1, zero, pos)  # fold_in(., position)
    col = torch.arange(vocab, dtype=torch.int64, device=device)[None, :]
    b0, b1 = _threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(col), col)
    mantissa = ((b0 ^ b1) >> 9) | 0x3F800000
    return (mantissa.to(torch.int32).view(torch.float32) - 1.0).clamp_min(_F32_TINY)


def sample(logits: torch.Tensor, seeds: np.ndarray, positions: np.ndarray,
           temps: np.ndarray) -> torch.Tensor:
    """Greedy at temperature <= 0, otherwise ``jax.random.categorical``'s
    Gumbel-max under the row's (seed, position) key (``sampling_uniforms``).
    logits: [B, V] float32; seeds, positions (the sequence position each
    row's token lands at) and temps: host arrays [B]. Returns int64 [B] on
    the logits' device."""
    greedy = logits.argmax(dim=-1)  # first index of the maximum
    temps = np.asarray(temps, np.float32)
    if not (temps > 0).any():
        return greedy
    dev = logits.device
    u = sampling_uniforms(seeds, positions, logits.shape[-1], dev)
    gumbel = -torch.log(-torch.log(u))
    scaled = logits / torch.from_numpy(np.maximum(temps, 1e-6)).to(dev)[:, None]
    sampled = (scaled + gumbel).argmax(dim=-1)
    return torch.where(torch.from_numpy(temps > 0).to(dev), sampled, greedy)


class GenerationEngine:
    """Continuous-batching decode for one registry LM.

    Host-side state (lengths, active flags, temperatures, seeds, the page
    table) is NumPy; device state is the model and the KV pools. Mutating
    methods (join/step/release) must be serialized by the caller — the
    SlotScheduler's decode thread is the only writer in production;
    ``reserve``/``release_reservation`` are thread-safe (the allocator has
    its own lock) so admission can run on RPC threads. ``device=None`` is
    the current CUDA device and raises when there is none.
    """

    def __init__(
        self,
        model_name: str,
        *,
        variables: Mapping | None = None,
        dtype: torch.dtype = torch.float32,
        max_slots: int = 8,
        page_size: int = 16,
        num_pages: int = 128,
        max_prefill: int = 64,
        cache: str = "paged",
        return_logits: bool = False,
        seed: int = 0,
        device_work: Any = None,
        device: str | torch.device | None = None,
    ) -> None:
        # Device-plane telemetry hook: called with (model, tokens, seconds)
        # per decode step. None = off.
        self.device_work = device_work
        if cache not in ("paged", "contiguous"):
            raise ValueError(f"cache must be 'paged' or 'contiguous', got {cache!r}")
        spec = get_model(model_name)
        if spec.kind != "lm":
            raise ValueError(f"{model_name!r} is not a language model (kind={spec.kind})")
        self.device = resolve_device(device)
        self.spec = spec
        self.model_name = spec.name
        self.dtype = dtype
        # Seed init: generation is servable with no published weights.
        model = spec.init_params(0, dtype=dtype)
        self.model = model.to(self.device).eval().requires_grad_(False)
        if variables is not None:
            self.load_variables(variables)
        self.vocab = int(model.vocab)
        self.num_layers = int(model.num_layers)
        self.num_heads = int(model.num_heads)
        self.hidden = int(model.hidden)
        self.head_dim = self.hidden // self.num_heads
        self.max_len = int(model.max_len)
        self.max_slots = int(max_slots)
        self.max_prefill = min(int(max_prefill), self.max_len)
        self.cache_mode = cache
        self.return_logits = bool(return_logits)

        max_pages_per_slot = -(-self.max_len // int(page_size))
        self.cache: PagedKVCache | None
        if cache == "paged":
            self.cache = PagedKVCache(
                num_layers=self.num_layers,
                num_pages=num_pages,
                page_size=page_size,
                num_heads=self.num_heads,
                head_dim=self.head_dim,
                max_slots=self.max_slots,
                max_pages_per_slot=max_pages_per_slot,
                dtype=dtype,
                device=self.device,
            )
            self.max_tokens = min(self.max_len, self.cache.max_tokens_per_slot)
            self._k_state = self.cache.k_pages
            self._v_state = self.cache.v_pages
        else:
            self.cache = None
            self.max_tokens = self.max_len
            shape = (self.num_layers, self.max_slots, self.max_tokens,
                     self.num_heads, self.head_dim)
            self._k_state = torch.zeros(shape, dtype=dtype, device=self.device)
            self._v_state = torch.zeros(shape, dtype=dtype, device=self.device)
            # Each slot's row of the state is one page of max_tokens rows.
            self._slot_table = torch.arange(self.max_slots, dtype=torch.int32,
                                            device=self.device).view(-1, 1)

        # Host-side slot registers (fixed batch shape).
        self.lengths = np.zeros(self.max_slots, np.int32)
        self.active = np.zeros(self.max_slots, bool)
        self.temps = np.zeros(self.max_slots, np.float32)
        self.steps = 0
        self.tokens_out = 0
        self.last_tokens = np.zeros(self.max_slots, np.int32)
        self.last_logits: np.ndarray | None = None
        # Per-slot sampling seeds. Default seeds derive deterministically
        # from the engine seed and a join counter; a caller-supplied seed
        # overrides so a resumed stream replays the same random sequence.
        self.seeds = np.zeros(self.max_slots, np.uint32)
        self._base_seed = int(seed)
        self._joins = 0
        self._rows = torch.arange(self.max_slots, device=self.device)
        self._seq = torch.arange(self.max_prefill, device=self.device)

    # ---- forward math ---------------------------------------------------

    def _decode(self, tokens: torch.Tensor, lengths: torch.Tensor, active: torch.Tensor,
                table: torch.Tensor | None) -> torch.Tensor:
        """One token per slot through every layer -> float32 logits [B, V].
        ``table`` is the uploaded page table (None in contiguous mode).
        Enqueues device work only: nothing here waits for the device."""
        model = self.model
        pos = lengths.clamp(max=self.max_len - 1)
        x = model.embed_at(tokens, pos)  # [B, D]
        if self.cache is not None:
            assert table is not None
            page_size = self.cache.page_size
            # Destination of this step's K/V: the page covering position
            # ``lengths[s]``; inactive rows write into scratch page 0.
            col = (lengths // page_size).clamp(max=table.shape[1] - 1)
            dest_page = torch.where(active, table[self._rows, col].long(), SCRATCH_PAGE)
            dest_off = lengths % page_size
        else:
            table = self._slot_table
        kv_lengths = (lengths + 1).clamp(min=1)
        for layer, blk in enumerate(model.blocks()):
            q, k, v = blk.attn.qkv(blk.ln1(x))  # [B, H, Dh] each
            k_pool, v_pool = self._k_state[layer], self._v_state[layer]
            if self.cache is not None:
                # In place: duplicate indices occur only on the scratch page.
                k_pool.index_put_((dest_page, dest_off), k)
                v_pool.index_put_((dest_page, dest_off), v)
            else:
                k_pool.index_put_((self._rows, lengths), k)
                v_pool.index_put_((self._rows, lengths), v)
            att = paged_decode_attention(q, k_pool, v_pool, table, kv_lengths)
            x = blk.attend_out(x, att)
        return model.head(model.ln_f(x)).to(torch.float32)

    def _prefill(self, slot: int, padded: np.ndarray, length: int) -> torch.Tensor:
        """One slot's padded prompt through the causal forward, K/V written
        into its cache; returns the float32 logits [V] at ``length - 1``."""
        model = self.model
        tokens = torch.from_numpy(padded.astype(np.int64)).to(self.device)[None]
        x = model.embed_at(tokens, self._seq[None])  # [1, S, D]
        if self.cache is not None:
            page_size = self.cache.page_size
            dest = torch.from_numpy(self.cache.page_table[slot].astype(np.int64)).to(self.device)
            dest_page = torch.where(self._seq < length, dest[self._seq // page_size],
                                    SCRATCH_PAGE)
            dest_off = self._seq % page_size
        for layer, blk in enumerate(model.blocks()):
            q, k, v = blk.attn.qkv(blk.ln1(x))  # [1, S, H, Dh] each
            if self.cache is not None:
                self._k_state[layer].index_put_((dest_page, dest_off), k[0])
                self._v_state[layer].index_put_((dest_page, dest_off), v[0])
            else:
                # Positions past ``length`` are rows the ragged mask never
                # exposes; later decode steps overwrite them.
                self._k_state[layer, slot, : self.max_prefill] = k[0]
                self._v_state[layer, slot, : self.max_prefill] = v[0]
            att = dense_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=True).transpose(1, 2)
            x = blk.attend_out(x, att)
        return model.head(model.ln_f(x[0, length - 1])).to(torch.float32)

    # ---- admission (thread-safe) ----------------------------------------

    def reserve(self, prompt_len: int) -> list[int]:
        """Reserve pages for a prompt plus its first generated token.
        Raises PagePoolExhausted — the submit-time shed signal. Contiguous
        mode has nothing to reserve (capacity is the slot row itself)."""
        if self.cache is None:
            return []
        need = self.cache.allocator.pages_for(int(prompt_len) + 1)
        return self.cache.allocator.alloc(need)

    def release_reservation(self, pages: list[int]) -> None:
        if self.cache is not None and pages:
            self.cache.allocator.free(pages)

    # ---- slot lifecycle (decode-thread only) -----------------------------

    def free_slots(self) -> list[int]:
        return [s for s in range(self.max_slots) if not self.active[s]]

    @torch.no_grad()
    def join(self, slot: int, prompt: Any, *, temperature: float = 0.0,
             pages: list[int] | None = None, seed: int | None = None) -> int:
        """Prefill ``prompt`` into ``slot`` and return the first sampled
        token. ``pages`` is the submit-time reservation (paged mode).
        ``seed`` keys the position-seeded sampling; passing the same seed
        with ``prompt + delivered_prefix`` resumes a stream
        token-identically."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token sequence")
        if prompt.size > self.max_prefill:
            raise ValueError(
                f"prompt of {prompt.size} tokens exceeds max_prefill={self.max_prefill}"
            )
        if self.active[slot]:
            raise ValueError(f"slot {slot} is already active")
        if self.cache is not None:
            if pages is None:
                pages = self.reserve(prompt.size)
            self.cache.bind(slot, pages)
        padded = np.zeros(self.max_prefill, np.int32)
        padded[: prompt.size] = prompt
        if seed is None:
            seed = (self._base_seed * 1_000_003 + self._joins) % (1 << 31)
        self._joins += 1
        seed = int(seed) & 0xFFFFFFFF
        last = self._prefill(slot, padded, int(prompt.size))
        # The first token comes from position ``length - 1``, the same
        # position a resumed prefill of prompt+prefix samples again.
        nxt = sample(last[None], np.array([seed], np.uint32),
                     np.array([prompt.size - 1]), np.array([temperature], np.float32))
        first = int(nxt[0])
        self.lengths[slot] = prompt.size
        self.active[slot] = True
        self.temps[slot] = float(temperature)
        self.seeds[slot] = seed
        self.last_tokens[slot] = first
        self.tokens_out += 1
        return first

    def ensure_capacity(self, slot: int) -> None:
        """Grow the slot's page run if the next step's write would cross a
        page boundary. Raises PagePoolExhausted (eviction policy is the
        scheduler's call, not the engine's)."""
        if self.cache is None:
            return
        if not self.cache.capacity_ok(slot, int(self.lengths[slot]) + 1):
            self.cache.grow(slot)

    @torch.no_grad()
    def step(self) -> np.ndarray:
        """One decode step over every active slot (fixed batch shape).
        Appends the previous sampled token to each slot's cache and samples
        the next; returns the sampled token per slot ([max_slots], only
        active rows meaningful). Host state advances for active slots."""
        t0 = time.perf_counter()
        if (self.lengths[self.active] >= self.max_tokens).any():
            raise ValueError(f"an active slot is at max_tokens={self.max_tokens}")
        regs = torch.from_numpy(np.stack([self.last_tokens, self.lengths,
                                          self.active]).astype(np.int64)).to(self.device)
        table = None
        if self.cache is not None:
            # Host-owned table: checked here, before upload, with no device sync.
            check_page_table(self.cache.page_table, self.cache.allocator.num_pages)
            table = torch.from_numpy(self.cache.page_table).to(self.device)
        logits = self._decode(regs[0], regs[1], regs[2].bool(), table)
        # The token sampled here lands at sequence position ``lengths``
        # (before the increment): the position its draw is keyed on.
        nxt = sample(logits, self.seeds, self.lengths, self.temps)
        tokens = nxt.to(torch.int32).cpu().numpy()
        if self.return_logits:
            self.last_logits = logits.cpu().numpy()
        n_active = int(self.active.sum())
        self.lengths[self.active] += 1
        self.last_tokens[self.active] = tokens[self.active]
        self.steps += 1
        self.tokens_out += n_active
        if self.device_work is not None and n_active > 0:
            # Copying the tokens to the host waited for the step, so this
            # wall is the step's real device+host latency.
            self.device_work(self.model_name, n_active, time.perf_counter() - t0)
        return tokens

    def release(self, slot: int) -> list[int]:
        """Slot exit: recycle its pages, reset its registers. Returns the
        freed page ids."""
        self.active[slot] = False
        self.lengths[slot] = 0
        self.temps[slot] = 0.0
        self.seeds[slot] = 0
        self.last_tokens[slot] = 0
        if self.cache is not None:
            return self.cache.release(slot)
        return []

    # ---- observability / weights ----------------------------------------

    @property
    def slots_active(self) -> int:
        return int(self.active.sum())

    @property
    def pages_free(self) -> int:
        return self.cache.pages_free if self.cache is not None else 0

    def resident_bytes(self) -> int:
        """Device residency of this engine: the weights plus both KV pools
        (paged or contiguous)."""
        weights = sum(t.numel() * t.element_size() for t in self.model.state_dict().values())
        pools = sum(t.numel() * t.element_size() for t in (self._k_state, self._v_state))
        return int(weights + pools)

    def load_variables(self, variables: Mapping) -> None:
        """Hot-swap weights: this package's state dict or the JAX package's
        ``{"params": ...}`` tree (numpy leaves). Copied into the resident
        tensors; the cache and allocator are untouched."""
        load_into(self.model, self.spec.name, variables)

    def summary(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "model": self.model_name,
            "cache": self.cache_mode,
            "max_slots": self.max_slots,
            "slots_active": self.slots_active,
            "steps": self.steps,
            "tokens_out": self.tokens_out,
        }
        if self.cache is not None:
            out["pages"] = self.cache.allocator.summary()
        return out
