"""Batched on-device sampling: penalties, temperature, top-k, top-p, draw.

Port of `ferrum_tpu/sampling/device.py::sample_step`. Per-slot parameter
tensors select the behaviour branchlessly (temperature == 0 → greedy
argmax; top_k == 0 and top_p == 1 are off). The sampled path draws from
the top TOPK_CAP logits with Gumbel noise. The JAX package derives the
noise from per-slot threefry keys, which PyTorch cannot reproduce: here
it comes from the engine's own `torch.Generator`, or from the `noise`
argument, which is how the parity tests feed both packages the same
draw. A request with its own `seed` draws instead from `seeded_gumbel`,
a counter-based hash of (seed, position of the token drawn, draw kind,
candidate rank) in int64 tensor ops: its tokens do not depend on which
lanes share the step or which slot it holds. `processed_probs` gives the
full distribution a draw is taken from (speculative verification).

Guided decoding: `sample_step(allowed_mask=...)` hard-masks the logits
first; `guided_mask_rows` unpacks each slot's row of the packed FSM
masks and `guided_advance` folds the sampled tokens through the FSM's
transition table, both in plain torch ops with no host sync (the JAX
package computes them in plain XLA, no Pallas kernel).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

TOPK_CAP = 256


class SlotSamplingParams(NamedTuple):
    temperature: torch.Tensor        # f32 [S]
    top_k: torch.Tensor              # int [S] (0 = off)
    top_p: torch.Tensor              # f32 [S] (1.0 = off)
    repetition_penalty: torch.Tensor  # f32 [S] (1.0 = off)
    min_tokens_active: torch.Tensor  # bool [S]: suppress EOS while True


def apply_repetition_penalty(logits: torch.Tensor, counts: torch.Tensor,
                             penalty: torch.Tensor) -> torch.Tensor:
    """Seen tokens: positive logits / p, negative logits * p."""
    p = penalty[:, None]
    penalized = torch.where(logits > 0, logits / p, logits * p)
    return torch.where(counts > 0, penalized, logits)


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """-log(-log(U)), U uniform in [tiny, 1) (jax.random.gumbel's form)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit finalizer (xorshift-multiply) on int64 tensors holding
    values below 2^32; the multipliers stay below 2^31, so no product
    leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


# Draw kinds of the seeded streams: the token draw of a window or
# prefill (kind 0, the first kind), and a speculative round's draft
# noise, accept uniforms and residual noise.
DRAW_SAMPLE, DRAW_DRAFT, DRAW_ACCEPT, DRAW_RESIDUAL = 0, 1, 2, 3


def seeded_uniform(seeds: torch.Tensor, positions: torch.Tensor, k: int,
                   kind: int = DRAW_SAMPLE) -> torch.Tensor:
    """Uniforms f32 [S, k] in (0, 1) of each row's own stream: a hash of
    its int64 seed, the int64 position of the token drawn, the draw kind
    and the rank, made uniform from its top 24 bits."""
    key = _mix32((seeds & _M32) ^ _mix32(((seeds >> 32) & _M32)
                                         ^ 0x9E3779B9))
    key = _mix32((key + _mix32(positions & _M32)) & _M32)
    if kind:
        key = _mix32(key ^ ((kind * 0x632BE5AB) & _M32))
    rank = torch.arange(k, device=seeds.device, dtype=torch.int64)
    h = _mix32((key[:, None] + rank[None, :] * 0x9E3779B9) & _M32)
    h = _mix32(h ^ (key[:, None] >> 7))
    return ((h >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)


def seeded_gumbel(seeds: torch.Tensor, positions: torch.Tensor, k: int,
                  kind: int = DRAW_SAMPLE) -> torch.Tensor:
    """Gumbel noise f32 [S, k] of each row's own stream (`seeded_uniform`
    through -log(-log u))."""
    return -torch.log(-torch.log(seeded_uniform(seeds, positions, k, kind)))


def lane_noise(slots: torch.Tensor, positions: torch.Tensor,
               seeds: torch.Tensor, seeded: torch.Tensor, vocab: int,
               generator: Optional[torch.Generator],
               kind: int = DRAW_SAMPLE) -> torch.Tensor:
    """The sampling noise of one draw for the rows `slots`: the shared
    generator's draw (taken whole, as `sample_step` takes it), replaced
    by `seeded_gumbel` on the rows of a seeded slot. `positions`: each
    row's position of the token drawn."""
    k_cap = min(TOPK_CAP, vocab)
    shared = gumbel_noise((slots.shape[0], k_cap), generator, slots.device)
    own = seeded_gumbel(seeds[slots], positions.to(torch.int64), k_cap, kind)
    return torch.where(seeded[slots][:, None], own, shared)


def topk_ids(x: torch.Tensor, k: int) -> torch.Tensor:
    """Ids of the k largest values of each row of f32 x [S, V], in
    `jax.lax.top_k`'s order: descending in the total order of floats
    (NaN first, +0.0 above -0.0) and, among equal values, lowest id
    first. `torch.topk` promises no order among ties, so it runs on
    unique int64 keys instead: the value's bits as a signed integer of
    the same order (the 31 low bits flipped where the sign bit is set),
    times 2^32, plus V - 1 - id."""
    v = x.shape[-1]
    b = x.contiguous().view(torch.int32)
    b = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    rev = torch.arange(v - 1, -1, -1, device=x.device)
    return torch.topk(b.to(torch.int64) * (1 << 32) + rev, k, dim=-1).indices


def _processed_logits(logits: torch.Tensor, params: SlotSamplingParams,
                      counts: torch.Tensor,
                      eos_ids: Union[Tuple[int, ...], torch.Tensor],
                      allowed_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The guided hard mask, the repetition penalty and the min-tokens EOS
    mask, in the JAX order. `eos_ids` may be a bool [V] mask on the
    logits' device (no host copy)."""
    if allowed_mask is not None:
        logits = torch.where(allowed_mask, logits, float("-inf"))
    logits = apply_repetition_penalty(logits, counts,
                                      params.repetition_penalty)
    eos = eos_ids
    if not isinstance(eos, torch.Tensor):
        eos = torch.zeros(logits.shape[1], dtype=torch.bool,
                          device=logits.device)
        eos[list(eos_ids)] = True
    return torch.where(params.min_tokens_active[:, None] & eos[None, :],
                       float("-inf"), logits)


def _candidates(logits: torch.Tensor, params: SlotSamplingParams):
    """Temperature, top-k (capped at TOPK_CAP) and top-p with rank 0 kept:
    (candidate ids [S, cap], descending; their scaled logits, -inf where
    cut)."""
    temp = params.temperature.clamp_min(1e-5)[:, None]
    k_cap = min(TOPK_CAP, logits.shape[1])
    scaled = logits / temp
    idx = topk_ids(scaled, k_cap)                            # descending
    vals = torch.gather(scaled, 1, idx)
    rank = torch.arange(k_cap, device=logits.device)[None, :]
    k_eff = torch.where(params.top_k[:, None] > 0, params.top_k[:, None],
                        torch.full_like(params.top_k[:, None], k_cap))
    vals = torch.where(rank < k_eff, vals, float("-inf"))
    probs = torch.softmax(vals, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    keep = (cum_before < params.top_p[:, None]) | (rank == 0)
    return idx, torch.where(keep, vals, float("-inf"))


def sample_step(
    logits: torch.Tensor,            # f32 [S, V]
    params: SlotSamplingParams,
    counts: torch.Tensor,            # int [S, V] token-seen counts
    eos_ids: Union[Tuple[int, ...], torch.Tensor],
    *,
    greedy_only: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,   # f32 [S, min(TOPK_CAP, V)]
    allowed_mask: Optional[torch.Tensor] = None,   # bool [S, V] (guided)
) -> torch.Tensor:
    """Returns the sampled tokens, int64 [S]. `greedy_only`: every slot
    has temperature 0, skip the top-k/top-p machinery. `eos_ids` may be
    given as a bool [V] mask on the logits' device (no host copy).
    `allowed_mask`: the guided hard mask, applied before everything else
    (the JAX order: mask, repetition penalty, min_tokens EOS gate); rows
    of unguided slots are all True. A row left with no allowed token
    gives token 0, as jnp.argmax and jax.lax.top_k do."""
    logits = _processed_logits(logits, params, counts, eos_ids,
                               allowed_mask)
    greedy_tok = torch.argmax(logits, dim=-1)
    if greedy_only:
        return greedy_tok
    idx, vals = _candidates(logits, params)
    if noise is None:
        noise = gumbel_noise(vals.shape, generator, logits.device)
    choice = torch.argmax(vals + noise, dim=-1)
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
    return torch.where(params.temperature <= 0.0, greedy_tok, sampled)


def processed_probs(
    logits: torch.Tensor,            # f32 [S, V]
    params: SlotSamplingParams,
    counts: torch.Tensor,            # int [S, V]
    eos_ids: Union[Tuple[int, ...], torch.Tensor],
    allowed_mask: Optional[torch.Tensor] = None,   # bool [S, V] (guided)
) -> torch.Tensor:
    """The full-vocabulary distribution f32 [S, V] that `sample_step`
    draws from: its mask, penalty, EOS mask, temperature, top-k and
    top-p, then the softmax of what is left. Greedy rows (temperature 0)
    get a one-hot at the argmax. Speculative verification's accept ratio
    and residual draw use it (the JAX package's `processed_probs`)."""
    logits = _processed_logits(logits, params, counts, eos_ids,
                               allowed_mask)
    s, v = logits.shape
    # (F.one_hot checks its input's range on the host: a sync.)
    onehot = torch.zeros((s, v), dtype=torch.float32, device=logits.device)
    onehot.scatter_(1, torch.argmax(logits, dim=-1, keepdim=True), 1.0)
    idx, vals = _candidates(logits, params)
    full = torch.zeros((s, v), dtype=torch.float32, device=logits.device)
    full.scatter_(1, idx, torch.softmax(vals, dim=-1))
    return torch.where(params.temperature[:, None] <= 0.0, onehot, full)


def guided_mask_rows(mask_words: torch.Tensor, states: torch.Tensor,
                     vocab: int) -> torch.Tensor:
    """Each slot's packed guided vocab mask, gathered and unpacked to
    bool [S, V]. `mask_words` int32 [R, W] holds the JAX package's
    uint32 words bit for bit; an arithmetic shift then `& 1` reads the
    same bit. Row 0 is the FREE state (all ones): unguided slots sit
    there, so the mask is a no-op for them."""
    rows = mask_words[states]                                 # [S, W]
    shifts = torch.arange(32, dtype=mask_words.dtype,
                          device=mask_words.device)
    bits = (rows[:, :, None] >> shifts) & 1
    return bits.reshape(states.shape[0], -1)[:, :vocab] != 0


def guided_advance(trans: torch.Tensor, token_cps: torch.Tensor,
                   states: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """Fold the sampled tokens' codepoints through the transition table
    (the device form of RegexGuidedProcessor.advance): one gather a
    column of `token_cps` [V, Lmax], all Lmax of them, with no early
    exit (no host sync). PAD columns keep the state, so EOS and special
    tokens (empty text) are no-ops; the FREE row self-loops."""
    cps = token_cps[tokens]                                   # [S, Lmax]
    st = states
    for col in range(cps.shape[1]):
        st = trans[st, cps[:, col]]
    return st


def update_counts(counts: torch.Tensor, slot_ids: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    """counts[slot_ids[i], tokens[i]] += 1, in place. A pair whose slot id
    is outside [0, S) or whose token is outside [0, V) is dropped (the
    JAX package's mode="drop": pad lanes carry slot id S, count pads
    token V), with no host sync: it adds 0 at element 0 instead."""
    s, v = counts.shape
    slot_ids = slot_ids.reshape(-1).to(torch.int64)
    tokens = tokens.reshape(-1).to(torch.int64)
    keep = (slot_ids >= 0) & (slot_ids < s) & (tokens >= 0) & (tokens < v)
    idx = torch.where(keep, slot_ids * v + tokens, torch.zeros_like(tokens))
    counts.view(-1).index_add_(0, idx, keep.to(counts.dtype))
    return counts
