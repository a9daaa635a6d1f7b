"""Batched on-device sampling: penalties, temperature, top-k, top-p, draw.

Port of `ferrum_tpu/sampling/device.py::sample_step`. Per-slot parameter
tensors select the behaviour branchlessly (temperature == 0 → greedy
argmax; top_k == 0 and top_p == 1 are off). The sampled path draws from
the top TOPK_CAP logits with Gumbel noise. The JAX package derives the
noise from per-slot threefry keys, which PyTorch cannot reproduce: here
it comes from the engine's own `torch.Generator`, or from the `noise`
argument, which is how the parity tests feed both packages the same
draw.
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


def sample_step(
    logits: torch.Tensor,            # f32 [S, V]
    params: SlotSamplingParams,
    counts: torch.Tensor,            # int [S, V] token-seen counts
    eos_ids: Union[Tuple[int, ...], torch.Tensor],
    *,
    greedy_only: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,   # f32 [S, min(TOPK_CAP, V)]
) -> torch.Tensor:
    """Returns the sampled tokens, int64 [S]. `greedy_only`: every slot
    has temperature 0, skip the top-k/top-p machinery. `eos_ids` may be
    given as a bool [V] mask on the logits' device (no host copy)."""
    s, v = logits.shape
    logits = apply_repetition_penalty(logits, counts,
                                      params.repetition_penalty)
    eos = eos_ids
    if not isinstance(eos, torch.Tensor):
        eos = torch.zeros(v, dtype=torch.bool, device=logits.device)
        eos[list(eos_ids)] = True
    logits = torch.where(params.min_tokens_active[:, None] & eos[None, :],
                         float("-inf"), logits)
    greedy_tok = torch.argmax(logits, dim=-1)
    if greedy_only:
        return greedy_tok

    temp = params.temperature.clamp_min(1e-5)[:, None]
    k_cap = min(TOPK_CAP, v)
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
    vals = torch.where(keep, vals, float("-inf"))
    if noise is None:
        noise = gumbel_noise((s, k_cap), generator, logits.device)
    choice = torch.argmax(vals + noise, dim=-1)
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
    return torch.where(params.temperature <= 0.0, greedy_tok, sampled)


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
