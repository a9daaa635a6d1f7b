"""Model-level parity: ferrum_tpu_torch vs ferrum_tpu on the same weights.

Batched prefill logits and four decode steps' logits of the port's
linear-layout model (llama_family.prefill_forward_batched /
decode_forward, CPU, f32) against the JAX package's functions on the
weights carried over by `params_from_numpy`. `tiny-quant` runs the
two-level int4 path (JAX side routed to its w4a8tl oracle); `tiny-test`
is the dense 2-layer qwen3-style trunk (QK-norm, tied embeddings).
"""

import numpy as np
import pytest
import torch

from torch_parity import (flatten_jax_params, jax_model, route_w4a8tl,
                          torch_config)

SLOTS, PAGE, MAX_LEN, CTX = 2, 16, 128, 64
PROMPT_LENS = (20, 32)
T_PAD = 32
DECODE_STEPS = 4


def _inputs(vocab, seed=0):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((SLOTS, T_PAD), np.int32)
    positions = np.full((SLOTS, T_PAD), MAX_LEN + CTX, np.int32)
    flat = np.full((SLOTS, T_PAD), 1 << 30, np.int32)
    for s, n in enumerate(PROMPT_LENS):
        tokens[s, :n] = rng.integers(3, vocab, n)
        positions[s, :n] = np.arange(n)
        flat[s, :n] = s * MAX_LEN + np.arange(n)
    tables = (np.arange(SLOTS)[:, None] * (MAX_LEN // PAGE)
              + np.arange(MAX_LEN // PAGE)[None, :]).astype(np.int32)
    return tokens, positions, flat, tables, np.asarray(PROMPT_LENS, np.int32)


def _run_jax(cfg, params, inputs):
    import functools

    import jax
    import jax.numpy as jnp

    from ferrum_tpu.models.llama_family import (
        PagedKvCache, decode_forward, logits_from_hidden,
        prefill_forward_batched)

    # Private jit wrappers: traced under this test's w4a8tl routing.
    prefill = jax.jit(functools.partial(
        prefill_forward_batched, cfg=cfg, ctx_pad=CTX, attn_impl="linear",
        append="pages"))
    decode = jax.jit(functools.partial(
        decode_forward, cfg=cfg, ctx_pad=CTX, attn_impl="linear"))
    tokens, positions, flat, tables, lens = inputs
    kv = PagedKvCache.create(cfg, SLOTS * MAX_LEN // PAGE, PAGE,
                             dtype=jnp.float32)
    h, kv = prefill(params, kv=kv, tokens=tokens, positions=positions,
                    block_tables=tables, total_lens=lens, flat_slots=flat)
    out = [np.asarray(logits_from_hidden(params, cfg,
                                         h.reshape(-1, h.shape[-1])))]
    last = out[0].reshape(SLOTS, T_PAD, -1)[np.arange(SLOTS), lens - 1]
    tok = last.argmax(-1).astype(np.int32)
    fed = []
    for step in range(DECODE_STEPS):
        pos = lens + step
        fed.append(tok)
        h, kv = decode(
            params, kv=kv, tokens=tok, positions=pos, block_tables=tables,
            context_lens=pos + 1,
            flat_slots=np.arange(SLOTS, dtype=np.int32) * MAX_LEN + pos)
        lg = np.asarray(logits_from_hidden(params, cfg, h))
        out.append(lg)
        tok = lg.argmax(-1).astype(np.int32)
    return out, fed


def _run_torch(cfg, params, inputs, fed):
    from ferrum_tpu_torch.models.llama_family import (
        PagedKvCache, decode_forward, logits_from_hidden,
        prefill_forward_batched)

    tokens, positions, flat, tables, lens = inputs
    t = lambda a: torch.from_numpy(np.asarray(a)).to(torch.int64)  # noqa
    kv = PagedKvCache.create(cfg, SLOTS * MAX_LEN // PAGE, PAGE,
                             dtype=torch.float32, device="cpu")
    h, kv = prefill_forward_batched(
        params, cfg, kv, t(tokens), t(positions), t(tables), t(lens),
        t(flat), ctx_pad=CTX)
    out = [logits_from_hidden(params, cfg, h.reshape(-1, h.shape[-1]))]
    for step, tok in enumerate(fed):
        pos = lens + step
        h, kv = decode_forward(
            params, cfg, kv, t(tok), t(pos), t(tables), t(pos + 1),
            t(np.arange(SLOTS) * MAX_LEN + pos), ctx_pad=CTX)
        out.append(logits_from_hidden(params, cfg, h))
    return [o.numpy() for o in out]


# Tolerances, f32 throughout. Dense: both packages do the same f32 math in
# another summation order (measured ~3e-7 of the logit scale), so 1e-5 of
# the scale. Quantized: the int8 activation rounding is exact for equal
# inputs, but an f32 ulp upstream can move one x/s across a .5 boundary;
# a flipped xq changes one product term by |w8| * s_x * chan, up to ~1e-2
# of the logit scale on these weights, so the int4 case allows 5e-2 of
# the scale and requires 99% of the logits within 1e-5 of the scale.
@pytest.mark.parametrize("preset_name,quantized",
                         [("tiny-quant", True), ("tiny-test", False)])
def test_prefill_and_decode_logits_match_jax(monkeypatch, preset_name,
                                             quantized):
    from ferrum_tpu_torch.models.convert import params_from_numpy

    route_w4a8tl(monkeypatch)
    jcfg, jparams = jax_model(preset_name, quantized)
    cfg = torch_config(jcfg)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    inputs = _inputs(cfg.vocab_size)
    want, fed = _run_jax(jcfg, jparams, inputs)
    got = _run_torch(cfg, params, inputs, fed)
    real = (inputs[1] < MAX_LEN).reshape(-1)
    want[0], got[0] = want[0][real], got[0][real]
    for w, g in zip(want, got):
        scale = np.abs(w).max()
        err = np.abs(w - g)
        if quantized:
            assert err.max() <= 5e-2 * scale, err.max() / scale
            assert np.mean(err <= 1e-5 * scale) >= 0.99
        else:
            np.testing.assert_allclose(g, w, atol=1e-5 * scale, rtol=0)
