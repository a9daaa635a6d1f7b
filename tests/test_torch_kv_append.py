"""KV-append parity: the port's in-place appends vs ferrum_tpu's scatter.

The plain `append_rows` / `append_pages` (the CPU route of the port's
kernel wrappers) must equal the JAX package's `append_rows` /
`append_pages` (its off-TPU scatter, kv_append.py) bit for bit, for
bf16, f32 and int8 caches, with block ids >= B and OOB_SENTINEL
dropped, and must update the cache tensor in place.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (thread count)
from ferrum_tpu.models.llama_family import OOB_SENTINEL as JAX_OOB
from ferrum_tpu.ops.pallas import kv_append as jka
from ferrum_tpu_torch.models.llama_family import OOB_SENTINEL
from ferrum_tpu_torch.ops.kernels import kv_append as tka

B, PAGE, F = 6, 4, 8
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32),
          "int8": (jnp.int8, torch.int8)}


def _arrays(shape, kind, rng):
    if kind == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    return rng.normal(0, 1, shape).astype(np.float32)


def _to_both(a, kind):
    jdt, tdt = DTYPES[kind]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind in "fV" or \
        x.dtype.name == "bfloat16" else x


def test_sentinels_agree():
    assert OOB_SENTINEL == JAX_OOB


@pytest.mark.parametrize("kind", list(DTYPES))
def test_append_rows_matches_jax(kind):
    rng = np.random.default_rng(0)
    cache_j, cache_t = _to_both(_arrays((B, PAGE, F), kind, rng), kind)
    rows_j, rows_t = _to_both(_arrays((7, F), kind, rng), kind)
    blk = np.array([0, 5, B, 2, OOB_SENTINEL, 3, B + 9], np.int32)
    off = np.array([1, 3, 0, 0, 2, 3, 1], np.int32)
    want = jka.append_rows(cache_j, rows_j, jnp.asarray(blk),
                           jnp.asarray(off))
    before = cache_t.clone()
    got = tka.append_rows(cache_t, rows_t, torch.from_numpy(blk),
                          torch.from_numpy(off))
    assert got is cache_t                                   # in place
    np.testing.assert_array_equal(_np(got), _np(want))
    assert not torch.equal(before, cache_t)


@pytest.mark.parametrize("kind", list(DTYPES))
def test_append_pages_matches_jax(kind):
    rng = np.random.default_rng(1)
    cache_j, cache_t = _to_both(_arrays((B, PAGE, F), kind, rng), kind)
    pages_j, pages_t = _to_both(_arrays((4, PAGE, F), kind, rng), kind)
    blk = np.array([4, OOB_SENTINEL, 1, B], np.int32)
    want = jka.append_pages(cache_j, pages_j, jnp.asarray(blk))
    got = tka.append_pages(cache_t, pages_t, torch.from_numpy(blk))
    assert got is cache_t                                   # in place
    np.testing.assert_array_equal(_np(got), _np(want))


def test_decode_append_ids_land_per_layer():
    """The model's layer-merged ids: layer l's row for slot s lands in
    block l*NB + its block, and a dropped slot writes nowhere."""
    from ferrum_tpu_torch.models.llama_family import _layer_block_ids
    nb, layers = 3, 2
    blk = torch.tensor([0, 2, 1])
    valid = torch.tensor([True, False, True])
    ids = _layer_block_ids(blk, valid, layers, nb)
    assert ids.dtype == torch.int32
    assert ids.tolist() == [0, OOB_SENTINEL, 1, 3, OOB_SENTINEL, 4]
