"""KV-append parity: the port's in-place appends vs ferrum_tpu's scatter.

The plain `append_rows` / `append_pages` (the CPU route of the port's
kernel wrappers) must equal the JAX package's `append_rows` /
`append_pages` (its off-TPU scatter, kv_append.py) bit for bit, for
bf16, f32 and int8 caches, with block ids >= B and OOB_SENTINEL
dropped, and must update the cache tensor in place; so must the pairs
wrapper (K and V in one launch on the card) against one JAX
`append_rows` per array. The rows kernel's thread walk (csrc/
kv_append.cu) is emulated in numpy against the plain version.
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


@pytest.mark.parametrize("kind", list(DTYPES))
def test_append_rows_pairs_matches_jax(kind):
    """K and V (and an f32 plane of another width, as int8 KV's scales)
    appended by one pairs call equal one JAX append_rows per array, the
    sentinel and exactly-B ids dropped, each cache updated in place."""
    rng = np.random.default_rng(2)
    blk = np.array([0, 5, B, 2, OOB_SENTINEL, 3, B + 9], np.int32)
    off = np.array([1, 3, 0, 0, 2, 3, 1], np.int32)
    pairs_j, pairs_t = [], []
    for k_, f in ((kind, F), (kind, F), ("f32", 2)):
        cache_j, cache_t = _to_both(_arrays((B, PAGE, f), k_, rng), k_)
        rows_j, rows_t = _to_both(_arrays((7, f), k_, rng), k_)
        pairs_j.append((cache_j, rows_j))
        pairs_t.append((cache_t, rows_t))
    before = [c.clone() for c, _ in pairs_t]
    got = tka.append_rows_pairs(pairs_t, torch.from_numpy(blk),
                                torch.from_numpy(off))
    assert len(got) == 3
    for g, (cache_t, _), (cache_j, rows_j), b4 in zip(got, pairs_t, pairs_j,
                                                      before):
        assert g is cache_t                                 # in place
        want = jka.append_rows(cache_j, rows_j, jnp.asarray(blk),
                               jnp.asarray(off))
        np.testing.assert_array_equal(_np(g), _np(want))
        assert not torch.equal(b4, cache_t)
    with pytest.raises(ValueError):
        tka.append_rows_pairs(pairs_t * 2, torch.from_numpy(blk),
                              torch.from_numpy(off))


# csrc/kv_append.cu's rows kernel: kRowChunks units a thread.
_ROW_CHUNKS = 4


def _rows_walk(pairs, blk, off, vec16):
    """ferrum_kv_append_rows in numpy, thread by thread: the host's
    RowPairs (units -- 16-byte chunks, or bytes --, threads a row, each
    pair's first thread), then every thread g of the grid: its pair (the
    last whose first thread is <= g), row and slot, the row's ids (a
    block id >= B, or a flat row outside the cache, drops it), and units
    slot, slot + tpr, .. copied. Caches are flat uint8 [B * page *
    row_bytes]; returns how often each cache byte was written."""
    n = blk.shape[0]
    b, page = pairs[0][0].shape[:2]
    units, tpr, first, total = [], [], [], 0
    for cache, _ in pairs:
        rb = cache.shape[-1] * cache.itemsize
        units.append(rb >> 4 if vec16 else rb)
        tpr.append(-(-units[-1] // _ROW_CHUNKS))
        first.append(total)
        total += n * tpr[-1]
    size = 16 if vec16 else 1
    writes = [np.zeros(c.nbytes, np.int64) for c, _ in pairs]
    for g in range(total):
        p = 0
        for i in range(1, 4):
            if i < len(pairs) and g >= first[i]:
                p = i
        row = (g - first[p]) // tpr[p]
        slot = g - first[p] - row * tpr[p]
        bb = int(np.uint32(blk[row]))
        if bb >= b:
            continue
        flat = bb * page + int(off[row])
        if flat < 0 or flat >= b * page:
            continue
        cache, rows = (a.view(np.uint8).reshape(-1) for a in pairs[p])
        for i in range(_ROW_CHUNKS):
            u = slot + i * tpr[p]
            if u < units[p]:
                dst = (flat * units[p] + u) * size
                src = (row * units[p] + u) * size
                cache[dst:dst + size] = rows[src:src + size]
                writes[p][dst:dst + size] += 1
    return writes


@pytest.mark.parametrize("widths,vec16", [
    ((8, 8), True),                 # bf16 rows of 16 bytes: one unit a row
    ((72, 72, 4), True),            # 144-byte rows: 9 units over 3 threads
    ((40, 40, 4, 4), True),         # four pairs: K, V and two scale planes
    ((7, 7), False),                # 14-byte rows: the byte path
])
def test_rows_kernel_walk_matches_plain(widths, vec16):
    """The rows kernel's decomposition of (pair, row, unit) over threads
    writes every byte of every kept row exactly once, nothing else, and
    gives the plain per-array appends bit for bit (bf16 K / V, f32 scale
    planes of another width)."""
    import os
    src = open(os.path.join(os.path.dirname(__file__), os.pardir,
                            "ferrum_tpu_torch", "ops", "kernels", "csrc",
                            "kv_append.cu")).read()
    assert f"constexpr int kRowChunks = {_ROW_CHUNKS};" in src
    rng = np.random.default_rng(sum(widths))
    blk = np.array([0, 5, B, 2, OOB_SENTINEL, 3, B + 9, -1, 4], np.int32)
    off = np.array([1, 3, 0, 0, 2, 3, 1, 0, 2], np.int32)
    pairs_np, pairs_t = [], []
    for i, f in enumerate(widths):
        dt = np.float32 if i >= 2 else np.float16    # f16: bf16's bytes
        cache = rng.normal(0, 1, (B, PAGE, f)).astype(dt)
        rows = rng.normal(0, 1, (blk.size, f)).astype(dt)
        pairs_np.append((cache, rows))
        pairs_t.append((torch.from_numpy(cache.copy()),
                        torch.from_numpy(rows)))
    writes = _rows_walk(pairs_np, blk, off, vec16)
    want = tka.append_rows_pairs_plain(pairs_t, torch.from_numpy(blk),
                                       torch.from_numpy(off))
    kept = [(int(b), int(o)) for b, o in zip(blk, off) if 0 <= b < B]
    for (cache, _), w, wt in zip(pairs_np, writes, want):
        np.testing.assert_array_equal(cache, wt.numpy())
        per_row = w.reshape(B, PAGE, -1)
        assert (per_row[tuple(np.array(kept).T)] == 1).all()
        assert per_row.sum() == len(kept) * per_row.shape[-1]


def test_decode_step_appends_k_and_v_in_one_call(monkeypatch):
    """decode_forward hands K and V of every (layer, slot) to one
    append_rows_pairs call (one kv_append_rows launch a step on the
    card), with the layer-merged ids."""
    from ferrum_tpu_torch.models import llama_family as lf
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.quantize import init_random_quant_params

    cfg = preset("tiny-quant")
    params = init_random_quant_params(cfg, seed=0, device="cpu",
                                      dtype=torch.float32)
    slots, page, nb = 2, 4, 4
    calls = []

    def spy(pairs, block_ids, offsets):
        calls.append(([tuple(r.shape) for _, r in pairs], block_ids.clone()))
        return tka.append_rows_pairs_plain(pairs, block_ids, offsets)

    monkeypatch.setattr(lf, "append_rows_pairs", spy)
    kv = lf.PagedKvCache.create(cfg, slots * nb, page, dtype=torch.float32,
                                device="cpu")
    pos = torch.tensor([2, 5])
    tables = torch.arange(slots * nb).reshape(slots, nb)
    flat = torch.tensor([2, OOB_SENTINEL])
    _, kv = lf.decode_forward(params, cfg, kv, torch.tensor([3, 4]), pos,
                              tables, pos + 1, flat, ctx_pad=8)
    rows = cfg.num_layers * slots
    assert [c[0] for c in calls] == [[(rows, cfg.kv_size)] * 2]
    assert calls[0][1].tolist() == [0, OOB_SENTINEL, slots * nb,
                                    OOB_SENTINEL]
    assert bool(kv.k[:, 0, 2].abs().sum(-1).gt(0).all())
    assert bool(kv.v[:, 0, 2].abs().sum(-1).gt(0).all())
