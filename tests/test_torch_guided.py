"""Guided decoding: ferrum_tpu_torch against ferrum_tpu on the same inputs.

Every comparison here is exact (tolerance 0): regex verdicts and DFA
state ids, schema regex strings, validation verdicts, per-state vocab
masks, the device-FSM tables (bit for bit), the mask unpack and the FSM
advance on the port's device functions, sampled tokens under a mask
(the same Gumbel noise fed to both), `sample_host`'s token from the same
`np.random.Generator`, and the engines' greedy guided streams on
tiny-quant (seed 3, the parity tests' weights) on the device-FSM and the
host-masked path, on both KV layouts: alone, in a mixed batch with
plain, stop-string and seeded lanes, and resumed after a recompute
preemption. Sampled guided output stays in the language. Inputs come
from seeded numpy generators and hypothesis.
"""

import queue
import time

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

import test_torch_engine as te
from torch_parity import (flatten_jax_params, jax_model, route_w4a8tl,
                          torch_config)

SERVE_TIMEOUT_S = 120.0

# tests/test_guided.py's and tests/test_guided_device.py's patterns, the
# engine tests' patterns and the JSON mode regex.
PATTERNS = [
    r"abc", r"a+b*", r"(foo|bar)+", r"[a-c]{2,3}", r"-?\d+(\.\d+)?",
    r'"([^"\\]|\\.)*"', r"a{3}", r"x{2,}", r"[^0-9]+", r"a\.b",
    r"hello world", r"(yes|no)", r'\{"a": (true|false)\}', r"[a-c]{2,3}x+",
    r"-?\d\d", r"(foo|bar)+x", r"(red|green|blue)", r"(ab|cd)+",
    r"(?:x|y)?z\s*\w\W\S\D", r"[a-]+[-z]*",
    # accepted, read as the JAX compiler reads them
    r"^a", r"a$", r"a*?", r"a**", r"[[:alpha:]]",
]
# Constructs both compilers refuse.
UNSUPPORTED = [r"(?P<name>x)", r"a{1,10000}", r"a\1", r"(?=a)b", r"(a",
               r"a)", r"[a", r"\p{L}", r"a{2,1}", r"a\b", r"(?i)a", r"\x41",
               r"(?:a", r"a|*"]
ALPHABET = "abcdefrxyzo0123456789-.\\\"{}: \tnsgul!?"

SCHEMAS = [
    {"type": "object", "properties": {"name": {"type": "string"},
                                      "age": {"type": "integer"}},
     "required": ["name", "age"], "additionalProperties": False},
    {"type": "object", "properties": {"color": {"enum": ["red", "green"]},
                                      "ok": {"type": "boolean"}},
     "required": ["color", "ok"]},
    {"type": "object", "properties": {"xs": {"type": "array",
                                             "items": {"type": "integer"}}},
     "required": ["xs"]},
    {"type": "object", "properties": {"inner": {
        "type": "object", "properties": {"v": {"type": "number"}},
        "required": ["v"]}}, "required": ["inner"]},
    {"name": "w", "strict": True, "schema": {
        "type": "object", "properties": {"a": {"type": "integer"},
                                         "b": {"type": "null"}},
        "required": ["a"]}},
    {"type": "object", "properties": {"e": {"enum": [1, 2.5, True, "x.y"]},
                                      "ys": {"type": "array", "minItems": 1,
                                             "items": {"type": "string"}}}},
    # Refused: additionalProperties, a top-level scalar, no properties, a
    # oneOf, an optional key before a required one, maxItems, depth.
    {"type": "object", "properties": {"x": {"type": "string"}},
     "additionalProperties": True},
    {"type": "string"},
    {"type": "object", "properties": {}},
    {"type": "object", "properties": {"x": {"oneOf": [{"type": "string"}]}},
     "required": ["x"]},
    {"type": "object", "properties": {"a": {"type": "string"},
                                      "b": {"type": "string"}},
     "required": ["b"]},
    {"type": "object", "properties": {"xs": {"type": "array", "maxItems": 2,
                                             "items": {"type": "string"}}}},
    {"type": "object", "properties": {"k": {"enum": [None]}}},
]
SCHEMA = SCHEMAS[0]


def _both(fn):
    """fn(module prefix) for both packages: ('ok', value) or ('raise',
    error class name, message)."""
    out = []
    for pkg in ("ferrum_tpu_torch", "ferrum_tpu"):
        try:
            out.append(("ok", fn(pkg)))
        except Exception as e:                  # compared, not swallowed
            out.append(("raise", type(e).__name__, str(e)))
    return out


def _mods(name):
    import importlib
    return (importlib.import_module(f"ferrum_tpu_torch.sampling.{name}"),
            importlib.import_module(f"ferrum_tpu.sampling.{name}"))


# ---------------------------------------------------------------------------
# regex DFA
# ---------------------------------------------------------------------------

_DFAS = {}


def _dfas(pattern):
    if pattern not in _DFAS:
        mine, ref = _mods("regex_dfa")
        _DFAS[pattern] = (mine.compile_regex(pattern),
                          ref.compile_regex(pattern))
    return _DFAS[pattern]


def _walk_trace(dfa, text):
    """Per prefix: the state id (None when dead), accepting, live out."""
    out, st = [], dfa.start
    for ch in text:
        st = dfa.step(st, ord(ch))
        if st is None:
            out.append(None)
            break
        out.append((st, dfa.is_accepting(st), dfa.has_live_out(st)))
    w = dfa.walk(dfa.start, text)
    return out, w, dfa.fullmatch(text)


@pytest.mark.parametrize("pattern", PATTERNS)
@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(text=st.text(alphabet=ALPHABET, max_size=14))
def test_regex_walk_and_fullmatch_match_jax(pattern, text):
    mine, ref = _dfas(pattern)
    assert _walk_trace(mine, text) == _walk_trace(ref, text), (pattern, text)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_regex_fixed_strings_match_jax(pattern):
    """Each pattern's own matches and near misses (tests/test_guided.py's
    strings and more): the same verdicts and state ids."""
    strings = ["", "abc", "ab", "abcd", "aab", "foo", "barfoo", "fob", "42",
               "-3.14", "1.", '"hi"', '"a\\"b"', '"\\"', "aaa", "xxxx",
               "a1", "a.b", "hello world", "help", "yes", "no", "nox",
               '{"a": true}', '{"a": tru', "abx", "abcxx", "-12", "foobarx",
               "green", "abcdab", "xz  a!", "z_ ?7", "a-z", "--zz"]
    mine, ref = _dfas(pattern)
    for s in strings:
        assert _walk_trace(mine, s) == _walk_trace(ref, s), (pattern, s)


@pytest.mark.parametrize("pattern", UNSUPPORTED)
def test_regex_fail_fast_matches_jax(pattern):
    got, want = _both(lambda pkg: __import__(
        f"{pkg}.sampling.regex_dfa", fromlist=["x"]).compile_regex(
            pattern).fullmatch("a"))
    assert got == want
    assert got[0] == "raise" and got[1] == "NotSupportedError", got


# ---------------------------------------------------------------------------
# schema -> regex, validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_schema_to_regex_matches_jax(i):
    got, want = _both(lambda pkg: __import__(
        f"{pkg}.sampling.schema", fromlist=["x"]).schema_to_regex(
            SCHEMAS[i]))
    assert got == want


VALIDATE = [
    ('{"name": "bob", "age": 42}', 0), ('{ "name" : "x" , "age" : -1 }', 0),
    ('{"age": 42, "name": "bob"}', 0), ('{"name": "bob"}', 0),
    ('{"color": "red", "ok": true}', 1), ('{"color": "blue", "ok": true}', 1),
    ('{"xs": [1, 2, 3]}', 2), ('{"xs": []}', 2), ('{"xs": [1, "a"]}', 2),
    ('{"inner": {"v": 1.5}}', 3), ('{"a": 3}', 4), ('{"a": 3, "b": null}', 4),
    ('{"a": "x"}', 4), ('{"e": 2.5, "ys": ["q"]}', 5), ('{"e": 3}', 5),
    ('{"x": "y"}', 6), ('"s"', 7), ("{}", 8),
]


@pytest.mark.parametrize("text,i", VALIDATE)
def test_validate_json_against_subset_matches_jax(text, i):
    got, want = _both(lambda pkg: __import__(
        f"{pkg}.sampling.schema", fromlist=["x"]
    ).validate_json_against_subset(text, SCHEMAS[i]))
    assert got == want and got[0] == "ok"


# ---------------------------------------------------------------------------
# Host processors, vocab tables, device-FSM tables
# ---------------------------------------------------------------------------

def _byte_toks(extra=0):
    from ferrum_tpu.tokenizer import make_byte_tokenizer as jtok
    from ferrum_tpu_torch.tokenizer import make_byte_tokenizer
    return make_byte_tokenizer(extra), jtok(extra)


_TOKJSON = {}


def _json_toks(tmp_path_factory):
    """The llama3-form tokenizer.json tokenizer of
    tests/test_torch_tokenizer.py: (the port's, the JAX package's)."""
    if not _TOKJSON:
        import test_torch_tokenizer as tt
        _TOKJSON["llama3"] = tt.pair("llama3", tmp_path_factory)
    return _TOKJSON["llama3"]


@pytest.mark.parametrize("pattern", PATTERNS[:10] + [
    r'\{"a": (true|false)\}', r"(foo|bar)+x"])
def test_processor_masks_match_jax(pattern):
    """RegexGuidedProcessor: the same allowed mask at every state of five
    seeded trajectories, the same states and completion."""
    mg, rg = _mods("guided")
    mt, rt = _byte_toks()
    mine = mg.RegexGuidedProcessor(_mods("regex_dfa")[0].compile_regex(
        pattern), mt)
    ref = rg.RegexGuidedProcessor(_mods("regex_dfa")[1].compile_regex(
        pattern), rt)
    rng = np.random.default_rng(0)
    for _ in range(5):
        for p in (mine, ref):
            p.state, p._complete = p.dfa.start, False
        for _step in range(10):
            m = mine.allowed_mask()
            np.testing.assert_array_equal(m, ref.allowed_mask())
            allowed = np.flatnonzero(m)
            if not len(allowed) or mine.is_complete():
                break
            tid = int(rng.choice(allowed))
            mine.advance(None, tid)
            ref.advance(None, tid)
            assert (mine.state, mine.is_complete()) \
                == (ref.state, ref.is_complete())


def test_json_mode_and_builder_match_jax():
    """JSON_REGEX is the JAX string; build_guided_processor takes the
    same branch for each option and the same masks along a trajectory;
    empty options raise alike."""
    mg, rg = _mods("guided")
    assert mg.JsonModeProcessor.JSON_REGEX == rg.JsonModeProcessor.JSON_REGEX
    from ferrum_tpu.types import GuidedOptions as JOpts
    from ferrum_tpu_torch.types import GuidedOptions
    mt, rt = _byte_toks()
    for kw in (dict(json_mode=True), dict(regex="(a|bc)+"),
               dict(json_schema=SCHEMA)):
        mine = mg.build_guided_processor(GuidedOptions(**kw), mt)
        ref = rg.build_guided_processor(JOpts(**kw), rt)
        assert type(mine).__name__ == type(ref).__name__
        for ch in '{"name": "b':
            np.testing.assert_array_equal(mine.allowed_mask(),
                                          ref.allowed_mask())
            tid = mt.encode(ch)[0]
            if not mine.allowed_mask()[tid]:
                break
            mine.advance(None, tid)
            ref.advance(None, tid)
    assert _both(lambda pkg: __import__(
        f"{pkg}.sampling.guided", fromlist=["x"]).build_guided_processor(
            __import__(f"{pkg}.types", fromlist=["x"]).GuidedOptions(),
            mt if pkg == "ferrum_tpu_torch" else rt)) \
        == [("raise", "NotSupportedError", "guided options empty")] * 2


def _fsm_pair(pattern, toks, vocab):
    (mr, rr), (mf, rf) = _mods("regex_dfa"), _mods("token_fsm")
    out = []
    for r, f, tok in ((mr, mf, toks[0]), (rr, rf, toks[1])):
        try:
            vt = f.vocab_table(tok, vocab)
            out.append((vt, f.build_token_fsm(r.compile_regex(pattern), vt,
                                              vocab)))
        except Exception as e:                  # compared below
            out.append((type(e).__name__, str(e)))
    return out


def _assert_fsm_equal(mine, ref):
    (mvt, mfsm), (rvt, rfsm) = mine, ref
    np.testing.assert_array_equal(mvt.token_cps, rvt.token_cps)
    assert mvt.token_cps.dtype == rvt.token_cps.dtype == np.int32
    np.testing.assert_array_equal(mvt.valid, rvt.valid)
    assert mvt.eos_ids == rvt.eos_ids
    for name in ("trans", "mask_words", "accepting"):
        a, b = getattr(mfsm, name), getattr(rfsm, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name     # bit for bit
    assert (mfsm.start, mfsm.dead, mfsm.dfa_to_local) \
        == (rfsm.start, rfsm.dead, rfsm.dfa_to_local)


@pytest.mark.parametrize("extra", [0, 30])
@pytest.mark.parametrize("pattern", [
    r"(yes|no)", r"-?\d+(\.\d+)?", r'\{"a": (true|false)\}', r"[a-c]{2,3}x+",
    r'"([^"\\]|\\.)*"', "JSON", "SCHEMA"])
def test_token_fsm_matches_jax_byte_tokenizer(pattern, extra):
    """vocab_table and build_token_fsm on the byte tokenizer (with extra
    tokens, as an engine's model vocab gives it) and a model vocab 37
    rows past the tokenizer's: every array bit for bit."""
    from ferrum_tpu_torch.sampling.guided import JsonModeProcessor
    from ferrum_tpu_torch.sampling.schema import schema_to_regex
    pattern = {"JSON": JsonModeProcessor.JSON_REGEX,
               "SCHEMA": schema_to_regex(SCHEMA)}.get(pattern, pattern)
    toks = _byte_toks(extra)
    mine, ref = _fsm_pair(pattern, toks, toks[0].vocab_size + 37)
    _assert_fsm_equal(mine, ref)
    vt = mine[0]
    assert not vt.valid[toks[0].vocab_size:].any()
    assert (vt.token_cps[toks[0].vocab_size:] == 257).all()


@pytest.mark.parametrize("pattern", [r"(yes|no)", r"[a-z ]{1,12}\.",
                                     "SCHEMA", r"(ab|cd)+"])
def test_token_fsm_matches_jax_tokenizer_json(tmp_path_factory, pattern):
    """The same on a trained llama3-form tokenizer.json (multi-byte BPE
    tokens, specials, the EOS ids of its generation config)."""
    from ferrum_tpu_torch.sampling.schema import schema_to_regex
    pattern = schema_to_regex(SCHEMA) if pattern == "SCHEMA" else pattern
    toks = _json_toks(tmp_path_factory)
    mine, ref = _fsm_pair(pattern, toks, toks[0].vocab_size)
    _assert_fsm_equal(mine, ref)
    assert mine[0].token_cps.shape[1] > 1


@pytest.mark.parametrize("pattern", [r"[a-z]+(ā)?", "Ā|b",
                                     r"(a|b){5000}"])
def test_token_fsm_refusals_match_jax(pattern):
    """A state that tells codepoints >= 256 apart, and an FSM past
    MAX_STATES: the same NotSupportedError (the host-masked path)."""
    mine, ref = _fsm_pair(pattern, _byte_toks(), 258)
    assert mine == ref and mine[0] == "NotSupportedError", mine


def test_vocab_table_is_cached_per_tokenizer():
    from ferrum_tpu_torch.sampling.token_fsm import vocab_table
    tok = _byte_toks()[0]
    assert vocab_table(tok, 258) is vocab_table(tok, 258)
    assert vocab_table(tok, 300) is not vocab_table(tok, 258)


# ---------------------------------------------------------------------------
# Device functions and sampling under a mask
# ---------------------------------------------------------------------------

def _stacked_tables(vocab=258 + 30):
    """Two FSMs stacked under a FREE row as the runners stack them:
    (trans int32, mask words uint32, token_cps int32, the FSMs' global
    dead rows)."""
    from ferrum_tpu.sampling.regex_dfa import compile_regex
    from ferrum_tpu.sampling.token_fsm import build_token_fsm, vocab_table
    tok = _byte_toks(30)[1]
    vt = vocab_table(tok, vocab)
    trans = [np.zeros((1, 258), np.int32)]
    mask = [np.full((1, (vocab + 31) // 32), 0xFFFFFFFF, np.uint32)]
    dead = []
    for p in (r'\{"a": (true|false)\}', r"-?\d+(\.\d+)?"):
        fsm = build_token_fsm(compile_regex(p), vt, vocab)
        off = sum(t.shape[0] for t in trans)
        trans.append(fsm.trans + off)
        mask.append(fsm.mask_words)
        dead.append(off + fsm.dead)
    return np.concatenate(trans), np.concatenate(mask), vt.token_cps, dead


def test_guided_mask_rows_and_advance_match_jax():
    """guided_mask_rows on the int32 view of the uint32 words and
    guided_advance: bit for bit the JAX functions' results, over every
    row and 64 seeded (state, token) pairs."""
    import jax.numpy as jnp

    from ferrum_tpu.sampling import device as jd
    from ferrum_tpu_torch.sampling import device as td
    trans, mask, cps, _ = _stacked_tables()
    vocab = cps.shape[0]
    rows = np.arange(trans.shape[0], dtype=np.int32)
    want = np.asarray(jd.guided_mask_rows(jnp.asarray(mask),
                                          jnp.asarray(rows), vocab))
    got = td.guided_mask_rows(torch.from_numpy(mask.view(np.int32)),
                              torch.from_numpy(rows), vocab)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0].all() and not want[1:].all()
    rng = np.random.default_rng(5)
    st_ = rng.integers(0, trans.shape[0], 64).astype(np.int32)
    tok = rng.integers(0, vocab, 64).astype(np.int32)
    want = np.asarray(jd.guided_advance(jnp.asarray(trans), jnp.asarray(cps),
                                        jnp.asarray(st_), jnp.asarray(tok)))
    got = td.guided_advance(torch.from_numpy(trans), torch.from_numpy(cps),
                            torch.from_numpy(st_),
                            torch.from_numpy(tok).long())
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[st_ == 0] == 0).all()           # FREE self-loops


_MASK_CASES = ["greedy", "sampled", "dead_state", "min_tokens_eos_only",
               "penalty_then_mask"]


@pytest.mark.parametrize("case", _MASK_CASES)
def test_sample_step_with_mask_matches_jax(case):
    """sample_step(allowed_mask=...) against the JAX sample_step on the
    same logits, counts, params and Gumbel noise: the mask goes before
    the repetition penalty and the min_tokens EOS gate. Rows: FREE, two
    FSM states, the dead state (EOS alone) and a row with nothing
    allowed (the dead state under min_tokens): token 0, as jnp.argmax
    and jax.lax.top_k give it."""
    import jax
    import jax.numpy as jnp

    from ferrum_tpu.sampling import device as jd
    from ferrum_tpu_torch.sampling import device as td
    from test_torch_ops import _jax_noise
    trans, mask, cps, dead = _stacked_tables()
    v = cps.shape[0]
    rng = np.random.default_rng(_MASK_CASES.index(case))
    # FREE, FSM 1's start and next state, its dead row twice, FSM 2's.
    states = np.array([0, 1, 2, dead[0], dead[0], dead[1]], np.int32)
    s = len(states)
    logits = rng.normal(0, 3, (s, v)).astype(np.float32)
    counts = (rng.random((s, v)) < (0.2 if "penalty" in case else 0.0)
              ).astype(np.int32)
    greedy = case in ("greedy", "dead_state", "min_tokens_eos_only")
    temp = np.zeros(s, np.float32) if greedy else np.array(
        [0.7, 1.0, 1.3, 0.9, 0.5, 1.1], np.float32)
    top_k = np.array([0, 5, 0, 3, 0, 40], np.int32)
    top_p = np.array([1.0, 0.9, 0.6, 1.0, 1.0, 0.95], np.float32)
    pen = np.full(s, 1.8 if "penalty" in case else 1.0, np.float32)
    min_act = np.zeros(s, bool)
    if case == "min_tokens_eos_only":
        min_act[4] = True
    eos = (257,)
    keys = np.asarray(jax.vmap(lambda i: jax.random.key_data(
        jax.random.PRNGKey(i)))(jnp.arange(s)))
    allowed = np.asarray(jd.guided_mask_rows(jnp.asarray(mask),
                                             jnp.asarray(states), v))
    want, _ = jd.sample_step(
        jnp.asarray(logits),
        jd.SlotSamplingParams(jnp.asarray(temp), jnp.asarray(top_k),
                              jnp.asarray(top_p), jnp.asarray(pen),
                              jnp.asarray(min_act)),
        jnp.asarray(counts), jnp.asarray(keys), eos,
        greedy_only=greedy, allowed_mask=jnp.asarray(allowed))
    params = td.SlotSamplingParams(
        torch.from_numpy(temp), torch.from_numpy(top_k).long(),
        torch.from_numpy(top_p), torch.from_numpy(pen),
        torch.from_numpy(min_act))
    got = td.sample_step(
        torch.from_numpy(logits), params, torch.from_numpy(counts), eos,
        greedy_only=greedy,
        noise=torch.from_numpy(_jax_noise(keys, min(td.TOPK_CAP, v)).copy()),
        allowed_mask=td.guided_mask_rows(
            torch.from_numpy(mask.view(np.int32)), torch.from_numpy(states),
            v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = got.numpy()
    assert allowed[np.arange(s), got][:4].all()
    if greedy:
        assert got[3] == 257                    # the dead state: EOS
    if case == "min_tokens_eos_only":
        assert got[4] == 0                      # nothing allowed


_HOST_CASES = [dict(temperature=0.0), dict(temperature=0.8),
               dict(temperature=1.2, top_k=7), dict(temperature=0.6,
                                                    top_p=0.7),
               dict(temperature=0.0, repetition_penalty=1.5),
               dict(temperature=0.9, top_k=20, top_p=0.9,
                    repetition_penalty=1.3)]


@pytest.mark.parametrize("i", range(len(_HOST_CASES)))
def test_sample_host_matches_jax(i):
    """sample_host with the same logits, history, mask and a fresh
    np.random.default_rng of the same seed: the same token, over 20
    seeded draws."""
    from ferrum_tpu.sampling.host import sample_host as jsh
    from ferrum_tpu.types import SamplingParams as JSp
    from ferrum_tpu_torch.sampling.host import sample_host
    from ferrum_tpu_torch.types import SamplingParams
    rng = np.random.default_rng(100 + i)
    for k in range(20):
        logits = rng.normal(0, 2, 300).astype(np.float32)
        hist = rng.integers(0, 300, 12).tolist()
        mask = rng.random(300) < 0.3
        mask[int(np.argmax(logits))] = True      # keep top-k non-empty
        got = sample_host(logits, SamplingParams(**_HOST_CASES[i]), hist,
                          np.random.default_rng(k), mask=mask)
        want = jsh(logits, JSp(**_HOST_CASES[i]), hist,
                   np.random.default_rng(k), mask=mask)
        assert got == want and mask[got]


def test_sample_host_with_nothing_allowed_fails_as_jax():
    """The host chain masks AFTER top-k: a sampled request whose top-k
    tokens are all disallowed is left with no token, and the JAX
    sample_host raises there (ROADMAP Queue 3). The port's copy does
    the same; greedy (no top-k in the chain) takes the best allowed."""
    from ferrum_tpu.sampling.host import sample_host as jsh
    from ferrum_tpu.types import SamplingParams as JSp
    from ferrum_tpu_torch.sampling.host import sample_host
    from ferrum_tpu_torch.types import SamplingParams
    logits = np.array([0.0, 5.0, 1.0], np.float32)
    mask = np.array([True, False, True])
    for kw, expect in ((dict(temperature=1.0, top_k=1), "raise"),
                       (dict(temperature=0.0, top_k=1), ("ok", 2))):
        got, want = [], []
        for fn, sp, out in ((sample_host, SamplingParams, got),
                            (jsh, JSp, want)):
            try:
                out.append(("ok", fn(logits, sp(**kw), [],
                                     np.random.default_rng(0), mask=mask)))
            except ValueError as e:
                out.append(("raise", str(e)))
        assert got == want
        assert got[0][0] == "raise" if expect == "raise" else got[0] == expect


# ---------------------------------------------------------------------------
# Engines: the port against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params): tiny-quant, seed 3."""
    from ferrum_tpu_torch.models.convert import params_from_numpy
    jcfg, jparams = jax_model("tiny-quant", quantized=True, seed=3)
    return jcfg, jparams, torch_config(jcfg), params_from_numpy(
        flatten_jax_params(jparams), "cpu")


LAYOUTS = {"linear": dict(kv_layout="linear", enable_prefix_cache=False),
           "paged": dict(kv_layout="paged", kv_num_blocks=64,
                         enable_prefix_cache=False)}


def _jax_engine(model, **kw):
    from ferrum_tpu.config import EngineConfig
    from ferrum_tpu.engine.builder import EngineBuilder
    cfg = EngineConfig(model="parity", dtype="f32", adaptive_windows=False,
                       **{**te._engine_kw(), **kw})
    return EngineBuilder(cfg).with_model(*model[:2]).build()


def _port_engine(model, **kw):
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    return EngineBuilder(EngineConfig(device="cpu", **{
        **te._engine_kw(), **kw})).with_model(*model[2:]).build()


def _request(engine, spec):
    """One request of `spec` in the engine's package: prompt text, and
    max_tokens / temperature / seed / stop / guided (a dict of
    GuidedOptions fields)."""
    mod = type(engine).__module__.split(".")[0]
    types = __import__(f"{mod}.types", fromlist=["x"])
    spec = dict(spec)
    guided = spec.pop("guided", None)
    prompt = spec.pop("prompt", "q:")
    sp = dict(max_tokens=10, temperature=0.0)
    sp.update(spec)
    from ferrum_tpu_torch.tokenizer import make_byte_tokenizer
    return types.InferenceRequest(
        prompt_token_ids=make_byte_tokenizer().encode(prompt),
        sampling=types.SamplingParams(**sp),
        guided=types.GuidedOptions(**guided) if guided else None)


def serve(engine, specs, together=True, host=False):
    """Serve the specs (all submitted before the loop starts, or one
    after another) and stop the engine: per request (its sequence's
    tokens once its last chunk is out, text, finish reason, guided path
    taken). host=True turns the device-FSM setup off (the host-masked
    path for every guided request)."""
    if host:
        engine._setup_device_guided = lambda seq, opts: None
    seqs = {}
    submit = engine.scheduler.submit

    def record(seq):
        seqs[seq.request.request_id] = seq
        submit(seq)

    engine.scheduler.submit = record
    reqs = [_request(engine, s) for s in specs]
    out = []
    try:
        queues = te._submit_all(engine, reqs) if together else []
        for i, r in enumerate(reqs):
            q = queues[i] if together else engine.submit(r)
            deadline = time.monotonic() + SERVE_TIMEOUT_S
            chunks = []
            while not chunks or not chunks[-1].finished:
                assert time.monotonic() < deadline, "engine did not finish"
                try:
                    chunks.append(q.get(timeout=1.0))
                except queue.Empty:
                    continue
            seq = seqs[r.request_id]
            out.append((list(seq.output_tokens),
                        "".join(c.text for c in chunks),
                        chunks[-1].finish_reason.value,
                        None if seq.guided_processor is None else
                        ("device" if seq.guided_fsm is not None
                         else "host")))
    finally:
        engine.stop()
    return out


GUIDED = [dict(guided=dict(regex=r"(yes|no)")),
          dict(guided=dict(regex=r"-?\d\d")),
          dict(guided=dict(regex=r"(foo|bar)+x")),
          dict(guided=dict(json_schema=SCHEMA), max_tokens=16),
          dict(guided=dict(json_mode=True), max_tokens=12)]


def _in_language(pattern, text, finish):
    from ferrum_tpu_torch.sampling.regex_dfa import compile_regex
    dfa = compile_regex(pattern)
    if finish == "stop":
        return dfa.fullmatch(text)
    return dfa.walk(dfa.start, text) is not None


@pytest.mark.parametrize("loop", ["pipelined", "unpipelined"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_guided_streams_match_jax_engine(monkeypatch, model, layout, loop):
    """Greedy guided requests one after another (regexes, a strict
    schema, JSON mode): the port's tokens, text and finish reason equal
    the JAX engine's on the device-FSM path, then on the host-masked
    path; the two paths give the same tokens; regex texts are in their
    language."""
    route_w4a8tl(monkeypatch)
    kw = dict(LAYOUTS[layout], **(te.PIPELINED if loop == "pipelined"
                                  else te.UNPIPELINED))
    dev = serve(_port_engine(model, **kw), GUIDED, together=False)
    assert {r[3] for r in dev} == {"device"}
    host = serve(_port_engine(model, **kw), GUIDED, together=False,
                 host=True)
    assert {r[3] for r in host} == {"host"}
    assert [r[:3] for r in dev] == [r[:3] for r in host]
    assert [r[:3] for r in dev] == [r[:3] for r in serve(
        _jax_engine(model, **kw), GUIDED, together=False)]
    assert [r[:3] for r in host] == [r[:3] for r in serve(
        _jax_engine(model, **kw), GUIDED, together=False, host=True)]
    for spec, (_, text, fin, _) in zip(GUIDED[:3], dev):
        assert _in_language(spec["guided"]["regex"], text, fin), text


# One FSM that build_token_fsm refuses (a state tells U+0100 from U+0101
# apart), served on the host-masked path without forcing it.
HOST_ONLY = dict(guided=dict(regex="[a-z]+(ā)?"), max_tokens=8)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_guided_mixed_batch_matches_jax_engine(monkeypatch, model, layout):
    """One batch of a device-FSM request, a refused-FSM request (the
    host-masked path, not forced), a plain request, a stop-string
    request and a seeded sampled request, submitted together on the
    pipelined loop: the greedy lanes equal the JAX engine's, and the
    seeded lane equals the port's own run of it alone."""
    route_w4a8tl(monkeypatch)
    kw = dict(LAYOUTS[layout], **te.PIPELINED)
    seeded = dict(prompt="zz", temperature=0.9, seed=11, max_tokens=9,
                  ignore_eos=True)
    plain = [dict(prompt="hello", max_tokens=9, ignore_eos=True)]
    stop_text = serve(_port_engine(model, **kw), plain)[0][1]
    specs = [GUIDED[0], HOST_ONLY, plain[0],
             dict(plain[0], stop=[stop_text[3:5]]), seeded]
    got = serve(_port_engine(model, **kw), specs)
    assert [r[3] for r in got] == ["device", "host", None, None, None]
    want = serve(_jax_engine(model, **kw), specs[:4])
    assert [r[:3] for r in got[:4]] == [r[:3] for r in want]
    assert got[3][2] == "stop" and len(got[3][1]) < len(stop_text)
    assert got[4][:3] == serve(_port_engine(model, **kw), [seeded])[0][:3]


def test_guided_recompute_resume_matches_jax_engine(monkeypatch, model):
    """A paged pool small enough to preempt (tests/test_torch_kv.py's
    14 blocks and prompts), its four requests guided: the preempted
    guided sequences resume from their processor's state at
    re-admission; tokens, texts and finish reasons equal the JAX
    engine's (unpipelined, as the JAX preemption tests run)."""
    import test_torch_kv as tk
    route_w4a8tl(monkeypatch)
    kw = dict(tk.PREEMPT_KW, **te.UNPIPELINED)
    pats = [r"[a-z ]+", r"(ab|cd)+", r"\d+", r"[a-z ]+"]
    specs = [dict(guided=dict(regex=p), max_tokens=12) for p in pats]

    def reqs(engine):
        out = []
        for spec, prompt in zip(specs, tk.PREEMPT_PROMPTS):
            r = _request(engine, spec)
            r.prompt_token_ids = list(prompt)
            out.append(r)
        return out

    results = []
    for make in (_port_engine, _jax_engine):
        engine = make(model, **kw)
        victims = tk._record_victims(engine)
        got = []
        try:
            qs = te._submit_all(engine, reqs(engine))
            for q in qs:
                deadline = time.monotonic() + SERVE_TIMEOUT_S
                chunks = []
                while not chunks or not chunks[-1].finished:
                    assert time.monotonic() < deadline
                    try:
                        chunks.append(q.get(timeout=1.0))
                    except queue.Empty:
                        continue
                got.append(("".join(c.text for c in chunks),
                            chunks[-1].completion_tokens,
                            chunks[-1].finish_reason.value))
            results.append((got, victims,
                            engine.scheduler.stats.preemptions))
        finally:
            engine.stop()
    assert results[0] == results[1]
    assert results[0][2] >= 1 and results[0][1]
    for p, (text, _, fin) in zip(pats, results[0][0]):
        assert _in_language(p, text, fin), (p, text)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sampled_guided_output_stays_in_language(model, layout):
    """Seeded sampled guided requests on both paths: every text is in
    (or, at max_tokens, a live prefix of) its language, and the
    host-masked path's tokens repeat for the same seed. top-k rides the
    device path alone: the host chain masks after top-k, and a top-k
    set with no allowed token fails there (ROADMAP Queue 3)."""
    specs = [dict(guided=dict(regex=r"(ab|cd)+"), temperature=0.9, seed=s,
                  max_tokens=10) for s in range(3)]
    top_k = dict(guided=dict(regex=r"-?\d+(\.\d+)?"), temperature=1.3,
                 top_k=9, seed=7, max_tokens=10)
    kw = dict(LAYOUTS[layout], **te.PIPELINED)
    for host in (False, True):
        sp = specs if host else specs + [top_k]
        runs = [serve(_port_engine(model, **kw), sp, host=host)
                for _ in range(2 if host else 1)]
        for spec, (_, text, fin, path) in zip(sp, runs[0]):
            assert path == ("host" if host else "device")
            assert _in_language(spec["guided"]["regex"], text, fin), text
        if host:
            assert runs[0] == runs[1]


def test_host_path_past_the_tokenizer_vocab(monkeypatch, model):
    """A model vocabulary (1024) past the tokenizer's (258, the byte
    tokenizer with no extra tokens): the port's host-masked path widens
    its mask as the device tables are built and gives the device-FSM
    path's tokens, which equal the JAX engine's; the JAX engine's
    host-masked path cannot broadcast its tokenizer-wide mask against
    the logits and ends its loop with the request's ERROR (ROADMAP
    Queue 3)."""
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu.engine.builder import EngineBuilder as JaxBuilder
    from ferrum_tpu.tokenizer import make_byte_tokenizer as jtok
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.tokenizer import make_byte_tokenizer
    route_w4a8tl(monkeypatch)
    kw = {**te._engine_kw(), **LAYOUTS["linear"], **te.UNPIPELINED}

    def port():
        return EngineBuilder(EngineConfig(device="cpu", **kw)).with_model(
            *model[2:]).with_tokenizer(make_byte_tokenizer()).build()

    def jax():
        return JaxBuilder(JaxConfig(
            model="parity", dtype="f32", adaptive_windows=False, **kw)) \
            .with_model(*model[:2]).with_tokenizer(jtok()).build()

    specs = GUIDED[:3] + [dict(guided=dict(regex=r"[a-z]{2,4}"),
                               max_tokens=8)]
    dev = serve(port(), specs, together=False)
    host = serve(port(), specs, together=False, host=True)
    assert [r[3] for r in dev] == ["device"] * 4
    assert [r[3] for r in host] == ["host"] * 4
    assert [r[:3] for r in dev] == [r[:3] for r in host]
    assert [r[:3] for r in dev] == [r[:3] for r in serve(
        jax(), specs, together=False)]
    engine = jax()
    engine._setup_device_guided = lambda seq, opts: None
    q = engine.submit(_request(engine, specs[0]))
    try:
        chunk = q.get(timeout=SERVE_TIMEOUT_S)
        assert chunk.finished and chunk.finish_reason.value == "error"
        assert isinstance(engine._loop_error, ValueError)
        assert "broadcast" in str(engine._loop_error)
    finally:
        engine._loop_error = None
        engine.stop()


def test_submit_keeps_echo_refusal_and_registers_once(model):
    """submit: echo + logprobs with guided options is refused with the
    JAX param; two requests of one pattern share one registered FSM; a
    refused FSM registers nothing; slot states start FREE."""
    from ferrum_tpu_torch.types import (GuidedOptions, InferenceRequest,
                                        InvalidRequestError, SamplingParams)
    engine = _port_engine(model, **LAYOUTS["linear"])
    engine.ensure_loop = lambda: None
    try:
        with pytest.raises(InvalidRequestError) as e:
            engine.submit(InferenceRequest(
                prompt_token_ids=[5, 6], echo=True,
                sampling=SamplingParams(max_tokens=0, logprobs=1),
                guided=GuidedOptions(regex="a")))
        assert e.value.param == "echo"
        for _ in range(2):
            engine.submit(InferenceRequest(
                prompt_token_ids=[5, 6], guided=GuidedOptions(regex="a+")))
        engine.submit(_request(engine, HOST_ONLY))
        runner = engine.runner
        assert len(runner._fsm_offsets) == 1 and runner._gdev is None
        seqs = list(engine.scheduler.waiting)
        assert [s.guided_fsm_offset for s in seqs] == [1, 1, None]
        assert seqs[0].guided_processor.dfa is seqs[1].guided_processor.dfa
        assert not runner.gstates.any()
    finally:
        engine.stop()
