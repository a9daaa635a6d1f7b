"""The port's tokenizer.json tokenizer vs the JAX package's (`tokenizers`).

`tokenizer.json` files are trained here with `tokenizers`' BpeTrainer on
a fixed corpus (no download), in the forms real checkpoints use:

- "llama3": Split(Llama-3's regex, Isolated) + ByteLevel(use_regex=false),
  BPE with `ignore_merges`, TemplateProcessing adding <|begin_of_text|>;
- "qwen2": NFC, Split(Qwen2's regex: \\p{N} one at a time), ByteLevel, no
  BOS;
- "gpt2": ByteLevel with its own regex and add_prefix_space, and added
  tokens with lstrip / rstrip and one marked `normalized`.

and two SentencePiece-style forms, BPE with byte fallback and an unk
token over a limited alphabet (so CJK, emoji and accents fall back to
<0xNN> byte tokens), no pre-tokenizer:

- "gemma": Gemma 3's normalizer Replace(" " -> "▁"), decoder
  Sequence(Replace("▁" -> " "), ByteFallback, Fuse), <bos> prepended;
- "mistral": Mistral 7B v0.1's normalizer Sequence(Prepend("▁"),
  Replace), decoder Sequence(Replace, ByteFallback, Fuse, Strip(" ", 1,
  0)), <s> prepended.

Each has added special tokens. The port's `encode` (with and without
special tokens), `decode` (with and without skipping them) and
`decode_incremental` must equal the JAX FerrumTokenizer's on fixed
strings (CJK, emoji, digit runs, contractions in both cases, CRLF, NBSP,
runs of spaces, U+001C..U+001F, long s) and on a seeded hypothesis
strategy; the metadata (eos / bos / special ids, chat template) equal
the JAX one's; the regex classes equal Oniguruma's over every code
point; unsupported components raise.
"""

import json
import os

import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

LLAMA3 = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
          r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN2 = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
         r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
CORPUS = [
    "The quick brown fox jumps over the lazy dog. It's 12345 o'clock!",
    "Tokenizers split text into pieces; BPE merges the most frequent pairs.",
    "日本語のテキストと中文文本 mixed with English words and 数字 678.",
    "Emoji 🙂🚀 and accents: café, naïve, résumé. Arabic digits ٠١٢٣.",
    "Line one\r\nLine two\n\n  indented   spaces\tand tabs",
    "We'll see what they've done; I'd say you're right, DON'T YOU?",
] * 20
SPECIALS = {"llama3": ["<|begin_of_text|>", "<|eot_id|>"],
            "qwen2": ["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
            "gpt2": ["<|endoftext|>"],
            "gemma": ["<pad>", "<unk>", "<bos>", "<start_of_turn>",
                      "<end_of_turn>"],
            "mistral": ["<unk>", "<s>", "</s>"]}
BOS = {"llama3": "<|begin_of_text|>", "gemma": "<bos>", "mistral": "<s>"}
FORMS = list(SPECIALS)
TEXTS = [
    "Hello world", "It's DON'T we'LL They'Ve I'M", "日本語 中文 🙂🚀 テキスト",
    "12345678 ٠١٢٣٤ 3.14159", "a\r\nb\n\n c\r\n\r\n", "x\xa0y  z   ",
    "<|eot_id|>hi<|begin_of_text|> there<|im_end|>", "", " ", "   ",
    "café naïve é", "\x1c\x1d a\x1e\x1f", "'ſ 'S 'ſt", "\t\ttab",
    "<|endoftext|> <|im_start|>user\nhi<|im_end|>", "[MARK]  x [MARK]",
    "mixed12abc34 __init__ x==y", "😀😃😄😁😆 🇯🇵",
]


def train_sentencepiece(form):
    """A SentencePiece-style tokenizers.Tokenizer of the form ("gemma" or
    "mistral"), trained on CORPUS over a 60-character alphabet, with the
    256 <0xNN> byte tokens appended to its vocab."""
    from tokenizers import (Tokenizer, decoders, models, normalizers,
                            processors, trainers)

    tok = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True,
                               byte_fallback=True))
    space = normalizers.Replace(" ", "\u2581")
    tok.normalizer = space if form == "gemma" else normalizers.Sequence(
        [normalizers.Prepend("\u2581"), space])
    tok.decoder = decoders.Sequence(
        [decoders.Replace("\u2581", " "), decoders.ByteFallback(),
         decoders.Fuse()]
        + ([decoders.Strip(" ", 1, 0)] if form == "mistral" else []))
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=500, special_tokens=SPECIALS[form], limit_alphabet=60,
        show_progress=False))
    spec = json.loads(tok.to_str())
    vocab = spec["model"]["vocab"]
    base = max(vocab.values()) + 1
    vocab.update({f"<0x{b:02X}>": base + b for b in range(256)})
    spec["model"].update(byte_fallback=True, unk_token="<unk>",
                         fuse_unk=True)
    tok = Tokenizer.from_str(json.dumps(spec))
    bos = BOS[form]
    tok.post_processor = processors.TemplateProcessing(
        single=f"{bos} $A", pair=f"{bos} $A {bos} $B",
        special_tokens=[(bos, tok.token_to_id(bos))])
    return tok


def train(form):
    """A tokenizers.Tokenizer of the form, trained on CORPUS."""
    from tokenizers import (Regex, Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, processors, trainers)

    if form in ("gemma", "mistral"):
        return train_sentencepiece(form)

    tok = Tokenizer(models.BPE(ignore_merges=form == "llama3"))
    byte_level = pre_tokenizers.ByteLevel(add_prefix_space=False,
                                          use_regex=False)
    if form == "gpt2":
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True,
                                                     use_regex=True)
    else:
        pat = LLAMA3 if form == "llama3" else QWEN2
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(pat), behavior="isolated"),
            byte_level])
    if form == "qwen2":
        tok.normalizer = normalizers.NFC()
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=600, special_tokens=SPECIALS[form], show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    if form == "llama3":
        bos = "<|begin_of_text|>"
        tok.post_processor = processors.Sequence([
            processors.ByteLevel(trim_offsets=False),
            processors.TemplateProcessing(
                single=f"{bos} $A", pair=f"{bos} $A {bos} $B",
                special_tokens=[(bos, tok.token_to_id(bos))])])
    if form == "gpt2":
        from tokenizers import AddedToken
        tok.post_processor = processors.ByteLevel(trim_offsets=True)
        tok.add_special_tokens([AddedToken("[MARK]", lstrip=True,
                                           rstrip=True)])
        tok.add_tokens([AddedToken("__init__", normalized=True)])
    return tok


def write_tokenizer_dir(d, form, eos=None):
    """tokenizer.json, tokenizer_config.json and generation_config.json
    of the form under `d`; returns `d`."""
    os.makedirs(d, exist_ok=True)
    tok = train(form)
    tok.save(os.path.join(d, "tokenizer.json"))
    specials = SPECIALS[form]
    cfg = {"chat_template": "{{ messages }}",
           "eos_token": {"content": specials[-1]},
           "added_tokens_decoder": {
               str(tok.token_to_id(s)): {"content": s, "special": True}
               for s in specials}}
    if form in BOS:
        cfg["bos_token"] = BOS[form]
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump(cfg, f)
    if eos is not None:
        with open(os.path.join(d, "generation_config.json"), "w") as f:
            json.dump({"eos_token_id": eos}, f)
    return str(d)


_PAIRS = {}


def pair(form, tmp_path_factory):
    """(the port's, the JAX package's) tokenizer of the form, one
    directory per form and process."""
    if form not in _PAIRS:
        from ferrum_tpu.tokenizer import FerrumTokenizer as JaxTok
        from ferrum_tpu_torch.tokenizer import FerrumTokenizer

        d = write_tokenizer_dir(tmp_path_factory.mktemp(form), form,
                                eos=[0, 1] if form != "gpt2" else 0)
        _PAIRS[form] = (FerrumTokenizer.from_pretrained(d),
                        JaxTok.from_pretrained(d))
    return _PAIRS[form]


def assert_same(port, ref, text):
    for add in (True, False):
        ids = ref.encode(text, add_special_tokens=add)
        assert port.encode(text, add_special_tokens=add) == ids, (text, add)
    ids = ref.encode(text)
    assert port.decode(ids) == ref.decode(ids), text
    assert port.decode(ids, skip_special_tokens=False) == \
        ref.decode(ids, skip_special_tokens=False), text
    # Streaming one id at a time: the same pieces at the same offsets.
    sp = sr = (0, 0)
    for n in range(1, len(ids) + 1):
        a = port.decode_incremental(ids[:n], *sp)
        b = ref.decode_incremental(ids[:n], *sr)
        assert a == b, (text, n)
        sp = sr = a[1:]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("text", TEXTS)
def test_fixed_strings_match_jax(tmp_path_factory, form, text):
    port, ref = pair(form, tmp_path_factory)
    assert_same(port, ref, text)


@pytest.mark.parametrize("form", FORMS)
def test_hypothesis_strings_match_jax(tmp_path_factory, form):
    port, ref = pair(form, tmp_path_factory)

    @settings(max_examples=150, deadline=None, derandomize=True,
              database=None, suppress_health_check=list(HealthCheck))
    @given(st.text(max_size=40) | st.lists(
        st.sampled_from(list("ab '’\n\r\t \xa01٣日本🙂é") + SPECIALS[form]),
        max_size=12).map("".join))
    def check(text):
        assert_same(port, ref, text)

    check()


@pytest.mark.parametrize("form", FORMS)
def test_decode_of_any_ids_matches_jax(tmp_path_factory, form):
    """Ids outside the vocabulary are skipped, partial UTF-8 sequences
    decode to U+FFFD as `tokenizers` decodes them."""
    import random

    port, ref = pair(form, tmp_path_factory)
    r = random.Random(form)
    for _ in range(300):
        ids = [r.randrange(0, 620) for _ in range(r.randrange(0, 12))]
        for skip in (True, False):
            assert port.decode(ids, skip) == ref.decode(ids, skip), ids


@pytest.mark.parametrize("form", FORMS)
def test_metadata_matches_jax(tmp_path_factory, form):
    port, ref = pair(form, tmp_path_factory)
    assert port.eos_token_ids == ref.eos_token_ids
    assert port.bos_token_id == ref.bos_token_id
    assert port._special_ids == ref._special_ids
    assert port.chat_template == ref.chat_template
    assert port.vocab_size == ref.vocab_size
    for s in SPECIALS[form] + ["Ġthe", "nope", "<0x41>", "\u2581the"]:
        assert port.token_to_id(s) == ref.token_to_id(s)


@pytest.mark.parametrize("cls", ["L", "N", "s"])
def test_regex_classes_match_oniguruma(cls):
    """The port's \\p{L}, \\p{N} and \\s equal the `tokenizers` library's
    (Oniguruma) over every code point."""
    import re

    from tokenizers import Regex, pre_tokenizers

    from ferrum_tpu_torch.tokenizer import translate_regex

    pat = r"\s" if cls == "s" else rf"\p{{{cls}}}"
    onig = pre_tokenizers.Split(Regex(pat), behavior="removed")
    mine = re.compile(translate_regex(pat))
    chars = [chr(c) for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
    for i in range(0, len(chars), 50000):
        chunk = "".join(chars[i:i + 50000])
        kept = "".join(p for p, _ in onig.pre_tokenize_str(chunk))
        assert mine.sub("", chunk) == kept, i


UNSUPPORTED = {
    "metaspace": ("pre_tokenizer", {"type": "Metaspace", "replacement": "▁",
                                    "prepend_scheme": "always",
                                    "split": True}),
    "wordpiece": ("model", {"type": "WordPiece", "vocab": {"a": 0},
                            "unk_token": "a"}),
    "unigram": ("model", {"type": "Unigram", "vocab": [["a", 0.0]]}),
    "byte_fallback": ("model.byte_fallback", True),
    "nfkc": ("normalizer", {"type": "NFKC"}),
    "split_removed": ("pre_tokenizer.Split.behavior", "Removed"),
    "bert_processing": ("post_processor", {"type": "BertProcessing",
                                           "sep": ["[SEP]", 1],
                                           "cls": ["[CLS]", 0]}),
    "wordpiece_decoder": ("decoder", {"type": "WordPiece", "prefix": "##"}),
    "single_word": ("added_tokens.single_word", True),
    "regex_word_class": ("pre_tokenizer", r"\w+"),
    "replace_regex": ("normalizer", {"type": "Replace",
                                     "pattern": {"Regex": " +"},
                                     "content": "\u2581"}),
    "ctc_decoder": ("decoder", {"type": "Sequence", "decoders": [
        {"type": "ByteFallback"}, {"type": "CTC"}]}),
    "bytelevel_in_sequence": ("decoder", {"type": "Sequence", "decoders": [
        {"type": "ByteLevel"}, {"type": "Fuse"}]}),
}


@pytest.mark.parametrize("name", list(UNSUPPORTED))
def test_unsupported_components_raise(name):
    from ferrum_tpu_torch.tokenizer import FerrumTokenizer
    from ferrum_tpu_torch.types import ModelLoadError

    spec = json.loads(train("llama3").to_str())
    part, value = UNSUPPORTED[name]
    if part == "model.byte_fallback":
        spec["model"]["byte_fallback"] = True
    elif part == "pre_tokenizer.Split.behavior":
        spec["pre_tokenizer"]["pretokenizers"][0]["behavior"] = value
    elif part == "added_tokens.single_word":
        spec["added_tokens"][0]["single_word"] = True
    elif name == "regex_word_class":
        spec["pre_tokenizer"]["pretokenizers"][0]["pattern"] = {
            "Regex": value}
    elif part == "model":
        spec["model"] = value
    else:
        spec[part] = value
    with pytest.raises(ModelLoadError):
        FerrumTokenizer(spec).encode("Hello world 12")


def test_no_tokenizer_json_raises(tmp_path):
    from ferrum_tpu_torch.tokenizer import FerrumTokenizer
    from ferrum_tpu_torch.types import ModelLoadError

    with pytest.raises(ModelLoadError, match="no tokenizer.json"):
        FerrumTokenizer.from_pretrained(str(tmp_path))
