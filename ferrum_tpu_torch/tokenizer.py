"""Byte-level test tokenizer and stable incremental detokenization.

Port of `ferrum_tpu/tokenizer.py::make_byte_tokenizer` without the
HuggingFace `tokenizers` dependency (the card's machine does not need
it): the same vocabulary -- ids 0-255 are the 256 byte symbols of the
GPT-2 byte-level alphabet in sorted order, 256 = <bos>, 257 = <eos>,
then `vocab_extra` unused slots -- so the same text gives the same ids
in both packages. HF checkpoint tokenizers come with the loader slice.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

BOS, EOS = "<bos>", "<eos>"


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte → printable unicode symbol map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class ByteTokenizer:
    def __init__(self, vocab_extra: int = 0):
        sym = _bytes_to_unicode()
        rank = {ch: i for i, ch in enumerate(sorted(sym.values()))}
        self._byte_to_id = [rank[sym[b]] for b in range(256)]
        self._id_to_byte = {i: b for b, i in enumerate(self._byte_to_id)}
        self._specials = {BOS: 256, EOS: 257}
        self._special_ids = {256, 257}
        self._extra = vocab_extra
        self.eos_token_ids: Tuple[int, ...] = (257,)

    @property
    def vocab_size(self) -> int:
        return 258 + self._extra

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for part in re.split(f"({re.escape(BOS)}|{re.escape(EOS)})", text):
            if part in self._specials:
                ids.append(self._specials[part])
            elif part:
                ids.extend(self._byte_to_id[b] for b in part.encode("utf-8"))
        return ids

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        out = bytearray()
        for i in ids:
            if i in self._id_to_byte:
                out.append(self._id_to_byte[i])
            elif i in self._special_ids:
                if not skip_special_tokens:
                    out.extend((BOS if i == 256 else EOS).encode())
            elif 258 <= i < 258 + self._extra:
                out.extend(f"<extra_{i - 258}>".encode())
        return out.decode("utf-8", errors="replace")

    def decode_incremental(self, all_ids: Sequence[int], prefix_offset: int,
                           read_offset: int) -> Tuple[str, int, int]:
        """Emit text only once its bytes are final (no dangling partial
        UTF-8 sequence): returns (new_text, prefix_offset, read_offset)."""
        ids = list(all_ids)
        prefix_text = self.decode(ids[prefix_offset:read_offset])
        full_text = self.decode(ids[prefix_offset:])
        if len(full_text) > len(prefix_text) and not full_text.endswith("�"):
            return full_text[len(prefix_text):], read_offset, len(ids)
        return "", prefix_offset, read_offset


def make_byte_tokenizer(vocab_extra: int = 0) -> ByteTokenizer:
    return ByteTokenizer(vocab_extra)
