"""The CLIP byte-level BPE tokenizer, without the ``regex`` package.

Counterpart of ``ladi_vton_tpu/utils/tokenizer.py CLIPTokenizer``: it
loads ``vocab.json`` and ``merges.txt`` from a directory and encodes a
batch of prompts to (B, 77) ids, bos 49406, eos 49407, padded with eos;
``$`` is the vocabulary's ``$</w>`` entry (id 259 in CLIP's and in the
vocabularies the repository writes).

The JAX tokenizer splits text with the openai/CLIP pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
[^\\s\\p{L}\\p{N}]+`` under ``regex.IGNORECASE``, and collapses ``\\s+``
first.  Stdlib ``re`` has no ``\\p`` classes, and its ``\\w`` and ``\\s``
are other sets (``_`` and the No/Nl numbers are ``\\w``; ``re``'s ``\\s``
takes U+001C-U+001F, which Unicode's White_Space does not), so
``_split`` is a scanner over ``unicodedata.category`` that reproduces
what ``regex`` matches, character for character:

* letters are categories L*, numbers N*, whitespace the 25 White_Space
  code points;
* ``regex`` knows Unicode 17.0, Python 3.12's ``unicodedata`` 15.0: the
  letters and numbers assigned since (``LATER_LETTERS``,
  ``LATER_NUMBERS``) count as such;
* under IGNORECASE, U+0345 (a combining mark whose case variant is the
  letter iota) is excluded from the "other" class but is no letter
  either: no alternative matches it, and it is dropped;
* the literal alternatives match case-insensitively, so U+017F (long s)
  stands for ``s`` in them (after lowercasing, the only such character).

``tests/test_torch_port_tokenizer.py`` holds these classes against
``regex`` at every code point, and the ids against the JAX tokenizer.
"""

from __future__ import annotations

import bisect
import html
import json
import re
import unicodedata
from functools import lru_cache
from pathlib import Path

import numpy as np

# Unicode White_Space (what regex's \s matches)
WHITE_SPACE = frozenset(
    [*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
     0x2028, 0x2029, 0x202F, 0x205F, 0x3000])
_WHITE_SPACE_RUN = re.compile(
    "[" + "".join(f"\\u{c:04x}" for c in sorted(WHITE_SPACE)) + "]+")
# letters and numbers assigned in Unicode 16.0 and 17.0 (inclusive ranges)
LATER_LETTERS = (
    (0x88F, 0x88F), (0xC5C, 0xC5C), (0xCDC, 0xCDC), (0x1C89, 0x1C8A),
    (0xA7CB, 0xA7CF), (0xA7D2, 0xA7D2), (0xA7D4, 0xA7D4), (0xA7DA, 0xA7DC),
    (0xA7F1, 0xA7F1), (0x105C0, 0x105F3), (0x10940, 0x10959),
    (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC7),
    (0x11380, 0x11389), (0x1138B, 0x1138B), (0x1138E, 0x1138E),
    (0x11390, 0x113B5), (0x113B7, 0x113B7), (0x113D1, 0x113D1),
    (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x11DB0, 0x11DDB),
    (0x13460, 0x143FA), (0x16100, 0x1611D), (0x16D40, 0x16D6C),
    (0x16EA0, 0x16EB8), (0x16EBB, 0x16ED3), (0x16FF2, 0x16FF3),
    (0x187F8, 0x187FF), (0x18CFF, 0x18CFF), (0x18D09, 0x18D1E),
    (0x18D80, 0x18DF2), (0x1E5D0, 0x1E5ED), (0x1E5F0, 0x1E5F0),
    (0x1E6C0, 0x1E6DE), (0x1E6E0, 0x1E6E2), (0x1E6E4, 0x1E6E5),
    (0x1E6E7, 0x1E6ED), (0x1E6F0, 0x1E6F4), (0x1E6FE, 0x1E6FF),
    (0x2B73A, 0x2B73F), (0x2CEA2, 0x2CEAD), (0x2EBF0, 0x2EE5D),
    (0x323B0, 0x33479))
LATER_NUMBERS = (
    (0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9),
    (0x11DE0, 0x11DE9), (0x16130, 0x16139), (0x16D70, 0x16D79),
    (0x16FF4, 0x16FF6), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA))
UNMATCHED = "ͅ"
SPECIAL_TOKENS = ("<|startoftext|>", "<|endoftext|>")
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
LETTER, NUMBER, SPACE, SKIP, OTHER = range(5)


def _in(ranges, cp: int) -> bool:
    i = bisect.bisect_right(ranges, (cp, 0x10FFFF)) - 1
    return i >= 0 and ranges[i][0] <= cp <= ranges[i][1]


@lru_cache(maxsize=None)
def char_class(c: str) -> int:
    """What the JAX pattern's classes make of one character."""
    cp = ord(c)
    if cp in WHITE_SPACE:
        return SPACE
    if c == UNMATCHED:
        return SKIP
    major = unicodedata.category(c)[0]
    if major == "L" or _in(LATER_LETTERS, cp):
        return LETTER
    if major == "N" or _in(LATER_NUMBERS, cp):
        return NUMBER
    return OTHER


def _literal_at(text: str, i: int, literal: str) -> bool:
    """``literal`` at ``text[i:]``, case-insensitively as regex matches it
    after lowercasing (U+017F long s matches s)."""
    piece = text[i:i + len(literal)]
    return (len(piece) == len(literal)
            and piece.replace("ſ", "s") == literal)


def _split(text: str) -> list[str]:
    """``regex.findall`` of the JAX tokenizer's pattern on lowercased,
    whitespace-collapsed text."""
    out = []
    i, n = 0, len(text)
    while i < n:
        literal = next((lit for lit in SPECIAL_TOKENS + CONTRACTIONS
                        if _literal_at(text, i, lit)), None)
        if literal is not None:
            out.append(text[i:i + len(literal)])
            i += len(literal)
            continue
        cls = char_class(text[i])
        if cls in (SPACE, SKIP):
            i += 1
            continue
        j = i + 1
        if cls != NUMBER:  # letters and others run on; a number is alone
            while j < n and char_class(text[j]) == cls:
                j += 1
        out.append(text[i:j])
        i = j
    return out


@lru_cache()
def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return set(zip(word[:-1], word[1:]))


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text)).strip()
    return _WHITE_SPACE_RUN.sub(" ", text).strip()


class CLIPTokenizer:
    """BPE tokenizer compatible with openai/clip and HF CLIPTokenizer."""

    model_max_length = 77
    bos_token_id = 49406
    eos_token_id = 49407

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.cache = {t: t for t in SPECIAL_TOKENS}

    @classmethod
    def from_dir(cls, path) -> "CLIPTokenizer":
        """Load from a directory holding vocab.json + merges.txt (the first
        line of merges.txt is a version header)."""
        path = Path(path)
        with open(path / "vocab.json", encoding="utf-8") as f:
            vocab = json.load(f)
        with open(path / "merges.txt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(line.split()) for line in lines[1:]
                  if len(line.split()) == 2]
        return cls(vocab, merges)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids = []
        for token in _split(_clean(text).lower()):
            token_bytes = "".join(
                self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t]
                       for t in self._bpe(token_bytes).split(" "))
        return ids

    def __call__(self, texts, *, max_length: int | None = None,
                 truncation: bool = True) -> np.ndarray:
        """Batch-encode to (B, max_length) int32 ids: bos, the text's
        ids, eos, then eos padding."""
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        out = np.full((len(texts), max_length), self.eos_token_id, np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text)
            if truncation:
                ids = ids[: max_length - 2]
            row = [self.bos_token_id] + ids + [self.eos_token_id]
            out[i, : len(row)] = np.asarray(row, np.int32)
        return out
