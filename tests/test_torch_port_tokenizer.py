"""The port's CLIP BPE tokenizer against the JAX package's, on the CPU.

The JAX tokenizer splits text with a ``regex`` pattern over Unicode
classes; the port scans ``unicodedata`` categories.  These tests hold
the scanner's classes against ``regex`` at every code point, its split
against ``regex.findall``, and the ids against the JAX ``CLIPTokenizer``
on the vocabulary ``chip_smoke.synthetic_tokenizer`` writes, made as
``tests/test_utils.py`` makes its own (byte symbols, one merge; the one
``tools/make_weights.py --tiny`` writes is held in
``test_torch_port_zoo.py``), over hard strings and under a hypothesis
property on arbitrary text.  Ids must be equal.
"""

import numpy as np
import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from ladi_vton_tpu.utils import tokenizer as jax_tokenizer
from ladi_vton_tpu_torch.utils import tokenizer

PATTERN = regex.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
    r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", regex.IGNORECASE)

HARD_STRINGS = [
    "a photo of a model wearing an upper body garment " + " $ " * 16,
    "$" * 16, " $$$$ $$$$$$$$$$$$ ", "Crème brûlée à la carte, naïve café",
    "ÀÉÎÕÜ ñ ß ø å æ œ", "é à ñ (combining marks)",
    "ͅ aͅb ͅͅ ιͅ", "東京の服 中文字符 한국어 텍스트",
    "snake_case __init__ _", "x² + y² = z², ½ ¾ ⅓", "Ⅻ ⅻ Ⅳ ↂ 〇 ①",
    "a\x1cb\x1dc\x1ed\x1ff \x1c\x1d", "tab\tnew\nline\r\x0b\x0c end",
    "nbsp\xa0nel\x85ogham em narrow ideo　x",
    "zero​width‍ joiner﻿",
    "fish &amp; chips &amp;amp; &lt;tag&gt; &#39;q&#39; &quot;",
    "I'm you're we've he'll she'd it's don't can't", "'S 'T 'RE 'VE 'M 'LL",
    "it'ſ don'ſ ſtop 'ſ", "<|startoftext|>hello<|endoftext|>",
    "<|StartOfText|> <|ſtartoftext|> <|endoftext", "0123456789 3.14 1,000",
    "٣٤٥ ०१२ ๑๒๓", "!!!??? ... --- ##$$%% ^^&&", "emoji 👗👠 🇮🇹 👩‍🦰",
    "İstanbul ǅ ǈ Σσς", "\U00013460\U00013461 \U000105c0 \U00010d40",
    "a⃝ b҈ ‌‍", "", "   ", "\x00\x01\x7f", "ﬁ ﬂ ﬃ",
    "𝐀𝐁𝐂 𝟎𝟏𝟐", "a-b_c.d/e\\f|g~h`i", "MiXeD CaSe WoRdS",
]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """Both tokenizers on the same files: every byte symbol alone and at
    a word's end ('$' at 259), the merge ``t o</w>``, the specials."""
    root = tmp_path_factory.mktemp("tok")
    ours = chip_smoke.synthetic_tokenizer(root)
    return jax_tokenizer.CLIPTokenizer.from_dir(root), ours


def test_classes_match_regex_at_every_code_point():
    letter = regex.compile(r"[\p{L}]", regex.IGNORECASE)
    number = regex.compile(r"[\p{N}]", regex.IGNORECASE)
    space = regex.compile(r"\s")
    other = regex.compile(r"[^\s\p{L}\p{N}]", regex.IGNORECASE)
    want = {tokenizer.LETTER: (1, 0, 0, 0), tokenizer.NUMBER: (0, 1, 0, 0),
            tokenizer.SPACE: (0, 0, 1, 0), tokenizer.SKIP: (0, 0, 0, 0),
            tokenizer.OTHER: (0, 0, 0, 1)}
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        c = chr(cp)
        got = tuple(int(bool(p.match(c)))
                    for p in (letter, number, space, other))
        assert got == want[tokenizer.char_class(c)], hex(cp)


@pytest.mark.parametrize("text", HARD_STRINGS)
def test_split_and_ids_match_jax_on_hard_strings(tokenizers, text):
    jtok, tok = tokenizers
    cleaned = jax_tokenizer._whitespace_clean(
        jax_tokenizer._basic_clean(text)).lower()
    assert tokenizer._clean(text).lower() == cleaned
    assert tokenizer._split(cleaned) == PATTERN.findall(cleaned)
    assert tok.encode(text) == jtok.encode(text)


def test_batch_ids_match_jax(tokenizers):
    jtok, tok = tokenizers
    ids = tok(HARD_STRINGS)
    assert ids.dtype == np.int32 and ids.shape == (len(HARD_STRINGS), 77)
    np.testing.assert_array_equal(ids, jtok(HARD_STRINGS))
    # bos, '$' -> 259, eos right after, eos padding, truncation at 77
    row = tok(["$", "to " * 100])
    assert row[0, :3].tolist() == [49406, 259, 49407]
    assert (row[0, 3:] == 49407).all()
    assert row[1, 0] == 49406 and row[1, -1] == 49407
    assert (row[1, 1:-1] == tok.encoder["to</w>"]).all()


ALPHABET = st.one_of(
    st.characters(),
    st.sampled_from("$'sStTrRvVmMlLdDſ_²½Ⅻ\x1c\x1d\x1e\x1fͅ \t\n"
                    "<|>&;#éàß中"),
    st.sampled_from(["<|startoftext|>", "<|endoftext|>", "&amp;",
                     "&#39;", "'ll", "'ſ"]))


@settings(max_examples=400, deadline=None)
@given(text=st.lists(ALPHABET, max_size=40).map("".join))
def test_ids_match_jax_on_arbitrary_text(tokenizers, text):
    jtok, tok = tokenizers
    cleaned = tokenizer._clean(text).lower()
    assert tokenizer._split(cleaned) == PATTERN.findall(cleaned)
    assert outcome(tok, text) == outcome(jtok, text)


def outcome(tok, text):
    """The ids, or the error's type and message: text with a lone
    surrogate (which ``characters()`` draws) has no UTF-8 bytes, and both
    tokenizers raise the same UnicodeEncodeError on it."""
    try:
        return tok.encode(text)
    except UnicodeEncodeError as e:
        return type(e), str(e)
