"""The port's byte-level BPE and token dataset against the JAX package's.

The same corpus must give the same merges and the same ids in both
packages; a tokenizer saved by either loads in the other; GPT-2's file
format loads from small files the test writes; ``make_dataset`` dispatches
on ``data_config.tokenizer``. The port's pre-tokenizer runs on the standard
library's ``re`` with explicit classes, and must split exactly as the
``regex`` module does (``regex`` is importable here, not on the card).
"""

import json
import os
import unicodedata

import numpy as np
import pytest
import regex

from mingpt_distributed_tpu.config import DataConfig as JDataConfig
from mingpt_distributed_tpu.data import bpe as j_bpe
from mingpt_distributed_tpu.data import token_dataset as j_td
from mingpt_distributed_tpu_torch.config import DataConfig
from mingpt_distributed_tpu_torch.data import bpe as t_bpe
from mingpt_distributed_tpu_torch.data import token_dataset as t_td
from mingpt_distributed_tpu_torch.data.char_dataset import CharDataset
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "input.txt")

# letters with marks (composed and combining), No/Nl characters that
# Python's [^\W\d_] would take for letters, Arabic-Indic digits, CJK,
# Greek, contractions, runs of spaces, tabs, newlines, U+3000 and U+001C
# (not whitespace to regex, whitespace to str.isspace)
NASTY = ("Héllo wörld! It's 'quoted' café ½ x² Ⅻ ٣٤٥ é naïve\n\n  "
         "tabs\there  end  　x\x1cy Ωμέγα 北京 ١٢ 'll 're''s  \n ")


def _corpus(frac=0.15):
    with open(CORPUS) as f:
        text = f.read()
    return text[: int(len(text) * frac)]


@pytest.mark.parametrize("text", [NASTY, NASTY * 3 + _corpus(0.02)],
                         ids=["nasty", "mixed"])
def test_pre_tokenizer_splits_as_regex_does(text):
    pattern = t_bpe._compile(t_bpe.GPT2_SPLIT_PATTERN)
    assert pattern.findall(text) == regex.findall(t_bpe.GPT2_SPLIT_PATTERN, text)
    assert t_bpe.GPT2_SPLIT_PATTERN == j_bpe.GPT2_SPLIT_PATTERN


def test_character_classes_match_regex_on_assigned_code_points():
    """\\p{L}, \\p{N} and \\s agree with regex on every code point this
    Python's Unicode database assigns (regex may know newer characters)."""
    letters, numbers = t_bpe._classes()
    import re

    cls = {"L": re.compile(f"[{letters}]"), "N": re.compile(f"[{numbers}]"),
           "s": re.compile(f"[{t_bpe._WHITE_SPACE}]")}
    ref = {"L": regex.compile(r"\p{L}"), "N": regex.compile(r"\p{N}"),
           "s": regex.compile(r"\s")}
    for cp in range(0, 0x110000, 7):  # every 7th code point: ~160k checks
        c = chr(cp)
        if unicodedata.category(c) == "Cn":
            continue
        for k in cls:
            assert bool(cls[k].match(c)) == bool(ref[k].match(c)), (hex(cp), k)


def test_unknown_unicode_property_raises():
    with pytest.raises(ValueError, match="Unicode property"):
        t_bpe._compile(r"\p{Lu}+")


@pytest.mark.parametrize("vocab", [300, 420])  # 420: the corpus runs out first
def test_train_gives_the_same_merges_and_ids(vocab):
    text = _corpus() + NASTY
    jt = j_bpe.BPETokenizer.train(text, vocab)
    tt = t_bpe.BPETokenizer.train(text, vocab)
    assert tt.encoder == jt.encoder
    assert tt.merge_ranks == jt.merge_ranks
    assert tt.vocab_size == jt.vocab_size <= vocab
    probe = NASTY + text[:2000]
    np.testing.assert_array_equal(tt.encode(probe), jt.encode(probe))
    assert tt.decode(tt.encode(probe)) == probe


def test_train_stops_when_no_pair_repeats():
    tt = t_bpe.BPETokenizer.train("ab", 400)
    jt = j_bpe.BPETokenizer.train("ab", 400)
    assert tt.vocab_size == jt.vocab_size == 256
    with pytest.raises(ValueError, match="256"):
        t_bpe.BPETokenizer.train("ab", 100)


def test_save_load_round_trip_and_across_packages(tmp_path):
    text = _corpus(0.05) + NASTY
    tt = t_bpe.BPETokenizer.train(text, 320)
    tt.save(str(tmp_path / "t.json"))
    back = t_bpe.BPETokenizer.load(str(tmp_path / "t.json"))
    assert back.encoder == tt.encoder and back.merge_ranks == tt.merge_ranks
    np.testing.assert_array_equal(back.encode(NASTY), tt.encode(NASTY))
    # the file the port writes loads in the JAX package, and the reverse
    jt = j_bpe.BPETokenizer.load(str(tmp_path / "t.json"))
    np.testing.assert_array_equal(jt.encode(NASTY), tt.encode(NASTY))
    j_bpe.BPETokenizer.train(text, 320).save(str(tmp_path / "j.json"))
    with open(tmp_path / "j.json") as a, open(tmp_path / "t.json") as b:
        assert json.load(a) == json.load(b)
    tj = t_bpe.BPETokenizer.load(str(tmp_path / "j.json"))
    np.testing.assert_array_equal(tj.encode(NASTY), tt.encode(NASTY))


def test_from_gpt2_files(tmp_path):
    """GPT-2's encoder.json + vocab.bpe layout, written small by the test:
    the 256 byte tokens, then merges "h e", "l l", "he ll", "Ġ w"."""
    byte_enc = t_bpe.bytes_to_unicode()
    encoder = {byte_enc[b]: i for i, b in enumerate(range(256))}
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("Ġ", "w")]
    for a, b in merges:
        encoder[a + b] = len(encoder)
    with open(tmp_path / "encoder.json", "w") as f:
        json.dump(encoder, f)
    with open(tmp_path / "vocab.bpe", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    args = (str(tmp_path / "encoder.json"), str(tmp_path / "vocab.bpe"))
    tt = t_bpe.BPETokenizer.from_gpt2_files(*args)
    jt = j_bpe.BPETokenizer.from_gpt2_files(*args)
    assert tt.merge_ranks == jt.merge_ranks == {m: i for i, m in enumerate(merges)}
    ids = tt.encode("hello world")
    np.testing.assert_array_equal(ids, jt.encode("hello world"))
    assert [tt.decoder[int(i)] for i in ids][:2] == ["hell", "o"]
    assert tt.decoder[int(ids[2])] == "Ġw"
    assert tt.decode(ids) == "hello world"


def test_token_dataset_windows_and_split_match_jax():
    text = _corpus(0.05)
    kw = dict(path=CORPUS, block_size=16, tokenizer="bpe", bpe_vocab_size=300)
    tds = t_td.TokenDataset(DataConfig.make(**kw), text=text)
    jds = j_td.TokenDataset(JDataConfig.make(**kw), text=text)
    np.testing.assert_array_equal(tds.data, jds.data)
    assert tds.vocab_size == jds.vocab_size and len(tds) == len(jds)
    for i in (0, 7, len(tds) - 1):
        for a, b in zip(tds[i], jds[i]):
            np.testing.assert_array_equal(a, b)
    (ttr, tte), (jtr, jte) = tds.split(), jds.split()
    assert (ttr.start, ttr.stop, tte.start, tte.stop) == (
        jtr.start, jtr.stop, jte.start, jte.stop)
    x, y = ttr.gather(np.array([0, 3]))
    np.testing.assert_array_equal(x[:, 1:], y[:, :-1])
    assert tds.decode(tds.encode("the king")) == "the king"


def test_token_dataset_loads_bpe_path_and_refuses_short_corpora(tmp_path):
    tok = t_bpe.BPETokenizer.train(_corpus(0.05), 280)
    tok.save(str(tmp_path / "tok.json"))
    cfg = DataConfig.make(path=CORPUS, block_size=8, tokenizer="bpe",
                          bpe_path=str(tmp_path / "tok.json"), truncate=0.02)
    ds = t_td.TokenDataset(cfg)
    assert ds.tokenizer.merge_ranks == tok.merge_ranks
    with pytest.raises(ValueError, match="must exceed block_size"):
        t_td.TokenDataset(DataConfig.make(path=CORPUS, block_size=64,
                                          tokenizer="bpe"),
                          text="tiny", tokenizer=tok)


def test_make_dataset_dispatches_on_the_tokenizer():
    text = _corpus(0.05)
    char = t_td.make_dataset(DataConfig.make(path=CORPUS, block_size=16), text=text)
    assert isinstance(char, CharDataset)
    bpe = t_td.make_dataset(DataConfig.make(path=CORPUS, block_size=16,
                                            tokenizer="bpe", bpe_vocab_size=270),
                            text=text)
    assert isinstance(bpe, t_td.TokenDataset) and bpe.vocab_size == 270
    jbpe = j_td.make_dataset(JDataConfig.make(path=CORPUS, block_size=16,
                                              tokenizer="bpe", bpe_vocab_size=270),
                             text=text)
    np.testing.assert_array_equal(bpe.data, jbpe.data)
