"""Data-layer tests: vocab, lexicon, encoding, BPTT reader (SURVEY.md §4.1)."""

import numpy as np

from jlm.config import EOS_ID, UNK_ID
from jlm.data import bptt_batches, parse_line
from jlm.data.corpus import parse_token
from jlm.data.reader import num_bptt_batches


def test_parse_token_triple():
    t = parse_token("今日/きょう/名詞")
    assert (t.display, t.reading, t.pos) == ("今日", "きょう", "名詞")


def test_vocab_frequency_ordered(vocab):
    # ids after specials must be non-increasing in corpus frequency
    counts = vocab.counts[2:]
    assert np.all(counts[:-1] >= counts[1:])
    assert vocab.tokens[EOS_ID].display == "<eos>"
    assert vocab.tokens[UNK_ID].display == "<unk>"


def test_vocab_lookup_roundtrip(vocab):
    tok = vocab.tokens[5]
    assert vocab.lookup(tok) == 5
    missing = parse_token("存在しない/そんざいしない/名詞")
    assert vocab.lookup(missing) == UNK_ID


def test_lexicon_homophones(lexicon, vocab):
    cands = lexicon.candidates("きょう")
    assert len(cands) >= 2  # 今日 / 京 at minimum
    displays = {vocab.display(w) for w, _ in cands}
    assert "今日" in displays
    # frequency-ordered candidate list: ids ascending
    wids = [w for w, _ in cands]
    assert wids == sorted(wids)


def test_lexicon_single_char_fallback(lexicon):
    # an unknown single kana must still yield an <unk> node
    cands = lexicon.candidates("ゑ")
    assert cands == [(UNK_ID, "ゑ")]
    assert lexicon.candidates("ゑゑ") == []


def test_encoded_corpus_has_eos(encoded):
    train, dev, test = encoded
    assert train.dtype == np.int32
    assert (train == EOS_ID).sum() > 0
    assert len(dev) > 0 and len(test) > 0


def test_bptt_batches_shapes_and_shift(encoded):
    train, _, _ = encoded
    bs, ns = 4, 8
    n = 0
    for x, y in bptt_batches(train, bs, ns):
        assert x.shape == (bs, ns) and y.shape == (bs, ns)
        n += 1
    assert n == num_bptt_batches(len(train), bs, ns)
    # target shift: y of batch row equals x shifted by one within the stream
    xs = list(bptt_batches(train, bs, ns))
    x0, y0 = xs[0]
    x1, _ = xs[1]
    assert np.array_equal(y0[:, :-1], x0[:, 1:])
    assert np.array_equal(y0[:, -1], x1[:, 0])
