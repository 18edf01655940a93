"""Streaming corpus prep + native C++ encoder vs the in-memory reference.

The load-bearing property: the streamed/native path is BIT-IDENTICAL to
build_vocab/encode_corpus/split_corpus (ref behavior, SURVEY.md §4.1/§5.1),
including chunk boundaries that fall mid-line and the parse_token key
normalization for 0/1/2-slash tokens.
"""

import os

import numpy as np
import pytest

from jlm.data import (
    build_vocab,
    encode_corpus,
    generate_corpus,
    split_corpus,
)
from jlm.data.io import load_dataset
from jlm.data.streaming import (
    build_vocab_file,
    encode_corpus_file,
    iter_line_chunks,
    save_dataset_streamed,
)

NASTY = [
    "今日/きょう/名詞 は/は/助詞",
    "",  # blank line: no ids, no <eos>
    "   ",  # whitespace-only line
    "a/b  c/d/e\tf",  # 1-slash, 2-slash, 0-slash tokens, tabs, double space
    "x//y/名詞 のこと/のこと/名詞",  # display containing a slash
    "未知語/みちご/名詞",  # unseen at vocab build time -> <unk>
]


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("stream") / "corpus.txt"
    lines = generate_corpus(n_sentences=400, seed=99) + NASTY
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path), lines


def test_iter_line_chunks_reassembles(corpus_file):
    path, lines = corpus_file
    raw = open(path, "rb").read()
    for chunk_bytes in (17, 256, 1 << 20):
        chunks = list(iter_line_chunks(path, chunk_bytes))
        assert b"".join(chunks) == raw
        for ch in chunks[:-1]:
            assert ch.endswith(b"\n")


def test_streaming_vocab_matches_inmemory(corpus_file):
    path, lines = corpus_file
    v_s = build_vocab_file(path, 256)
    v_m = build_vocab(lines, 256)
    assert [t.key for t in v_s.tokens] == [t.key for t in v_m.tokens]
    np.testing.assert_array_equal(v_s.counts, v_m.counts)


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("chunk_bytes", [64, 1 << 20])
def test_streamed_encode_bit_identical(corpus_file, tmp_path, use_native,
                                       chunk_bytes):
    path, lines = corpus_file
    if use_native:
        from jlm.native import encoder_lib

        if not encoder_lib.available():
            pytest.skip("no C++ toolchain")
    vocab = build_vocab(lines, 256)
    ref = encode_corpus(lines, vocab)
    out = str(tmp_path / f"c_{use_native}_{chunk_bytes}.bin")
    n = encode_corpus_file(path, vocab, out, chunk_bytes, use_native)
    got = np.fromfile(out, dtype="<i4")
    assert n == len(ref)
    np.testing.assert_array_equal(got, ref)


def test_save_dataset_streamed_and_memmap_load(corpus_file, tmp_path):
    path, lines = corpus_file
    data_dir = str(tmp_path / "d")
    vocab, n = save_dataset_streamed(data_dir, path, 256)
    v2, train, dev, test = load_dataset(data_dir)
    assert isinstance(train, np.memmap)
    assert [t.key for t in v2.tokens] == [t.key for t in vocab.tokens]
    ref = encode_corpus(lines, vocab)
    tr_r, dv_r, te_r = split_corpus(ref)
    np.testing.assert_array_equal(np.asarray(train), tr_r)
    np.testing.assert_array_equal(np.asarray(dev), dv_r)
    np.testing.assert_array_equal(np.asarray(test), te_r)


def test_memmap_feeds_bptt_batches(corpus_file, tmp_path):
    from jlm.data.reader import bptt_batches

    path, _ = corpus_file
    data_dir = str(tmp_path / "d2")
    save_dataset_streamed(data_dir, path, 256)
    _, train, _, _ = load_dataset(data_dir)
    xs = list(bptt_batches(train, batch_size=4, num_steps=8))
    assert len(xs) > 0
    x, y = xs[0]
    assert x.shape == (4, 8) and y.shape == (4, 8)
    np.testing.assert_array_equal(np.asarray(x)[:, 1:], np.asarray(y)[:, :-1])
