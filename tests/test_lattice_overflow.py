"""Node-budget overflow must be loud (VERDICT r1 weak #3).

The reference's lattices are uncapped Python lists (SURVEY.md §4.5); our
static device tensors cap nodes per frame at ``max_nodes_per_frame``.  A
dense homophone frame exceeding the cap silently dropped candidates in
round 1 — a top-1 parity hazard.  These tests pin the new contract: drops
raise/warn per ``config.node_overflow``, and a raised budget is lossless.
"""

import numpy as np
import pytest

from jlm.config import Config
from jlm.data.corpus import build_vocab
from jlm.data.lexicon import Lexicon
from jlm.decoder.engine import pack_lattice_batch
from jlm.decoder.lattice import build_lattice

N_HOMOPHONES = 24  # > default max_nodes_per_frame=16


@pytest.fixture(scope="module")
def dense_vocab():
    # 24 distinct displays sharing the reading "あい" — one frame ending at
    # position 2 of "あい" gets 24 dictionary nodes + the "い" fallback.
    words = [f"愛{i}/あい/名詞" for i in range(N_HOMOPHONES)]
    lines = [" ".join(words)] * 3
    return build_vocab(lines, 256)


@pytest.fixture(scope="module")
def dense_lexicon(dense_vocab):
    return Lexicon.from_vocab(dense_vocab)


def test_overflow_raises(dense_vocab, dense_lexicon):
    cfg = Config(
        vocab_size=256, max_kana_len=30, max_nodes_per_frame=16,
        node_overflow="raise",
    )
    with pytest.raises(ValueError, match="node overflow"):
        build_lattice("あい", dense_lexicon, dense_vocab, cfg)


def test_overflow_warns_and_counts(dense_vocab, dense_lexicon):
    cfg = Config(
        vocab_size=256, max_kana_len=30, max_nodes_per_frame=16,
        node_overflow="warn",
    )
    with pytest.warns(UserWarning, match="node overflow"):
        lat = build_lattice("あい", dense_lexicon, dense_vocab, cfg)
    # frame at pos 2: 24 homophones + 1 single-char node = 25 -> 9 dropped
    assert lat.dropped_nodes == N_HOMOPHONES + 1 - 16


def test_raised_budget_is_lossless(dense_vocab, dense_lexicon):
    cfg = Config(
        vocab_size=256, max_kana_len=30, max_nodes_per_frame=32,
        max_lookahead=48, node_overflow="raise",
    )
    lat = build_lattice("あい", dense_lexicon, dense_vocab, cfg)
    assert lat.dropped_nodes == 0
    # every homophone survives in the frame ending at pos 2
    assert sum(1 for n in lat.frames[2] if n.start == 0) == N_HOMOPHONES


def test_native_builder_matches_overflow_policy(dense_vocab, dense_lexicon):
    from jlm import native

    if not native.available():
        pytest.skip("no native toolchain")
    cfg = Config(
        vocab_size=256, max_kana_len=30, max_nodes_per_frame=16,
        node_overflow="raise",
    )
    builder = native.NativeLatticeBuilder(dense_lexicon, cfg)
    with pytest.raises(ValueError, match="node overflow"):
        builder.pack_batch(["あい"])

    # with a lossless budget, native and python packers agree bit-for-bit
    cfg2 = Config(
        vocab_size=256, max_kana_len=30, max_nodes_per_frame=32,
        max_lookahead=48, node_overflow="raise",
    )
    builder2 = native.NativeLatticeBuilder(dense_lexicon, cfg2)
    packed_n, lengths_n = builder2.pack_batch(["あい"])
    lat = build_lattice("あい", dense_lexicon, dense_vocab, cfg2)
    packed_p, lengths_p = pack_lattice_batch([lat])
    np.testing.assert_array_equal(packed_n, packed_p)
    np.testing.assert_array_equal(lengths_n, lengths_p)
