"""Oracle LM + decoder behavior tests (SURVEY.md §4.2, §4.5-4.6, §6.1)."""

import numpy as np
import pytest

from jlm.config import EOS_ID, UNK_ID
from jlm.decoder.lattice import build_lattice
from jlm.oracle import OracleDecoder, OracleLM
from jlm.ops.quant import dequantize_weight, quantize_params, quantize_weight


@pytest.fixture(scope="module")
def lm(tiny_params, tiny_config):
    return OracleLM(tiny_params, tiny_config)


@pytest.fixture(scope="module")
def decoder(lm, lexicon, vocab, tiny_config):
    return OracleDecoder(lm, lexicon, vocab, tiny_config)


def test_step_is_normalized_logprob(lm):
    state = lm.initial_state(3)
    logp, (c, h) = lm.step(np.array([0, 1, 2], np.int32), state)
    assert logp.shape == (3, lm.config.vocab_size)
    np.testing.assert_allclose(np.exp(logp).sum(axis=1), 1.0, rtol=1e-5)
    assert c.shape == (1, 3, lm.config.hidden_size)
    assert not np.allclose(h, 0)


def test_step_state_carry_changes_distribution(lm):
    s0 = lm.initial_state(1)
    x = np.array([5], np.int32)
    logp1, s1 = lm.step(x, s0)
    logp2, _ = lm.step(x, s1)
    assert not np.allclose(logp1, logp2)


def test_lattice_structure(lexicon, vocab, tiny_config):
    lat = build_lattice("きょうは", lexicon, vocab, tiny_config)
    assert lat.length == 4
    # every frame 1..T non-empty (connectivity fallback)
    for j in range(1, 5):
        assert lat.frames[j], f"frame {j} empty"
    # きょう spans (0,3]: frame 3 must hold at least 今日 and 京
    f3 = {n.display for n in lat.frames[3]}
    assert "今日" in f3
    # canonical order: starts non-decreasing
    for j in range(1, 5):
        starts = [n.start for n in lat.frames[j]]
        assert starts == sorted(starts)
    # padded tensors agree with frames
    for j in range(1, 5):
        k = len(lat.frames[j])
        assert lat.node_mask[j - 1, :k].all()
        assert not lat.node_mask[j - 1, k:].any()


def test_lattice_unknown_kana_fallback(lexicon, vocab, tiny_config):
    lat = build_lattice("ゑび", lexicon, vocab, tiny_config)
    n = lat.frames[1][0]
    assert n.word_id == UNK_ID and n.display == "ゑ"


def test_lookahead_indexing(lexicon, vocab, tiny_config):
    lat = build_lattice("きょうはいいてんき", lexicon, vocab, tiny_config)
    for j in range(1, lat.length + 1):
        for k, node in enumerate(lat.frames[j]):
            ci = lat.node_cand_idx[j - 1, k]
            assert lat.lookahead_words[node.start, ci] == node.word_id
            assert lat.lookahead_mask[node.start, ci]


def test_decode_returns_valid_surface(decoder):
    res = decoder.decode("きょうはいい", n_best=3)
    assert len(res) >= 1
    top = res[0]
    # surface reading must reconstruct the input via segments' readings
    assert isinstance(top.surface, str) and len(top.surface) >= 1
    assert top.score < 0  # log-prob sum
    # n-best is sorted descending
    scores = [r.score for r in res]
    assert scores == sorted(scores, reverse=True)


def test_decode_greedy_is_beam1_prefix(decoder, lm, lexicon, vocab, tiny_config):
    greedy_cfg = tiny_config.replace(beam_width=1)
    greedy = OracleDecoder(lm, lexicon, vocab, greedy_cfg)
    r1 = greedy.decode("はしをわたる" if False else "きょうはいい")[0]
    rb = decoder.decode("きょうはいい")[0]
    # beam search must score at least as high as greedy
    assert rb.score >= r1.score - 1e-6


def test_decode_deterministic(decoder):
    a = decoder.decode("あめがふる", n_best=2)
    b = decoder.decode("あめがふる", n_best=2)
    assert [(r.surface, r.score) for r in a] == [(r.surface, r.score) for r in b]


def test_quantize_roundtrip_tolerance(tiny_params):
    w = tiny_params["head"]["W"]
    q = quantize_weight(w, axis=0)
    wd = dequantize_weight(q, axis=0)
    # max error bounded by scale/2 per entry
    err = np.abs(wd - w)
    bound = q["scale"][None, :] * 0.5 + 1e-8
    assert (err <= bound).all()


def test_quantized_oracle_close(tiny_params, tiny_config, lexicon, vocab):
    qparams = quantize_params(tiny_params)
    lm_f = OracleLM(tiny_params, tiny_config)
    lm_q = OracleLM(qparams, tiny_config)
    s = lm_f.initial_state(2)
    x = np.array([3, 7], np.int32)
    lp_f, _ = lm_f.step(x, s)
    lp_q, _ = lm_q.step(x, lm_q.initial_state(2))
    assert np.abs(lp_f - lp_q).max() < 0.1  # int8 tolerance, small rand weights
