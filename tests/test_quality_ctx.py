"""Context-dependent corpus, exact ceiling, and n-gram baseline tests.

Pins the machinery behind the reference's quality claims (SURVEY.md §8
quality row; scripts/eval_quality.py runs the full-scale version).
"""

import numpy as np
import pytest

from jlm.config import Config
from jlm.data.corpus import build_vocab
from jlm.data.lexicon import Lexicon
from jlm.data.synthetic_ctx import (
    TOPICS,
    generate_corpus_ctx,
    generate_test_set_ctx,
    generate_test_tokens_ctx,
    pool_probs,
    pool_reading_probs,
)
from jlm.eval.ceiling import bayes_ceiling_ctx, surface_posteriors_ctx
from jlm.oracle.decoder import OracleDecoder
from jlm.oracle.ngram import NgramLM, ngram_config


def test_pool_probs_normalized_and_topic_dependent():
    from jlm.data.synthetic import _NOUNS

    for topic in TOPICS:
        p = pool_probs(_NOUNS, topic)
        assert abs(sum(p) - 1.0) < 1e-9
        assert min(p) > 0
    # the same homophone reading must resolve differently across topics
    nat = pool_reading_probs(_NOUNS, "nature")["あめ"]
    food = pool_reading_probs(_NOUNS, "food")["あめ"]
    best_nat = max(nat, key=lambda t: t[1])[0]
    best_food = max(food, key=lambda t: t[1])[0]
    assert best_nat == "雨" and best_food == "飴"


def test_generator_deterministic():
    assert generate_corpus_ctx(50, seed=7) == generate_corpus_ctx(50, seed=7)
    assert generate_test_set_ctx(20, seed=9) == generate_test_set_ctx(20, seed=9)
    # token variant yields the same sentences
    toks = generate_test_tokens_ctx(20, seed=9)
    tests = generate_test_set_ctx(20, seed=9)
    for (k1, g), (k2, tk) in zip(tests, toks):
        assert k1 == k2
        assert g == "".join(d for d, _r, _p in tk)


def test_ceiling_posterior_contains_gold():
    tests = generate_test_set_ctx(30, seed=11)
    for kana, gold in tests[:10]:
        post = surface_posteriors_ctx(kana)
        assert gold in post, (kana, gold)
        assert all(v >= 0 for v in post.values())
    ceil = bayes_ceiling_ctx(tests)
    # MAP decode must beat random and the posterior must be ambiguous on
    # a topic-conditioned corpus
    assert 0.3 < ceil["top1_ceiling"] <= 1.0
    assert ceil["ambiguous_frac"] > 0.5


def test_ngram_decodes_and_bigram_beats_unigram():
    corpus = generate_corpus_ctx(4000, seed=1234)
    tests = generate_test_set_ctx(60, seed=777)
    vocab = build_vocab(corpus, 50_000)
    lex = Lexicon.from_vocab(vocab)
    cfg = Config(vocab_size=max(256, len(vocab)), beam_width=8)
    accs = {}
    for order in (1, 2):
        lm = NgramLM(vocab, order=order).fit_lines(corpus, vocab)
        dec = OracleDecoder(lm, lex, vocab, ngram_config(cfg))
        accs[order] = np.mean(
            [dec.decode(k)[0].surface == g for k, g in tests]
        )
    # adjacent-word context must help on the topic-conditioned corpus
    assert accs[2] >= accs[1], accs
    assert accs[2] > 0.3


def test_ngram_sequence_nll_sane():
    corpus = generate_corpus_ctx(2000, seed=5)
    vocab = build_vocab(corpus, 50_000)
    lm1 = NgramLM(vocab, order=1).fit_lines(corpus, vocab)
    lm2 = NgramLM(vocab, order=2).fit_lines(corpus, vocab)
    from jlm.data.corpus import encode_corpus

    ids = encode_corpus(corpus[:100], vocab)
    # a bigram fits its own training text at least as well as a unigram
    assert lm2.sequence_nll(ids) < lm1.sequence_nll(ids)
