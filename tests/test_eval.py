"""Eval harness tests."""

from jlm.eval.conversion import _char_correct, evaluate_conversion
from jlm.oracle import OracleDecoder, OracleLM


def test_char_correct_lcs():
    assert _char_correct("今日はいい", "今日はいい") == 5
    assert _char_correct("京はいい", "今日はいい") == 3
    assert _char_correct("", "今日") == 0
    assert _char_correct("abc", "xyz") == 0


def test_evaluate_conversion(tiny_params, tiny_config, lexicon, vocab,
                             test_sentences):
    dec = OracleDecoder(
        OracleLM(tiny_params, tiny_config), lexicon, vocab, tiny_config
    )
    rep = evaluate_conversion(dec, test_sentences[:5], batched=False)
    assert rep.sentences == 5
    assert 0.0 <= rep.sentence_accuracy <= 1.0
    assert 0.0 <= rep.char_accuracy <= 1.0
    assert rep.chars_per_sec > 0
    assert "top1_acc" in rep.summary()


def test_evaluate_conversion_batched(tiny_params, tiny_config, lexicon, vocab,
                                     test_sentences):
    from jlm.decoder.engine import BeamDecoder

    dec = BeamDecoder(tiny_params, lexicon, vocab, tiny_config)
    rep_b = evaluate_conversion(dec, test_sentences[:4], batched=True)
    rep_s = evaluate_conversion(dec, test_sentences[:4], batched=False)
    assert rep_b.exact_match == rep_s.exact_match
    assert rep_b.char_correct == rep_s.char_correct


def test_nbest_oracle_accuracy(tiny_params, tiny_config, lexicon, vocab):
    """n-best oracle accuracy >= top-1 accuracy, and counts gold anywhere
    in the candidate list."""
    from jlm.data import generate_test_set
    from jlm.decoder.engine import BeamDecoder
    from jlm.eval import evaluate_conversion

    cfg = tiny_config.replace(n_best_max=4)
    eng = BeamDecoder(tiny_params, lexicon, vocab, cfg)
    tests = generate_test_set(8, seed=11)
    r1 = evaluate_conversion(eng, tests, n_best=1)
    r4 = evaluate_conversion(eng, tests, n_best=4)
    assert r4.nbest_accuracy >= r1.sentence_accuracy
    assert r4.n_best == 4
    assert "top4_acc" in r4.summary()
