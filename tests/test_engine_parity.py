"""Device-resident decoder vs numpy oracle: top-1 path parity.

This is the build's central parity gate (BASELINE north star: "decoded
conversions must match the reference outputs — same top-1 paths, LM scores
within quantization tolerance"; SURVEY.md §9.3.5).  The oracle plays the
reference; the engine must reproduce its paths exactly in fp32 and within
int8 tolerance when quantized.
"""

import numpy as np
import pytest

from jlm.config import Config, DSoftmaxConfig
from jlm.decoder.engine import BeamDecoder
from jlm.models import init_params
from jlm.oracle import OracleDecoder, OracleLM
from jlm.ops.quant import quantize_params


@pytest.fixture(scope="module")
def oracle(tiny_params, tiny_config, lexicon, vocab):
    return OracleDecoder(
        OracleLM(tiny_params, tiny_config), lexicon, vocab, tiny_config
    )


@pytest.fixture(scope="module")
def engine(tiny_params, tiny_config, lexicon, vocab):
    return BeamDecoder(tiny_params, lexicon, vocab, tiny_config)


KANAS = [
    "きょうはいい",
    "あめがふる",
    "はしをみる",
    "かみとかわ",
    "きょうはいいてんき",
    "ゑ",  # unknown fallback
    "とてもさむいです",
]


@pytest.mark.parametrize("kana", KANAS)
def test_top1_parity(engine, oracle, kana):
    r_e = engine.decode(kana, n_best=3)
    r_o = oracle.decode(kana, n_best=3)
    assert r_e[0].segments == r_o[0].segments, (
        f"top-1 path mismatch for {kana}: {r_e[0].surface} vs {r_o[0].surface}"
    )
    assert abs(r_e[0].score - r_o[0].score) < 1e-3
    # n-best score lists match too
    np.testing.assert_allclose(
        [r.score for r in r_e], [r.score for r in r_o[: len(r_e)]], atol=1e-3
    )


def test_greedy_config_parity(tiny_params, tiny_config, lexicon, vocab):
    """BASELINE config 1: beam_width=1 greedy Viterbi."""
    cfg = tiny_config.replace(beam_width=1)
    eng = BeamDecoder(tiny_params, lexicon, vocab, cfg)
    orc = OracleDecoder(OracleLM(tiny_params, cfg), lexicon, vocab, cfg)
    for kana in ["きょうはいい", "あめがふる"]:
        assert eng.decode(kana)[0].segments == orc.decode(kana)[0].segments


def test_batch_decode_matches_single(engine):
    kanas = ["きょうはいい", "あめがふる", "はしをみる"]
    batched = engine.decode_batch(kanas, n_best=2)
    for kana, res in zip(kanas, batched):
        single = engine.decode(kana, n_best=2)
        assert [r.segments for r in res] == [r.segments for r in single]
        np.testing.assert_allclose(
            [r.score for r in res], [r.score for r in single], atol=1e-4
        )


def test_stream_sorted_chunks_restore_order(engine):
    """decode_stream with length sorting returns results in ORIGINAL order
    and identical to unsorted chunking (chunks regroup by length but each
    lattice is independent)."""
    kanas = [
        "きょうはいいてんき", "ゑ", "あめがふる", "はしをみる",
        "かみとかわ", "とてもさむいです", "きょうはいい",
    ]
    sorted_res = engine.decode_stream(kanas, chunk_size=3, n_best=1)
    plain_res = engine.decode_stream(
        kanas, chunk_size=3, n_best=1, sort_by_length=False
    )
    assert len(sorted_res) == len(plain_res) == len(kanas)
    for kana, rs, rp in zip(kanas, sorted_res, plain_res):
        assert [r.segments for r in rs] == [r.segments for r in rp], kana
        single = engine.decode(kana, n_best=1)
        assert rs[0].segments == single[0].segments, kana


def test_t_bucket_rule(tiny_params, tiny_config, lexicon, vocab):
    """Frame buckets honor config.t_bucket_multiple (min 4)."""
    eng = BeamDecoder(tiny_params, lexicon, vocab, tiny_config)
    assert eng._t_bucket(1) == 4
    assert eng._t_bucket(4) == 4
    assert eng._t_bucket(5) == 5  # default multiple 1: exact max length
    assert eng._t_bucket(9) == 9
    eng4 = BeamDecoder(tiny_params, lexicon, vocab,
                       tiny_config.replace(t_bucket_multiple=4))
    assert eng4._t_bucket(5) == 8
    assert eng4._t_bucket(9) == 12
    assert eng4._t_bucket(14) == 16


def test_quantized_parity_tolerance(tiny_params, tiny_config, lexicon, vocab):
    """int8 engine vs int8 oracle: identical paths, scores match closely

    (both dequantize the same int8 weights, so the only divergence is
    numpy-vs-XLA fp32 rounding)."""
    qp = quantize_params(tiny_params)
    eng = BeamDecoder(qp, lexicon, vocab, tiny_config)
    orc = OracleDecoder(OracleLM(qp, tiny_config), lexicon, vocab, tiny_config)
    for kana in ["きょうはいいてんき", "かみとかわ"]:
        r_e, r_o = eng.decode(kana)[0], orc.decode(kana)[0]
        assert r_e.segments == r_o.segments
        assert abs(r_e.score - r_o.score) < 1e-3


def test_dsoftmax_engine_parity(lexicon, vocab):
    cfg = Config(
        vocab_size=256,
        embed_size=32,
        hidden_size=64,
        head="dsoftmax",
        dsoftmax=DSoftmaxConfig(
            block_sizes=(64, 64, 128), block_dims=(64, 32, 16), mode="prefix"
        ),
        beam_width=4,
        max_kana_len=30,
        seed=42,
    )
    params = init_params(cfg)
    eng = BeamDecoder(params, lexicon, vocab, cfg)
    orc = OracleDecoder(OracleLM(params, cfg), lexicon, vocab, cfg)
    for kana in ["きょうはいい", "はしをみる"]:
        r_e, r_o = eng.decode(kana)[0], orc.decode(kana)[0]
        assert r_e.segments == r_o.segments
        assert abs(r_e.score - r_o.score) < 1e-3


def test_pallas_forward_top1_parity(tiny_params, tiny_config, lexicon, vocab, oracle):
    """Engine with the Pallas projection head (interpret on CPU) == oracle."""
    from jlm.decoder.engine import make_pallas_forward

    fwd = make_pallas_forward(tiny_config, interpret=True, block_v=64)
    eng = BeamDecoder(tiny_params, lexicon, vocab, tiny_config, forward_fn=fwd)
    for kana in ["きょうはいい", "あめがふる"]:
        r_e, r_o = eng.decode(kana)[0], oracle.decode(kana)[0]
        assert r_e.segments == r_o.segments, kana
        assert abs(r_e.score - r_o.score) < 1e-3


def test_pallas_forward_int8_parity(tiny_params, tiny_config, lexicon, vocab):
    from jlm.decoder.engine import make_pallas_forward

    qp = quantize_params(tiny_params)
    # int8_mxu=False: this test pins the EXACT dequant path (the parity
    # reference); the int8 x int8 default adds activation-quant tolerance and
    # is covered by test_pallas_forward_int8_mxu_top1 below.
    fwd = make_pallas_forward(tiny_config, interpret=True, block_v=64,
                              int8_mxu=False)
    eng = BeamDecoder(qp, lexicon, vocab, tiny_config, forward_fn=fwd)
    orc = OracleDecoder(OracleLM(qp, tiny_config), lexicon, vocab, tiny_config)
    r_e, r_o = eng.decode("かみとかわ")[0], orc.decode("かみとかわ")[0]
    assert r_e.segments == r_o.segments
    assert abs(r_e.score - r_o.score) < 1e-3


def test_pallas_forward_bf16_speed_mode_top1(tiny_params, tiny_config, lexicon, vocab, oracle):
    """bf16 speed mode (bf16 matmuls + bf16 state ring caches): top-1 must
    still match the oracle at tiny dims; scores within bf16 tolerance."""
    import jax.numpy as jnp

    from jlm.decoder.engine import make_pallas_forward

    fwd = make_pallas_forward(tiny_config, compute_dtype=jnp.bfloat16,
                              interpret=True, block_v=64)
    eng = BeamDecoder(tiny_params, lexicon, vocab, tiny_config, forward_fn=fwd)
    for kana in ["きょうはいい", "あめがふる"]:
        r_e, r_o = eng.decode(kana)[0], oracle.decode(kana)[0]
        assert r_e.segments == r_o.segments, kana
        assert abs(r_e.score - r_o.score) < 0.1


def test_pallas_forward_int8_mxu_top1(tiny_params, tiny_config, lexicon, vocab):
    """int8 x int8 head (int8 activations too): top-1 stable vs the
    exact-dequant int8 oracle at tiny dims."""
    import jax.numpy as jnp

    from jlm.decoder.engine import make_pallas_forward

    qp = quantize_params(tiny_params)
    fwd = make_pallas_forward(tiny_config, compute_dtype=jnp.bfloat16,
                              interpret=True, block_v=64, int8_mxu=True)
    eng = BeamDecoder(qp, lexicon, vocab, tiny_config, forward_fn=fwd)
    orc = OracleDecoder(OracleLM(qp, tiny_config), lexicon, vocab, tiny_config)
    r_e, r_o = eng.decode("かみとかわ")[0], orc.decode("かみとかわ")[0]
    assert r_e.segments == r_o.segments
    assert abs(r_e.score - r_o.score) < 0.2


def test_two_layer_engine_parity(lexicon, vocab):
    """BASELINE config 5 model shape (2-layer) decodes with oracle parity."""
    cfg = Config(
        vocab_size=256, embed_size=32, hidden_size=64, num_layers=2,
        beam_width=4, max_kana_len=30, seed=42,
    )
    params = init_params(cfg)
    eng = BeamDecoder(params, lexicon, vocab, cfg)
    orc = OracleDecoder(OracleLM(params, cfg), lexicon, vocab, cfg)
    for kana in ["きょうはいいてんき", "はしをみる"]:
        r_e, r_o = eng.decode(kana)[0], orc.decode(kana)[0]
        assert r_e.segments == r_o.segments
        assert abs(r_e.score - r_o.score) < 1e-3


def test_native_builder_bit_identical(tiny_config, lexicon, vocab):
    """C++ lattice builder output == python builder output, bit for bit."""
    from jlm import native
    from jlm.decoder.engine import pack_lattice_batch
    from jlm.decoder.lattice import build_lattice

    if not native.available():
        pytest.skip("no C++ toolchain")
    builder = native.NativeLatticeBuilder(lexicon, tiny_config)
    kanas = ["きょうはいいてんき", "ゑび", "あめがふる", "かみとかわとき"]
    packed_n, len_n = builder.pack_batch(kanas)
    lats = [build_lattice(k, lexicon, vocab, tiny_config) for k in kanas]
    packed_p, len_p = pack_lattice_batch(lats)
    np.testing.assert_array_equal(len_n, len_p)
    np.testing.assert_array_equal(packed_n, packed_p)


def test_native_decode_matches_python_builder(tiny_params, tiny_config,
                                              lexicon, vocab, oracle):
    from jlm import native

    if not native.available():
        pytest.skip("no C++ toolchain")
    eng_n = BeamDecoder(tiny_params, lexicon, vocab, tiny_config,
                        use_native=True)
    eng_p = BeamDecoder(tiny_params, lexicon, vocab, tiny_config,
                        use_native=False)
    for kana in ["きょうはいい", "ゑとかみ"]:
        rn, rp = eng_n.decode(kana, 2), eng_p.decode(kana, 2)
        assert [r.segments for r in rn] == [r.segments for r in rp]
        ro = oracle.decode(kana, 2)
        assert rn[0].segments == ro[0].segments


def test_gather_modes_identical(tiny_params, tiny_config, lexicon, vocab):
    """gather_mode 'take' and 'onehot' (the default) must produce
    bit-identical paths and scores — selection by 0/1 matmul is exact
    (einsums pinned to Precision.HIGHEST; a default-precision fp32 matmul
    may round its operands on an accelerator)."""
    kanas = ["きょうはいいてんき", "あめがふる", "かみとかわ", "はしをみる"]
    res = {}
    for mode in ("take", "onehot"):
        eng = BeamDecoder(tiny_params, lexicon, vocab,
                          tiny_config.replace(gather_mode=mode),
                          precision="highest")
        res[mode] = eng.decode_batch(kanas, n_best=2)
    for a, b in zip(res["take"], res["onehot"]):
        assert [r.segments for r in a] == [r.segments for r in b]
        for x, y in zip(a, b):
            assert abs(x.score - y.score) < 1e-6
