"""Head-kernel tests (Pallas interpret mode on the CPU; SURVEY.md §9.1 layer 4).

The normaliser kernel (:func:`jlm.ops.project.project_lse`) ships with a
plain fp32 reference; candidate log-probs here are the kernel's lse
subtracted from exact candidate logits, checked against
:func:`project_candidates_ref`.  Tolerances: 1e-4 absolute for fp32
operands (the kernel and the reference differ only in summation order);
3e-2 for bf16 operands (8-bit mantissa on K=64..512 dot products); 0.05
for the int8 x int8 product (per-row activation quantization, the bound
pinned by ``test_int8_mxu_score_error_bound``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jlm.config import Config, DSoftmaxConfig
from jlm.ops.project import (
    launch_params,
    merge_ms,
    project_candidates_ref,
    project_lse,
    project_lse_plain,
    project_ms,
)
from jlm.ops.quant import quantize_weight


def kernel_candidates(h, w, scale, b, cand, compute_dtype=jnp.float32,
                      **launch):
    """Candidate log-probs with the kernel's lse: ``logit[cand] - lse``."""
    cfg = Config(vocab_size=w.shape[1], hidden_size=h.shape[1])
    W = w if scale is None else {"q": w, "scale": scale}
    lse = project_lse(h, {"W": W, "b": b}, cfg, compute_dtype=compute_dtype,
                      interpret=True, **launch)
    wf = w.astype(jnp.float32)
    if scale is not None:
        wf = wf * scale[None, :]
    raw = jnp.dot(h, wf[:, cand], precision=jax.lax.Precision.HIGHEST)
    return raw + b[cand][None, :] - lse


@pytest.mark.parametrize("B,H,V,C", [(16, 512, 4096, 65), (8, 256, 2048, 17)])
def test_project_candidates_fp32(B, H, V, C):
    rng = np.random.default_rng(0)
    h = jnp.asarray(rng.normal(size=(B, H)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(H, V)).astype(np.float32) * 0.05)
    b = jnp.asarray(rng.normal(size=(V,)).astype(np.float32) * 0.01)
    cand = jnp.asarray(rng.integers(0, V, C).astype(np.int32))
    out = kernel_candidates(h, w, None, b, cand, block_v=1024)
    ref = project_candidates_ref(h, w, None, b, cand)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-4)


def test_project_candidates_int8():
    rng = np.random.default_rng(1)
    B, H, V, C = 16, 512, 4096, 65
    h = jnp.asarray(rng.normal(size=(B, H)).astype(np.float32))
    w_f = rng.normal(size=(H, V)).astype(np.float32) * 0.05
    q = quantize_weight(w_f, axis=0)
    b = jnp.asarray(rng.normal(size=(V,)).astype(np.float32) * 0.01)
    cand = jnp.asarray(rng.integers(0, V, C).astype(np.int32))
    out = kernel_candidates(h, jnp.asarray(q["q"]), jnp.asarray(q["scale"]),
                            b, cand, block_v=1024)
    # reference: dequantized fp32 math — the oracle's int8 parity rule
    ref = project_candidates_ref(
        h, jnp.asarray(q["q"]), jnp.asarray(q["scale"]), b, cand
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-4)


def test_project_candidates_int8_mxu_native():
    """int8 x int8 -> int32 product, rescaled in fp32.  Activation
    quantization adds ~1/255 relative error per element; with H=512 the
    lse error stays well under 0.05 for unit-scale activations
    (tolerance-tested, not exact — the exact path is the dequant mode)."""
    rng = np.random.default_rng(3)
    B, H, V, C = 16, 512, 4096, 65
    h = jnp.asarray(rng.normal(size=(B, H)).astype(np.float32))
    w_f = rng.normal(size=(H, V)).astype(np.float32) * 0.05
    q = quantize_weight(w_f, axis=0)
    b = jnp.asarray(rng.normal(size=(V,)).astype(np.float32) * 0.01)
    cand = jnp.asarray(rng.integers(0, V, C).astype(np.int32))
    out = kernel_candidates(h, jnp.asarray(q["q"]), jnp.asarray(q["scale"]),
                            b, cand, block_v=1024, int8_mxu=True)
    ref = project_candidates_ref(
        h, jnp.asarray(q["q"]), jnp.asarray(q["scale"]), b, cand
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=0.05)
    # top-1 candidate must be stable under activation quantization here
    np.testing.assert_array_equal(
        np.argmax(np.asarray(out), axis=1), np.argmax(np.asarray(ref), axis=1)
    )


def test_int8_mxu_score_error_bound():
    """Pins the activation-quantization score-error bound of the DEFAULT
    int8 x int8 head (config.int8_mxu=True): at the engine's H=512 with
    unit-scale activations, candidate log-probs deviate < 0.05 from the
    exact-dequant path.  If this bound drifts, the beam-parity tolerance
    in bench.py and the oracle referee tolerances are wrong."""
    rng = np.random.default_rng(11)
    B, H, V, C = 32, 512, 4096, 65
    h = jnp.asarray(rng.normal(size=(B, H)).astype(np.float32))
    q = quantize_weight(rng.normal(size=(H, V)).astype(np.float32) * 0.05,
                        axis=0)
    b = jnp.asarray(rng.normal(size=(V,)).astype(np.float32) * 0.01)
    cand = jnp.asarray(rng.integers(0, V, C).astype(np.int32))
    args = (h, jnp.asarray(q["q"]), jnp.asarray(q["scale"]), b, cand)
    mxu = kernel_candidates(*args, block_v=1024, int8_mxu=True)
    deq = kernel_candidates(*args, block_v=1024, int8_mxu=False)
    err = float(np.max(np.abs(np.asarray(mxu) - np.asarray(deq))))
    assert err < 0.05, f"int8 x int8 activation-quant error {err} exceeds bound"


def test_project_lse_int8_mxu_matches_dequant():
    rng = np.random.default_rng(4)
    B, H, V = 8, 256, 2048
    cfg = Config(vocab_size=V, embed_size=64, hidden_size=H)
    h = jnp.asarray(rng.normal(size=(B, H)).astype(np.float32))
    q = quantize_weight(rng.normal(size=(H, V)).astype(np.float32) * 0.05, axis=0)
    head = {"W": {"q": jnp.asarray(q["q"]), "scale": jnp.asarray(q["scale"])},
            "b": jnp.zeros((V,), jnp.float32)}
    lse_n = project_lse(h, head, cfg, block_v=512, interpret=True,
                        int8_mxu=True)
    lse_d = project_lse(h, head, cfg, block_v=512, interpret=True)
    np.testing.assert_allclose(np.asarray(lse_n), np.asarray(lse_d), atol=0.05)


def test_project_candidates_unaligned_vocab():
    """V not a multiple of the tile: masked columns must not leak into lse."""
    rng = np.random.default_rng(2)
    B, H, V, C = 4, 128, 1000, 7
    h = jnp.asarray(rng.normal(size=(B, H)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(H, V)).astype(np.float32) * 0.1)
    b = jnp.zeros((V,), jnp.float32)
    cand = jnp.asarray([0, 1, 999, 500, 500, 3, 42], jnp.int32)
    out = kernel_candidates(h, w, None, b, cand, block_v=512)
    ref = project_candidates_ref(h, w, None, b, cand)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-4)
    # duplicate candidate columns agree
    np.testing.assert_allclose(np.asarray(out)[:, 3], np.asarray(out)[:, 4])


def test_project_candidates_remainder_chunk():
    """The last vocab tile is short (V=300, tile 256): its weight, scale
    and bias loads are masked at the remainder width."""
    rng = np.random.default_rng(7)
    B, H, V, C = 4, 128, 300, 9
    h = jnp.asarray(rng.normal(size=(B, H)).astype(np.float32))
    w_f = rng.normal(size=(H, V)).astype(np.float32) * 0.1
    b = jnp.asarray(rng.normal(size=(V,)).astype(np.float32) * 0.01)
    cand = jnp.asarray([0, 1, 299, 150, 257, 255, 256, 42, 299], jnp.int32)
    out = kernel_candidates(h, jnp.asarray(w_f), None, b, cand, block_v=256)
    ref = project_candidates_ref(h, jnp.asarray(w_f), None, b, cand)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-4)
    # quantized variant exercises the scale-slice width too
    q = quantize_weight(w_f, axis=0)
    out_q = kernel_candidates(h, jnp.asarray(q["q"]), jnp.asarray(q["scale"]),
                              b, cand, block_v=256)
    ref_q = project_candidates_ref(
        h, jnp.asarray(q["q"]), jnp.asarray(q["scale"]), b, cand
    )
    np.testing.assert_allclose(np.asarray(out_q), np.asarray(ref_q), atol=1e-4)


def test_project_candidates_normalization():
    """exp(logp) over ALL vocab ids sums to 1 — lse is global."""
    rng = np.random.default_rng(3)
    B, H, V = 2, 64, 256
    h = jnp.asarray(rng.normal(size=(B, H)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(H, V)).astype(np.float32) * 0.1)
    b = jnp.zeros((V,), jnp.float32)
    cand = jnp.arange(V, dtype=jnp.int32)
    out = kernel_candidates(h, w, None, b, cand, block_v=64)
    np.testing.assert_allclose(np.exp(np.asarray(out)).sum(axis=1), 1.0,
                               rtol=1e-4)


def _dsoftmax_case(mode, quantized, seed):
    rng = np.random.default_rng(seed)
    H = 64
    dims = (64, 32, 16) if mode == "prefix" else (32, 16, 16)
    cfg = Config(
        vocab_size=768, embed_size=32, hidden_size=H, head="dsoftmax",
        dsoftmax=DSoftmaxConfig(block_sizes=(256, 256, 256), block_dims=dims,
                                mode=mode),
    )
    blocks, dense = [], []
    offset = 0
    for s, d in zip(cfg.dsoftmax.block_sizes, dims):
        w = rng.normal(size=(d, s)).astype(np.float32) * 0.1
        b = jnp.asarray(rng.normal(size=(s,)).astype(np.float32) * 0.01)
        if quantized:
            q = quantize_weight(w, axis=0)
            W = {"q": jnp.asarray(q["q"]), "scale": jnp.asarray(q["scale"])}
            w = q["q"].astype(np.float32) * q["scale"][None, :]
        else:
            W = jnp.asarray(w)
        blocks.append({"W": W, "b": b})
        lo = 0 if mode == "prefix" else offset
        dense.append(np.pad(w, ((lo, H - lo - d), (0, 0))))
        offset += d
    dense = jnp.asarray(np.concatenate(dense, axis=1))
    bias = jnp.concatenate([b["b"] for b in blocks])
    h = jnp.asarray(rng.normal(size=(8, H)).astype(np.float32))
    return cfg, {"blocks": blocks}, h, dense, bias


def test_project_candidates_dsoftmax_matches_dense():
    cfg, head, h, dense, bias = _dsoftmax_case("prefix", False, 7)
    cand = jnp.asarray([0, 255, 256, 511, 512, 767, 100], jnp.int32)
    lse = project_lse(h, head, cfg, compute_dtype=jnp.float32,
                      interpret=True, block_v=128)
    out = (jnp.dot(h, dense[:, cand], precision=jax.lax.Precision.HIGHEST)
           + bias[cand] - lse)
    ref = project_candidates_ref(h, dense, None, bias, cand)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-4)


def test_project_candidates_dsoftmax_int8():
    cfg, head, h, dense, bias = _dsoftmax_case("prefix", True, 8)
    cand = jnp.asarray([0, 100, 300, 511, 767], jnp.int32)
    lse = project_lse(h, head, cfg, compute_dtype=jnp.float32,
                      interpret=True, block_v=128)
    out = (jnp.dot(h, dense[:, cand], precision=jax.lax.Precision.HIGHEST)
           + bias[cand] - lse)
    ref = project_candidates_ref(h, dense, None, bias, cand)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-4)


# ---------------------------------------------------------------------------
# Padding, D-softmax modes and the vocab split
# ---------------------------------------------------------------------------

def _full_case(R, H, V, seed=0):
    rng = np.random.default_rng(seed)
    cfg = Config(vocab_size=V, hidden_size=H)
    h = jnp.asarray(rng.normal(size=(R, H)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(H, V)).astype(np.float32) * 0.1)
    b = jnp.asarray(rng.normal(size=(V,)).astype(np.float32) * 0.01)
    return cfg, {"W": w, "b": b}, h


@pytest.mark.parametrize("R", [1, 17, 100])
def test_project_lse_rows_not_multiple_of_block(R):
    """Rows beyond R in the last row block are masked, and the wrapper
    returns exactly R rows."""
    cfg, head, h = _full_case(R, 64, 512, seed=R)
    lse = project_lse(h, head, cfg, compute_dtype=jnp.float32,
                      interpret=True, block_r=16, block_v=128)
    assert lse.shape == (R, 1)
    ref = project_lse_plain(h, head, cfg)
    np.testing.assert_allclose(np.asarray(lse), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("V", [100, 1000, 1023])
def test_project_lse_vocab_not_multiple_of_tile(V):
    cfg, head, h = _full_case(12, 64, V, seed=V)
    lse = project_lse(h, head, cfg, compute_dtype=jnp.float32,
                      interpret=True, block_v=128)
    ref = project_lse_plain(h, head, cfg)
    np.testing.assert_allclose(np.asarray(lse), np.asarray(ref), atol=1e-4)


def test_project_lse_width_not_power_of_two():
    """H=48 pads to a 64-wide tile; the padded columns load as zeros."""
    cfg, head, h = _full_case(10, 48, 300, seed=5)
    lse = project_lse(h, head, cfg, compute_dtype=jnp.float32,
                      interpret=True, block_v=64)
    ref = project_lse_plain(h, head, cfg)
    np.testing.assert_allclose(np.asarray(lse), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("mode", ["prefix", "disjoint"])
@pytest.mark.parametrize("quantized", [False, True])
def test_project_lse_dsoftmax_modes(mode, quantized):
    cfg, head, h, dense, bias = _dsoftmax_case(mode, quantized, 21)
    lse = project_lse(h, head, cfg, compute_dtype=jnp.float32,
                      interpret=True, block_v=64)
    logits = jnp.dot(h, dense, precision=jax.lax.Precision.HIGHEST) + bias
    ref = jax.nn.logsumexp(logits, axis=1, keepdims=True)
    np.testing.assert_allclose(np.asarray(lse), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(project_lse_plain(h, head, cfg)), np.asarray(ref),
        atol=1e-4)


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_project_ms_vocab_split_merge(splits):
    """P-way vocab split: the merged (m, s) of the parts equals one pass
    over the whole vocabulary, including a short last split."""
    cfg, head, h = _full_case(20, 64, 1000, seed=splits)
    m, s = project_ms(h, head, cfg, compute_dtype=jnp.float32,
                      interpret=True, block_v=64, splits=splits)
    m1, s1 = project_ms(h, head, cfg, compute_dtype=jnp.float32,
                        interpret=True, block_v=64, splits=1)
    np.testing.assert_allclose(np.asarray(m + jnp.log(s)),
                               np.asarray(m1 + jnp.log(s1)), atol=1e-5)
    ref = project_lse_plain(h, head, cfg)
    np.testing.assert_allclose(np.asarray(m + jnp.log(s)), np.asarray(ref),
                               atol=1e-4)


def test_merge_ms_matches_logsumexp():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(4, 30)).astype(np.float32) * 5)
    parts = jnp.split(x, 3, axis=1)
    m = jnp.stack([p.max(axis=1) for p in parts])
    s = jnp.stack([jnp.exp(p - p.max(axis=1, keepdims=True)).sum(axis=1)
                   for p in parts])
    mg, sg = merge_ms(m, s)
    np.testing.assert_allclose(np.asarray(mg + jnp.log(sg))[0],
                               np.asarray(jax.nn.logsumexp(x, axis=1)),
                               atol=1e-5)


def test_project_lse_bf16_against_fp32_reference():
    """bf16 operands with an fp32 accumulator: within 3e-2 of the fp32
    HIGHEST reference at H=512."""
    cfg, head, h = _full_case(24, 512, 2048, seed=3)
    lse = project_lse(h, head, cfg, compute_dtype=jnp.bfloat16,
                      interpret=True, block_v=256)
    ref = project_lse_plain(h, head, cfg)
    np.testing.assert_allclose(np.asarray(lse), np.asarray(ref), atol=3e-2)


def test_launch_params_shapes():
    """Tiles are powers of two >= 16, splits cover every vocab tile, and
    small batches split the vocabulary to fill the card."""
    for R, D, V in [(10, 512, 50_000), (640, 512, 50_000),
                    (20_480, 512, 50_000), (20_480, 128, 50_000), (3, 16, 40)]:
        lp = launch_params(R, D, V)
        for t in (lp.block_r, lp.block_v):
            assert t >= 16 and t & (t - 1) == 0
        n_tiles = -(-V // lp.block_v)
        per = -(-n_tiles // lp.splits)
        assert per * lp.splits >= n_tiles > per * (lp.splits - 1)
    assert launch_params(10, 512, 50_000).splits > 100
    assert launch_params(20_480, 512, 50_000, splits=1).splits == 1


# ---------------------------------------------------------------------------
# XLA pieces of the kernel forward
# ---------------------------------------------------------------------------

def test_xla_cell_bf16_matches_fp32_reference():
    """The decode cell in bf16 (fp32 accumulate and gates) stays within
    3e-2 of the fp32 ``lstm_step`` reference; fp32 mode matches it."""
    from jlm.models.lstm import cell, lstm_step

    rng = np.random.default_rng(7)
    R, E, H = 48, 64, 96
    cfg = Config(vocab_size=16, embed_size=E, hidden_size=H)
    x = jnp.asarray(rng.normal(size=(R, E)).astype(np.float32) * 0.3)
    h = jnp.asarray(rng.normal(size=(R, H)).astype(np.float32) * 0.3)
    c = jnp.asarray(rng.normal(size=(R, H)).astype(np.float32) * 0.3)
    W = jnp.asarray(rng.normal(size=(E + H, 4 * H)).astype(np.float32) * 0.1)
    b = jnp.asarray(rng.normal(size=(4 * H,)).astype(np.float32) * 0.01)
    params = {"lstm": [{"W": W, "b": b}]}
    _, (c_ref, h_ref) = lstm_step(params, cfg, x, (c[None], h[None]))
    for dtype, atol in ((jnp.float32, 1e-5), (jnp.bfloat16, 3e-2)):
        c2, h2 = cell(x, h, c, W, b, cfg.forget_bias, dtype)
        assert c2.dtype == dtype and h2.dtype == dtype
        np.testing.assert_allclose(np.asarray(c2, np.float32),
                                   np.asarray(c_ref[0]), atol=atol)
        np.testing.assert_allclose(np.asarray(h2, np.float32),
                                   np.asarray(h_ref[0]), atol=atol)


def test_candidate_dot_bf16_matches_fp32_reference():
    """Per-sentence candidate einsum: fp32 exact to 1e-4, bf16 operands
    within 0.15 at H=128 with 0.3-scale operands."""
    from jlm.decoder.engine import candidate_dot

    rng = np.random.default_rng(11)
    S, B, C1, H = 12, 10, 65, 128
    h3 = jnp.asarray(rng.normal(size=(S, B, H)).astype(np.float32) * 0.3)
    cols = jnp.asarray(rng.normal(size=(S, C1, H)).astype(np.float32) * 0.3)
    bias = jnp.asarray(rng.normal(size=(S, C1)).astype(np.float32) * 0.1)
    ref = np.einsum("sbh,sch->sbc", np.asarray(h3, np.float64),
                    np.asarray(cols, np.float64)) + np.asarray(bias)[:, None]
    out32 = candidate_dot(h3, cols, bias, jnp.float32)
    out16 = candidate_dot(h3, cols, bias, jnp.bfloat16)
    assert out16.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(out32), ref, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out16), ref, atol=0.15)


def test_topk_stable_exact_vs_lax():
    """topk_stable('argmax') == lax.top_k bit-for-bit, incl. tie order
    (ascending index within a tie group) and NEG-masked slots — the
    parity-frozen beam prune rule."""
    from jlm.decoder.engine import topk_stable

    rng = np.random.default_rng(0)
    # heavy ties: quantized values + NEG padding like real ext scores
    x = rng.integers(0, 6, (64, 640)).astype(np.float32)
    x[rng.random((64, 640)) < 0.3] = -1e30
    xj = jnp.asarray(x)
    for k in (1, 4, 10):
        v_a, i_a = jax.jit(lambda a, k=k: topk_stable(a, k, "argmax"))(xj)
        v_s, i_s = jax.lax.top_k(xj, k)
        np.testing.assert_array_equal(np.asarray(v_a), np.asarray(v_s))
        np.testing.assert_array_equal(np.asarray(i_a), np.asarray(i_s))
