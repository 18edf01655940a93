"""Vocab-sharded head / top-k / loss vs unsharded references.

Runs on the virtual 8-device CPU mesh (SURVEY.md §6.4).  The load-bearing
property is EXACT equivalence with the unsharded path — including top-k tie
order — because beam parity depends on it (SURVEY.md §9.3.2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jlm.config import Config, DSoftmaxConfig
from jlm.decoder.engine import BeamDecoder, full_softmax_forward
from jlm.models import init_params
from jlm.models.heads import full_softmax_loss
from jlm.models.lstm import forward_hidden, initial_state
from jlm.oracle import OracleDecoder, OracleLM
from jlm.parallel import (
    make_mesh,
    make_sharded_forward,
    shard_params,
    sharded_topk,
    vocab_parallel_nll,
)


def cfg_mesh(**kw):
    base = dict(
        vocab_size=256, embed_size=32, hidden_size=64, beam_width=4,
        max_kana_len=30, mesh_data=2, mesh_vocab=4, seed=42,
    )
    base.update(kw)
    cfg = Config(**base)
    return cfg, make_mesh(cfg)


def test_mesh_axes():
    cfg, mesh = cfg_mesh()
    assert mesh.shape == {"data": 2, "vocab": 4}


@pytest.mark.parametrize("seq_shard", [True, False])
def test_sharded_forward_matches_unsharded(tiny_params, seq_shard):
    """Both exchange layouts: round-4 sequence-sharded rows (all_gather at
    the head boundary + psum_scatter candidates) and the round-3
    rows-replicated candidate psum."""
    cfg, mesh = cfg_mesh()
    params = shard_params(jax.tree.map(jnp.asarray, tiny_params), cfg, mesh)
    fwd = make_sharded_forward(mesh, cfg, seq_shard=seq_shard)
    S, B = (8, 2) if seq_shard else (2, 2)
    rng = np.random.default_rng(5)
    words = jnp.asarray(rng.integers(0, 256, (S, B)), jnp.int32)
    state = initial_state(cfg, S * B)
    cand = jnp.asarray(rng.integers(0, 256, (S, 4)), jnp.int32)
    cand = cand.at[0, :4].set(jnp.asarray([0, 5, 17, 255]))
    c_s, e_s, st_s = fwd(params, words, state, cand)
    c_r, e_r, st_r = full_softmax_forward(
        jax.tree.map(jnp.asarray, tiny_params), cfg, words, state, cand
    )
    np.testing.assert_allclose(c_s, c_r, atol=1e-5)
    np.testing.assert_allclose(e_s, e_r, atol=1e-5)
    np.testing.assert_allclose(st_s[0], st_r[0], atol=1e-6)


def test_sharded_dsoftmax_forward_matches_unsharded():
    cfg, mesh = cfg_mesh(
        head="dsoftmax",
        dsoftmax=DSoftmaxConfig(
            block_sizes=(64, 64, 128), block_dims=(64, 32, 16), mode="prefix"
        ),
    )
    params = jax.tree.map(jnp.asarray, init_params(cfg))
    sharded = shard_params(params, cfg, mesh)
    fwd = make_sharded_forward(mesh, cfg)
    S, B = 8, 1
    words = jnp.asarray([[1], [8], [3], [250], [7], [0], [12], [99]],
                        jnp.int32)
    state = initial_state(cfg, S * B)
    # candidates spanning all three blocks incl. boundaries
    cand = jnp.asarray([[0, 63, 64, 127, 128, 255],
                        [255, 128, 127, 64, 63, 0]] * 4, jnp.int32)
    c_s, e_s, _ = fwd(sharded, words, state, cand)

    from jlm.decoder.engine import full_softmax_forward as ref_fwd

    c_r, e_r, _ = ref_fwd(params, cfg, words, state, cand)
    np.testing.assert_allclose(c_s, c_r, atol=1e-5)
    np.testing.assert_allclose(e_s, e_r, atol=1e-5)


@pytest.mark.parametrize("seq_shard", [True, False])
@pytest.mark.parametrize("quant", [False, True])
def test_sharded_pallas_forward_matches_unsharded(tiny_params, seq_shard,
                                                  quant):
    """VERDICT r4 #1: the Pallas kernels compose with vocab sharding.

    The shard_map body runs the fused LSTM cell + cand_dot on the shard's
    own rows and project_ms (in-kernel int8 dequant) on its LOCAL head
    columns with a pmax/psum merge; outputs must match the UNSHARDED
    Pallas forward (same kernels, interpret mode) for both exchange
    layouts and both weight formats."""
    from jlm.decoder.engine import build_decode_head, make_pallas_forward
    from jlm.ops.quant import quantize_params

    cfg, mesh = cfg_mesh()
    base = quantize_params(tiny_params) if quant else tiny_params
    params = dict(jax.tree.map(jnp.asarray, base))
    params["_decode"] = build_decode_head(params, cfg)
    fwd_s = make_sharded_forward(mesh, cfg, use_pallas=True, interpret=True,
                                 seq_shard=seq_shard, int8_mxu=False)
    fwd_1 = make_pallas_forward(cfg, interpret=True, int8_mxu=False)
    params_s = fwd_s.place_params(params)

    S, B, C = 8, 2, 4
    rng = np.random.default_rng(5)
    words = jnp.asarray(rng.integers(0, 256, (S, B)), jnp.int32)
    state = initial_state(cfg, S * B)
    look = jnp.asarray(rng.integers(0, 256, (S, 1, C)), jnp.int32)
    pay_s = jax.tree.map(lambda a: a[:, 0], fwd_s.prepare(params_s, look))
    pay_1 = jax.tree.map(lambda a: a[:, 0], fwd_1.prepare(params, look))
    c_s, e_s, st_s = jax.jit(fwd_s)(params_s, words, state, pay_s)
    c_r, e_r, st_r = jax.jit(fwd_1)(params, words, state, pay_1)
    np.testing.assert_allclose(c_s, c_r, atol=1e-4)
    np.testing.assert_allclose(e_s, e_r, atol=1e-4)
    np.testing.assert_allclose(st_s[0], st_r[0], atol=1e-5)
    np.testing.assert_allclose(st_s[1], st_r[1], atol=1e-5)

    # score_hidden (multi-root decode_long seeding) through the same merge
    h3 = jnp.asarray(rng.normal(size=(S, B, cfg.hidden_size)), jnp.float32)
    sc_s = jax.jit(fwd_s.score_hidden)(params_s, h3, pay_s)
    sc_r = jax.jit(fwd_1.score_hidden)(params, h3, pay_1)
    np.testing.assert_allclose(sc_s, sc_r, atol=1e-4)


@pytest.mark.parametrize("int8_mxu", [False, True])
def test_sharded_pallas_dsoftmax_int8(int8_mxu):
    """D-softmax + int8 head under vocab sharding: per-block local columns
    through the projection kernel (int8 x int8 variant included),
    merged lse must match the unsharded kernel D-softmax path."""
    from jlm.decoder.engine import build_decode_head, make_pallas_forward
    from jlm.ops.quant import quantize_params

    cfg, mesh = cfg_mesh(
        head="dsoftmax",
        dsoftmax=DSoftmaxConfig(
            block_sizes=(64, 64, 128), block_dims=(64, 32, 16), mode="prefix"
        ),
    )
    params = dict(jax.tree.map(jnp.asarray, quantize_params(init_params(cfg))))
    params["_decode"] = build_decode_head(params, cfg)
    fwd_s = make_sharded_forward(mesh, cfg, use_pallas=True, interpret=True,
                                 int8_mxu=int8_mxu)
    fwd_1 = make_pallas_forward(cfg, interpret=True, int8_mxu=int8_mxu)
    params_s = fwd_s.place_params(params)

    S, B, C = 8, 2, 6
    rng = np.random.default_rng(7)
    words = jnp.asarray(rng.integers(0, 256, (S, B)), jnp.int32)
    state = initial_state(cfg, S * B)
    look = jnp.asarray([[[0, 63, 64, 127, 128, 255]]] * S, jnp.int32)
    pay_s = jax.tree.map(lambda a: a[:, 0], fwd_s.prepare(params_s, look))
    pay_1 = jax.tree.map(lambda a: a[:, 0], fwd_1.prepare(params, look))
    c_s, e_s, _ = jax.jit(fwd_s)(params_s, words, state, pay_s)
    c_r, e_r, _ = jax.jit(fwd_1)(params, words, state, pay_1)
    # int8 x int8 re-quantizes activations per row; identical inputs on
    # both paths, so only the column-split changes fp32 sum order.
    np.testing.assert_allclose(c_s, c_r, atol=1e-4)
    np.testing.assert_allclose(e_s, e_r, atol=1e-4)


def test_sharded_pallas_decode_top1_parity(tiny_params, lexicon, vocab):
    """End-to-end: BeamDecoder over the Pallas vocab-sharded forward ==
    numpy oracle (config 3 with the real kernels in the shard_map body)."""
    cfg, mesh = cfg_mesh()
    params = jax.tree.map(jnp.asarray, tiny_params)
    sharded = shard_params(params, cfg, mesh)
    fwd = make_sharded_forward(mesh, cfg, use_pallas=True, interpret=True)
    eng = BeamDecoder(sharded, lexicon, vocab, cfg, forward_fn=fwd)
    orc = OracleDecoder(OracleLM(tiny_params, cfg), lexicon, vocab, cfg)
    kanas = ["きょうはいいてんき", "あめがふる", "かみとかわ", "はしをみる"]
    res = eng.decode_batch(kanas, n_best=1)
    for kana, r in zip(kanas, res):
        r_o = orc.decode(kana)[0]
        assert r[0].segments == r_o.segments, kana
        assert abs(r[0].score - r_o.score) < 1e-3


def test_sharded_pallas_decode_long(tiny_params, lexicon, vocab):
    """Multi-root decode_long under the Pallas sharded forward: the
    score_hidden hook routes seed scoring through the same pmax/psum head
    merge — path AND score exact vs the uncapped oracle."""
    cfg, mesh = cfg_mesh()
    cfg = cfg.replace(max_kana_len=8)
    params = jax.tree.map(jnp.asarray, tiny_params)
    sharded = shard_params(params, cfg, mesh)
    fwd = make_sharded_forward(mesh, cfg, use_pallas=True, interpret=True)
    eng = BeamDecoder(sharded, lexicon, vocab, cfg, forward_fn=fwd)
    orc = OracleDecoder(
        OracleLM(tiny_params, cfg), lexicon, vocab,
        cfg.replace(max_kana_len=64),
    )
    kana = "きょうはいいてんきあめがふるよ"
    r_s = eng.decode(kana, n_best=1)[0]
    r_o = orc.decode(kana, n_best=1)[0]
    assert r_s.segments == r_o.segments
    assert abs(r_s.score - r_o.score) < 1e-3


def test_sharded_topk_exact_with_ties():
    cfg, mesh = cfg_mesh()
    rng = np.random.default_rng(0)
    # quantize values so cross-shard ties are guaranteed
    logits = rng.integers(0, 8, (3, 256)).astype(np.float32)
    lj = jnp.asarray(logits)
    vals_s, idx_s = sharded_topk(mesh, lj, k=10)
    vals_r, idx_r = jax.lax.top_k(lj, 10)
    np.testing.assert_array_equal(np.asarray(vals_s), np.asarray(vals_r))
    np.testing.assert_array_equal(np.asarray(idx_s), np.asarray(idx_r))


def test_vocab_parallel_nll_and_grads(tiny_params):
    cfg, mesh = cfg_mesh()
    params = jax.tree.map(jnp.asarray, tiny_params)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, (4, 6)).astype(np.int32)
    tgt = rng.integers(0, 256, (4, 6)).astype(np.int32)
    hs, _ = forward_hidden(params, cfg, jnp.asarray(ids), initial_state(cfg, 4),
                           precision="highest")
    loss_fn = vocab_parallel_nll(mesh, cfg, precision="highest")

    sharded = shard_params(params, cfg, mesh)
    l_s = loss_fn(sharded, hs, jnp.asarray(tgt))
    l_r = full_softmax_loss(params, cfg, hs, jnp.asarray(tgt), precision="highest")
    np.testing.assert_allclose(float(l_s), float(l_r), atol=1e-5)

    g_s = jax.grad(lambda p: loss_fn(p, hs, jnp.asarray(tgt)))(sharded)
    g_r = jax.grad(
        lambda p: full_softmax_loss(p, cfg, hs, jnp.asarray(tgt), precision="highest")
    )(params)
    np.testing.assert_allclose(
        np.asarray(g_s["head"]["W"]), np.asarray(g_r["head"]["W"]), atol=1e-5
    )


def test_sharded_decode_top1_parity(tiny_params, lexicon, vocab):
    """BASELINE config 3 skeleton: vocab-sharded beam decode == oracle.

    S must divide mesh_data; decode two sentences per batch on (2, 4)."""
    cfg, mesh = cfg_mesh()
    params = jax.tree.map(jnp.asarray, tiny_params)
    sharded = shard_params(params, cfg, mesh)
    fwd = make_sharded_forward(mesh, cfg)
    eng = BeamDecoder(sharded, lexicon, vocab, cfg, forward_fn=fwd)
    orc = OracleDecoder(OracleLM(tiny_params, cfg), lexicon, vocab, cfg)
    kanas = ["きょうはいいてんき", "あめがふる", "かみとかわ", "はしをみる"]
    res = eng.decode_batch(kanas, n_best=1)
    for kana, r in zip(kanas, res):
        r_o = orc.decode(kana)[0]
        assert r[0].segments == r_o.segments, kana
        assert abs(r[0].score - r_o.score) < 1e-3


def test_sharded_trainer_matches_single(encoded, tmp_path):
    """Trainer(mesh) == Trainer() step-for-step, and resumes sharded.

    The mesh-backed step (vocab-parallel CE, data-sharded rows) must produce
    the same params as the single-device step — grad sync is exact, not
    approximate (SURVEY.md §3.3)."""
    from jlm.train import Trainer

    train, dev, _ = encoded
    kw = dict(vocab_size=256, embed_size=16, hidden_size=32, batch_size=4,
              num_steps=8, learning_rate=5e-3, seed=5)
    cfg_s = Config(mesh_data=2, mesh_vocab=4, **kw)
    mesh = make_mesh(cfg_s)
    tr_m = Trainer(cfg_s, mesh=mesh)
    tr_1 = Trainer(Config(**kw))

    rng = jax.random.key(0)
    tr_m.run_epoch(train[:1600], 0, rng)
    tr_1.run_epoch(train[:1600], 0, rng)
    for lm, l1 in zip(jax.tree.leaves(tr_m.params), jax.tree.leaves(tr_1.params)):
        np.testing.assert_allclose(
            np.asarray(lm), np.asarray(l1), atol=2e-4,
        )
    p_m = tr_m.evaluate_ppl(dev[:400])
    p_1 = tr_1.evaluate_ppl(dev[:400])
    assert abs(p_m - p_1) / p_1 < 1e-3

    # sharded save → sharded resume round-trips (incl. optimizer moments)
    tr_m.save_state(str(tmp_path), epoch=0)
    tr_r = Trainer(cfg_s, mesh=mesh)
    assert tr_r.load_state(str(tmp_path)) == 1
    for la, lb in zip(jax.tree.leaves(tr_m.params), jax.tree.leaves(tr_r.params)):
        np.testing.assert_allclose(np.asarray(la), np.asarray(lb), atol=0)
    assert abs(tr_r.evaluate_ppl(dev[:400]) - p_m) < 1e-6


def test_sharded_trainer_bf16_and_accum_smoke(encoded):
    """Sharded step with bf16 compute + grad accumulation still learns."""
    from jlm.train import Trainer

    train, dev, _ = encoded
    cfg = Config(vocab_size=256, embed_size=16, hidden_size=32, batch_size=4,
                 num_steps=8, learning_rate=5e-3, seed=5, mesh_data=2,
                 mesh_vocab=4, compute_dtype="bfloat16", grad_accum_steps=2)
    mesh = make_mesh(cfg)
    tr = Trainer(cfg, mesh=mesh)
    ppl0 = tr.evaluate_ppl(dev[:400])
    tr.run_epoch(train[:2000], 0, jax.random.key(1))
    assert tr.evaluate_ppl(dev[:400]) < ppl0


def test_seq_pipeline_matches_sequential():
    """Time-block pipeline over a 'seq' mesh == per-microbatch scan.

    The ppermute carry hand-off (overlap-save halo across chips,
    SURVEY.md §7) must be value-exact."""
    import jax
    import numpy as np
    from jlm.parallel.seq_pipeline import (
        make_seq_pipeline_scan,
        seq_pipeline_ref,
    )

    P_ = 4
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:P_]), ("seq",))
    M, B, T, E, H, L = 8, 2, 16, 16, 16, 2
    rng = np.random.default_rng(11)
    xs = jnp.asarray(rng.normal(size=(M, B, T, E)).astype(np.float32) * 0.2)
    layers = tuple(
        (jnp.asarray(rng.normal(size=((E if l == 0 else H) + H, 4 * H))
                     .astype(np.float32) * 0.1),
         jnp.zeros((4 * H,), jnp.float32))
        for l in range(L)
    )
    c0 = jnp.asarray(rng.normal(size=(M, L, B, H)).astype(np.float32) * 0.1)
    h0 = jnp.asarray(rng.normal(size=(M, L, B, H)).astype(np.float32) * 0.1)

    fn = make_seq_pipeline_scan(mesh, num_layers=L)
    hs, c_f, h_f = fn(xs, layers, c0, h0)
    hs_r, c_r, h_r = seq_pipeline_ref(xs, layers, c0, h0)
    np.testing.assert_allclose(np.asarray(hs), np.asarray(hs_r), atol=1e-5)
    np.testing.assert_allclose(np.asarray(c_f), np.asarray(c_r), atol=1e-5)
    np.testing.assert_allclose(np.asarray(h_f), np.asarray(h_r), atol=1e-5)


def test_seq_pipeline_trainer_matches_single(encoded):
    """Trainer on a ('seq',) mesh == single-device Trainer step-for-step.

    The pipeline-parallel step (time blocks over 4 stages, ppermute carry
    hand-off) is mathematically the same program as the plain scan; params
    after an epoch and dev PPL must agree to fp32 collective tolerance
    (VERDICT r1 item 4: --mesh-seq wiring).
    """
    from jlm.parallel.mesh import make_seq_mesh
    from jlm.train import Trainer

    train, dev, _ = encoded
    kw = dict(vocab_size=256, embed_size=16, hidden_size=32, batch_size=8,
              num_steps=16, learning_rate=5e-3, seed=5)
    cfg_s = Config(mesh_seq=4, seq_microbatches=8, **kw)
    mesh = make_seq_mesh(cfg_s)
    assert mesh.shape == {"seq": 4}
    tr_s = Trainer(cfg_s, mesh=mesh)
    tr_1 = Trainer(Config(**kw))

    rng = jax.random.key(0)
    tr_s.run_epoch(train[:3200], 0, rng)
    tr_1.run_epoch(train[:3200], 0, rng)
    for ls, l1 in zip(jax.tree.leaves(tr_s.params), jax.tree.leaves(tr_1.params)):
        np.testing.assert_allclose(np.asarray(ls), np.asarray(l1), atol=2e-4)
    p_s = tr_s.evaluate_ppl(dev[:400])
    p_1 = tr_1.evaluate_ppl(dev[:400])
    assert abs(p_s - p_1) / p_1 < 1e-3


def test_sharded_decode_long_exact_scores(tiny_params, lexicon, vocab):
    """decode_long composes with the vocab-sharded forward: since round 4
    the sharded forward carries a score_hidden hook, so long inputs take
    the MULTI-ROOT overlap-save path under sharding too — path AND score
    must match the single-device multi-root decode and the uncapped
    oracle."""
    from jlm.oracle import OracleDecoder, OracleLM

    cfg, mesh = cfg_mesh()
    cfg = cfg.replace(max_kana_len=8)
    params = jax.tree.map(jnp.asarray, tiny_params)
    sharded = shard_params(params, cfg, mesh)
    fwd = make_sharded_forward(mesh, cfg)
    eng_s = BeamDecoder(sharded, lexicon, vocab, cfg, forward_fn=fwd)
    eng_1 = BeamDecoder(tiny_params, lexicon, vocab, cfg,
                        precision="highest")
    orc = OracleDecoder(
        OracleLM(tiny_params, cfg), lexicon, vocab,
        cfg.replace(max_kana_len=64),
    )
    kana = "きょうはいいてんきあめがふるよ"  # 15 kana, multi-chunk
    r_s = eng_s.decode(kana, n_best=1)[0]
    r_1 = eng_1.decode(kana, n_best=1)[0]
    r_o = orc.decode(kana, n_best=1)[0]
    assert r_s.segments == r_1.segments == r_o.segments
    assert abs(r_s.score - r_o.score) < 1e-3


def test_comms_model_consistency():
    """The byte accounting must track make_sharded_forward's actual
    collective shapes in both exchange layouts."""
    from jlm.config import Config
    from jlm.parallel.comms_model import decode_collective_bytes_per_frame

    cfg = Config(vocab_size=50_000)
    S, n = 512, 4
    c = decode_collective_bytes_per_frame(cfg, S, n)
    R = S * cfg.beam_pad
    C1 = cfg.max_lookahead + 1
    assert c["payload_bytes_pmax"] == R * 4
    assert c["payload_bytes_psum_cand"] == S * cfg.beam_pad * C1 * 4
    assert c["wire_bytes_per_device_per_frame"] == (
        2 * (n - 1) / n * c["payload_bytes_total"]
    )
    # sequence-sharded layout: all_gather of bf16 h_top + half-ring
    # candidate reduce-scatter
    c_seq = decode_collective_bytes_per_frame(cfg, S, 4, seq_shard=True,
                                              htop_bytes=2)
    assert c_seq["payload_bytes_allgather_htop"] == (
        S * cfg.beam_pad * cfg.hidden_size * 2
    )
    assert c_seq["wire_bytes_per_device_per_frame"] == (
        (n - 1) / n * (c_seq["payload_bytes_allgather_htop"]
                       + c_seq["payload_bytes_psum_cand"])
        + 2 * (n - 1) / n * (R * 4 * 2)
    )
    # one card moves nothing
    assert decode_collective_bytes_per_frame(
        cfg, S, 1)["wire_bytes_per_device_per_frame"] == 0

def test_sampled_softmax_data_parallel(tiny_config, encoded):
    """Sampled softmax now trains on a data-only mesh (VERDICT r2 weak #7):
    one epoch runs, loss finite, and a vocab-sharded mesh still refuses at
    construction time."""
    import jax
    import numpy as np
    import pytest as _pytest

    from jlm.parallel.mesh import make_mesh
    from jlm.train import Trainer

    cfg = tiny_config.replace(
        sampled_softmax_samples=32, mesh_data=4, mesh_vocab=1, batch_size=4
    )
    tr = Trainer(cfg, mesh=make_mesh(cfg))
    ppl = tr.run_epoch(encoded[0][:600], 0, jax.random.key(0))
    assert np.isfinite(ppl) and ppl > 1.0

    bad = tiny_config.replace(
        sampled_softmax_samples=32, mesh_data=2, mesh_vocab=4
    )
    with _pytest.raises(ValueError, match="vocab"):
        Trainer(bad, mesh=make_mesh(bad))
