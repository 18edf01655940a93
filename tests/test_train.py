"""Trainer behavior: loss decreases, state carry, lr decay, checkpoints.

(SURVEY.md §4.8 — the reference's training-loop contract.)
"""

import numpy as np
import jax

from jlm.config import Config
from jlm.models.params import param_spec
from jlm.train import Trainer, load_checkpoint, save_checkpoint, train_lm
from jlm.train.trainer import epoch_lr


def small_cfg(**kw):
    # vocab_size must match the session fixture's encoded corpus (256) —
    # out-of-range targets NaN-fill under jnp gather semantics.
    base = dict(
        vocab_size=256, embed_size=16, hidden_size=32, batch_size=4,
        num_steps=8, epochs=2, learning_rate=5e-3, seed=5,
    )
    base.update(kw)
    return Config(**base)


def test_ppl_decreases(encoded):
    train, dev, _ = encoded
    cfg = small_cfg()
    tr = Trainer(cfg)
    ppl0 = tr.evaluate_ppl(dev[:400])
    rng = jax.random.key(0)
    for e in range(2):
        tr.run_epoch(train[:2000], e, rng)
    ppl1 = tr.evaluate_ppl(dev[:400])
    assert ppl1 < ppl0 * 0.9, f"PPL did not improve: {ppl0} -> {ppl1}"
    assert ppl0 < cfg.vocab_size * 1.5  # sane init (~uniform)


def test_sampled_softmax_training_improves(encoded):
    train, dev, _ = encoded
    cfg = small_cfg(sampled_softmax_samples=32)
    tr = Trainer(cfg)
    ppl0 = tr.evaluate_ppl(dev[:400])
    rng = jax.random.key(1)
    for e in range(2):
        tr.run_epoch(train[:2000], e, rng)
    assert tr.evaluate_ppl(dev[:400]) < ppl0


def test_lr_decay_schedule():
    cfg = small_cfg(learning_rate=1.0, lr_decay=0.5, lr_decay_start_epoch=2)
    assert epoch_lr(cfg, 0) == 1.0
    assert epoch_lr(cfg, 2) == 1.0
    assert epoch_lr(cfg, 3) == 0.5
    assert epoch_lr(cfg, 4) == 0.25


def test_train_lm_and_checkpoint_roundtrip(encoded, tmp_path):
    train, dev, _ = encoded
    cfg = small_cfg(epochs=1)
    params, history = train_lm(cfg, train[:1000], dev[:200],
                               exp_dir=str(tmp_path), log=False)
    assert len(history) == 1 and history[0]["dev_ppl"] > 1
    loaded, loaded_cfg = load_checkpoint(str(tmp_path))
    assert loaded_cfg.vocab_size == cfg.vocab_size
    assert param_spec(jax.tree.map(np.asarray, params)) == param_spec(loaded)
    np.testing.assert_allclose(
        np.asarray(params["embedding"]), loaded["embedding"], atol=0
    )


def test_checkpoint_quantized_roundtrip(tiny_params, tiny_config, tmp_path):
    from jlm.ops.quant import quantize_params

    qp = quantize_params(tiny_params)
    save_checkpoint(str(tmp_path), qp, tiny_config, tag="q")
    loaded, _ = load_checkpoint(str(tmp_path), tag="q")
    assert loaded["embedding"]["q"].dtype == np.int8
    np.testing.assert_array_equal(loaded["embedding"]["q"], qp["embedding"]["q"])
    np.testing.assert_array_equal(loaded["head"]["W"]["scale"], qp["head"]["W"]["scale"])


def test_training_resume_continues(encoded, tmp_path):
    """Interrupt after epoch 0, resume, finish — equals state continuity."""
    train, dev, _ = encoded
    cfg = small_cfg(epochs=1)
    params1, h1 = train_lm(cfg, train[:1000], dev[:200],
                           exp_dir=str(tmp_path), log=False)
    # resume with a raised epoch budget: continues at epoch 1
    cfg2 = cfg.replace(epochs=3)
    params2, h2 = train_lm(cfg2, train[:1000], dev[:200],
                           exp_dir=str(tmp_path), log=False, resume=True)
    assert [r["epoch"] for r in h2] == [1, 2]
    # resumed run actually improves on the epoch-0 checkpoint
    assert h2[-1]["dev_ppl"] < h1[-1]["dev_ppl"]


def test_resume_restores_optimizer_moments(encoded, tmp_path):
    import jax
    import numpy as np

    train, dev, _ = encoded
    cfg = small_cfg(epochs=1)
    train_lm(cfg, train[:1000], dev[:200], exp_dir=str(tmp_path), log=False)
    tr = Trainer(cfg)
    nxt = tr.load_state(str(tmp_path))
    assert nxt == 1
    # adam moments are non-zero after an epoch of updates
    leaves = [np.asarray(x) for x in jax.tree.leaves(tr.opt_state)]
    assert any(np.abs(l).sum() > 0 for l in leaves if l.ndim > 0)


def test_grad_accum_equals_big_batch(encoded):
    """k accumulated microbatches == one step on the k-x batch (SGD).

    With equal-size microbatches and no clipping, optax.MultiSteps applies
    SGD to the mean of the k grads, which equals the grad of the mean loss
    over the concatenated batch (zero initial state, independent rows).
    """
    import jax.numpy as jnp
    from jlm.models.lstm import initial_state

    train, _, _ = encoded
    base = dict(optimizer="sgd", learning_rate=1e-2, max_grad_norm=1e9)
    rng = jax.random.key(0)
    x = np.asarray(train[: 8 * 8]).reshape(8, 8).astype(np.int32)
    y = np.roll(x, -1, axis=1)

    cfg_a = small_cfg(batch_size=4, grad_accum_steps=2, **base)
    tr_a = Trainer(cfg_a)
    st = initial_state(cfg_a, 4)
    lr = jnp.float32(1e-2)
    for mb in (slice(0, 4), slice(4, 8)):
        tr_a.params, tr_a.opt_state, _, _ = tr_a._train_step(
            tr_a.params, tr_a.opt_state, st, jnp.asarray(x[mb]),
            jnp.asarray(y[mb]), rng, lr,
        )

    cfg_b = small_cfg(batch_size=8, **base)
    tr_b = Trainer(cfg_b)
    stb = initial_state(cfg_b, 8)
    tr_b.params, *_ = tr_b._train_step(
        tr_b.params, tr_b.opt_state, stb, jnp.asarray(x), jnp.asarray(y),
        rng, lr,
    )
    for la, lb in zip(jax.tree.leaves(tr_a.params), jax.tree.leaves(tr_b.params)):
        np.testing.assert_allclose(np.asarray(la), np.asarray(lb), atol=1e-6)


def test_bf16_training_improves(encoded):
    """compute_dtype=bfloat16 (fp32 master params) still learns."""
    train, dev, _ = encoded
    cfg = small_cfg(compute_dtype="bfloat16")
    tr = Trainer(cfg)
    assert tr.params["embedding"].dtype == np.float32  # master stays fp32
    ppl0 = tr.evaluate_ppl(dev[:400])
    tr.run_epoch(train[:2000], 0, jax.random.key(0))
    assert tr.evaluate_ppl(dev[:400]) < ppl0


def test_remat_grads_exact(encoded):
    """remat=True recomputes instead of storing — grads must be EXACT."""
    import jax.numpy as jnp
    from jlm.models.lstm import forward_hidden, initial_state
    from jlm.models.heads import full_softmax_loss
    from jlm.models.params import init_params

    train, _, _ = encoded
    cfg = small_cfg()
    params = jax.tree.map(jnp.asarray, init_params(cfg))
    x = jnp.asarray(np.asarray(train[:32]).reshape(4, 8), jnp.int32)
    y = jnp.roll(x, -1, axis=1)
    st = initial_state(cfg, 4)

    def loss(p, remat):
        hs, _ = forward_hidden(p, cfg, x, st, remat=remat)
        return full_softmax_loss(p, cfg, hs, y)

    g0 = jax.grad(lambda p: loss(p, False))(params)
    g1 = jax.grad(lambda p: loss(p, True))(params)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_trainer_remat_improves(encoded):
    train, dev, _ = encoded
    cfg = small_cfg(remat=True)
    tr = Trainer(cfg)
    ppl0 = tr.evaluate_ppl(dev[:400])
    tr.run_epoch(train[:1500], 0, jax.random.key(0))
    assert tr.evaluate_ppl(dev[:400]) < ppl0


def test_lr_decay_gate(encoded, tmp_path):
    """PPL-gated decay: full lr until dev PPL clears the gate, then the
    epoch-indexed decay — robust to the seed-dependent plateau-escape
    epoch (round-5 quality-variance study)."""
    import json
    import os

    from jlm.config import Config
    from jlm.train.trainer import train_lm

    train, dev, _ = encoded
    cfg = Config(vocab_size=256, embed_size=16, hidden_size=32, batch_size=4,
                 num_steps=8, learning_rate=5e-3, lr_decay=0.5, epochs=6,
                 lr_decay_start_epoch=30, lr_decay_gate_ppl=1e9, seed=5)
    # gate=1e9 clears at epoch 0 => decay from epoch 1 (the epoch rule at
    # 30 is only the FALLBACK latest start when the gate is on)
    exp = str(tmp_path / "gate")
    _, hist = train_lm(cfg, train[:800], dev[:200], exp_dir=exp, log=False)
    # gate clears at epoch 0 -> decay_start = 1 -> epoch 1 is the decay
    # ORIGIN (k=0, full lr), epoch 2 the first decayed epoch
    assert hist[0]["lr"] == 5e-3
    assert hist[1]["lr"] == 5e-3
    assert abs(hist[2]["lr"] - 2.5e-3) < 1e-9
    assert "decay_start" in hist[0] or "decay_start" in hist[1]

    # a gate that never clears holds full lr until the FALLBACK epoch
    cfg2 = cfg.replace(lr_decay_gate_ppl=1e-9, lr_decay_start_epoch=4)
    _, hist2 = train_lm(cfg2, train[:800], dev[:200], log=False)
    assert all(r["lr"] == 5e-3 for r in hist2[:5])
    assert abs(hist2[5]["lr"] - 2.5e-3) < 1e-9

    # resume recovers the recorded gate epoch from the log
    cfg3 = cfg.replace(epochs=8)
    _, hist3 = train_lm(cfg3, train[:800], dev[:200], exp_dir=exp,
                        log=False, resume=True)
    # resumes at epoch 6 with recovered decay_start=1: lr = base * 0.5^5
    assert abs(hist3[0]["lr"] - 5e-3 * 0.5 ** 5) < 1e-12
