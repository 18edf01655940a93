#!/usr/bin/env python
"""Smoke test of the conversion engine on one NVIDIA GPU.

Drives the main paths once, through the entry points a user calls, at the
full widths of BASELINE configs 2 and 5 with random weights from a seed:

1. device: refuses to run without a GPU; prints the card and its limit;
2. kernel: the head normaliser kernel (``jlm.ops.project``) compiled at
   real widths, checked against the plain fp32 reference, and timed in
   turns against the plain XLA version;
3. batch conversion: ``BeamDecoder.decode_batch`` / ``decode_stream`` on
   the bench's 2048-lattice stream with oracle parity, then one batch at
   the config-5 shape (2 layers, 100k D-softmax);
4. keystrokes: ``IncrementalDecoder`` and ``SessionServer`` against
   ``decode_batch`` on the same kana;
5. training: a few ``Trainer`` steps at the config-5 shape in bf16.

``--four`` runs only the four-card paths (a vocab-sharded decode and a
sharded train step) and what they are compared with.

Any failed phase raises, so the script exits non-zero without printing
the final ``{"ok": true, ...}`` line.  Run from the repository root:
``python chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances (absolute, in nats), each with its reason:
# - kernel lse vs the fp32 HIGHEST reference: 3e-2 for bf16 operands
#   (8-bit mantissa over K=512; int8 weights are exact in bf16, so the
#   dequant mode has the same bound); int8 x int8: 0.05, the
#   activation-quantization bound pinned by
#   tests/test_kernels.py::test_int8_mxu_score_error_bound.
LSE_TOL = {"bf16": 3e-2, "int8": 3e-2, "int8_mxu": 0.05, "dsoftmax": 3e-2}
# - speed mode vs another precision (keystroke paths run their LSTM in
#   TF32, the batch engine in bf16; fp32 engines at HIGHEST): top-1 scores
#   agree within 0.1 (test_engine_parity's bf16 bound), and a path may
#   differ only where two paths are that close.
SPEED_SCORE_TOL = 0.1
# - parity mode (fp32 HIGHEST everywhere): exact path identity, scores to
#   1e-3 (the CPU tests' bound).
PARITY_SCORE_TOL = 1e-3


def log(*a):
    print(*a, flush=True)


def card_info() -> str:
    """``nvidia-smi`` name and power limit, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def timed(name):
    def deco(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            log(f"== phase {name}")
            out = fn(*a, **kw)
            log(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)")
            return out
        return run
    return deco


def median_ms(f, *args, n=5):
    import jax
    import numpy as np

    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts)) * 1e3


def config5(vocab=100_000, hidden=512, **kw):
    """BASELINE config 5 on one card: 2 layers, D-softmax head."""
    from jlm.config import Config, default_dsoftmax_blocks

    return Config(vocab_size=vocab, num_layers=2, hidden_size=hidden,
                  head="dsoftmax",
                  dsoftmax=default_dsoftmax_blocks(
                      vocab, hidden, multiple=kw.pop("multiple", 1)),
                  beam_width=10, n_best_max=1, **kw)


def plain_head_forward(config):
    """The kernel forward with its normaliser swapped for the plain XLA
    version (fp32 logits in device memory, then a logsumexp): what the
    kernel is compared with end to end."""
    import jax.numpy as jnp

    from jlm.decoder.engine import make_pallas_forward
    from jlm.ops import project

    kernel = project.project_lse
    project.project_lse = (
        lambda h, head, cfg, compute_dtype, **_:
        project.project_lse_plain(h, head, cfg, compute_dtype))
    try:
        return make_pallas_forward(config, compute_dtype=jnp.bfloat16)
    finally:
        project.project_lse = kernel


def bench_setup(vocab_size=50_000, hidden=512, embed=256, corpus=2000,
                n_stream=2048):
    """bench.py's model, lexicon and 2048-lattice stream (config 2)."""
    from jlm.config import Config
    from jlm.data import (Lexicon, build_vocab, generate_corpus,
                          generate_test_set)
    from jlm.models.params import init_params

    config = Config(vocab_size=vocab_size, embed_size=embed,
                    hidden_size=hidden, num_layers=1, beam_width=10,
                    n_best_max=1, seed=0)
    vocab = build_vocab(generate_corpus(corpus, seed=1234), vocab_size)
    lexicon = Lexicon.from_vocab(vocab)
    params = init_params(config)
    kanas = [k for k, _ in generate_test_set(50, seed=777)]
    stream = (kanas * ((n_stream + 49) // 50))[:n_stream]
    return config, vocab, lexicon, params, kanas, stream


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------

@timed("kernel")
def phase_kernel(R=2048 * 10, H=512, V=50_000, cfg5=None):
    """Rows R = 2048 lattices x beam_pad 10, the bench chunk."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from jlm.config import Config
    from jlm.ops.project import (launch_params, project_flops, project_lse,
                                 project_lse_plain)
    from jlm.ops.quant import quantize_weight

    cfg5 = cfg5 or config5(hidden=H)
    k = jax.random.split(jax.random.key(0), 3)
    h = jnp.tanh(jax.random.normal(k[0], (R, H), jnp.float32))
    hb = h.astype(jnp.bfloat16)
    w = jax.random.normal(k[1], (H, V), jnp.float32) * 0.05
    b = jax.random.normal(k[2], (V,), jnp.float32) * 0.01
    cfg = Config(vocab_size=V, hidden_size=H)
    q = quantize_weight(np.asarray(w), axis=0)
    head_q = {"W": {"q": jnp.asarray(q["q"]), "scale": jnp.asarray(q["scale"])},
              "b": b}
    blocks = []
    for i, (s, d) in enumerate(zip(cfg5.dsoftmax.block_sizes,
                                   cfg5.dsoftmax.block_dims)):
        kk = jax.random.split(jax.random.key(10 + i), 2)
        blocks.append({"W": jax.random.normal(kk[0], (d, s)) * 0.05,
                       "b": jax.random.normal(kk[1], (s,)) * 0.01})
    head5b = {"blocks": [{"W": x["W"].astype(jnp.bfloat16), "b": x["b"]}
                         for x in blocks]}
    # (name, config, head, fp32 reference head, kernel options)
    cases = [
        ("bf16", cfg, {"W": w.astype(jnp.bfloat16), "b": b}, {"W": w, "b": b},
         {}),
        ("int8", cfg, head_q, head_q, {"int8_mxu": False}),
        ("int8_mxu", cfg, head_q, head_q, {"int8_mxu": True}),
        ("dsoftmax", cfg5, head5b, {"blocks": blocks}, {}),
    ]
    kernels = {}
    for name, c, head, head_ref, kw in cases:
        f = jax.jit(lambda h, hd, c=c, kw=kw: project_lse(h, hd, c, **kw))
        compiled = f.lower(hb, head).compile()
        out = compiled(hb, head)
        ref = jax.jit(lambda h, hd, c=c: project_lse_plain(h, hd, c))(
            h, head_ref)
        err = float(jnp.max(jnp.abs(out - ref)))
        finite = bool(jnp.all(jnp.isfinite(out)))
        first_v = c.dsoftmax.block_sizes[0] if c.dsoftmax else V
        lp = launch_params(R, H, first_v,
                           h_bytes=1 if name == "int8_mxu" else 2,
                           w_bytes=1 if name.startswith("int8") else 2)
        log(f"kernel {name}: rows={R} max|lse-ref|={err:.3g} "
            f"(tol {LSE_TOL[name]}) finite={finite} launch={lp}")
        log(f"kernel {name} memory_analysis: {compiled.memory_analysis()}")
        assert finite and out.shape == (R, 1), name
        assert err <= LSE_TOL[name], f"kernel {name}: error {err}"
        kernels[name] = (compiled, head, c)

    # Kernel against the plain XLA version (bf16 operands, fp32 logits in
    # device memory, then a logsumexp), in turns: K P P K K P
    for name in ("bf16", "int8_mxu", "dsoftmax"):
        compiled, head, c = kernels[name]
        plain = jax.jit(lambda h, hd, c=c: project_lse_plain(
            h, hd, c, jnp.bfloat16)).lower(hb, head).compile()
        tk, tp = [], []
        for i in range(3):
            order = [(compiled, tk), (plain, tp)]
            for fn, acc in (order if i % 2 == 0 else order[::-1]):
                acc.append(median_ms(fn, hb, head))
        tk_ms, tp_ms = float(np.median(tk)), float(np.median(tp))
        tflops = project_flops(R, head, c) / (tk_ms * 1e-3) / 1e12
        log(f"timing {name}: kernel {tk_ms:.3f} ms, plain XLA {tp_ms:.3f} ms "
            f"(median of 3 medians of 5, in turns; kernel {tflops:.0f} "
            "TFLOP/s)")


@timed("batch")
def phase_batch(setup, cfg5=None, n5=512):
    import numpy as np

    from jlm import native
    from jlm.decoder.engine import BeamDecoder
    from jlm.models.params import init_params
    from jlm.ops.quant import quantize_params
    from jlm.oracle import OracleDecoder, OracleLM

    config, vocab, lexicon, params, kanas, stream = setup
    S = len(stream)
    log(f"native lattice builder used: {native.available()}")
    qp = quantize_params(params)
    engine = BeamDecoder(qp, lexicon, vocab, config, precision="default")
    log(f"speed forward: {engine._fwd.__qualname__}")
    assert engine._fwd.__qualname__.startswith("make_pallas_forward"), (
        "speed mode on the GPU must take the kernel head")
    t0 = time.perf_counter()
    res = engine.decode_batch(stream, n_best=1)
    log(f"decode_batch {S} lattices, compile+run: "
        f"{time.perf_counter() - t0:.1f} s")
    assert len(res) == S and all(r for r in res)
    t0 = time.perf_counter()
    res = engine.decode_stream(stream * 2, chunk_size=S, n_best=1)
    dt = time.perf_counter() - t0
    chars = 2 * sum(len(k) for k in stream)
    log(f"decode_stream 2x{S} lattices: {dt:.2f} s ({chars / dt:.0f} "
        "chars/s, includes compiles of new frame counts)")
    assert all(np.isfinite(r[0].score) for r in res)

    # End to end: the same engine with its normaliser swapped for the
    # plain XLA version, on the bench chunk, in turns K P P K K P.
    plain = BeamDecoder(qp, lexicon, vocab, config,
                        forward_fn=plain_head_forward(config))
    plain.decode_stream(stream, chunk_size=S)  # compile
    times = {"kernel": [], "plain": []}
    for i in range(6):
        name = ("kernel", "plain")[(i + i // 2) % 2]
        eng = engine if name == "kernel" else plain
        t0 = time.perf_counter()
        eng.decode_stream(stream, chunk_size=S)
        times[name].append(time.perf_counter() - t0)
    chars = sum(len(k) for k in stream)
    for name, ts in times.items():
        log(f"end to end, {S}-lattice chunk, {name} normaliser: median "
            f"{1e3 * float(np.median(ts)):.1f} ms ({chars / float(np.median(ts)):.0f} "
            f"chars/s; runs {[round(1e3 * t, 1) for t in ts]})")

    greedy_cfg = config.replace(beam_width=1)
    oracle = OracleDecoder(OracleLM(params, greedy_cfg), lexicon, vocab,
                           greedy_cfg)
    greedy = BeamDecoder(params, lexicon, vocab, greedy_cfg,
                         precision="highest")
    g_res = greedy.decode_batch(kanas, n_best=1)
    exact = sum(r[0].segments == oracle.decode(k)[0].segments
                for r, k in zip(g_res, kanas))
    log(f"greedy parity {exact}/{len(kanas)} "
        "(top-1 path identity, fp32 HIGHEST engine vs numpy oracle)")
    assert exact == len(kanas), "greedy path-identity parity failed"

    orc_q = OracleDecoder(OracleLM(qp, config), lexicon, vocab, config)
    par_int8 = sum(r[0].segments == orc_q.decode(k)[0].segments
                   for r, k in zip(res[:len(kanas)], kanas))
    log(f"beam-10 parity {par_int8}/{len(kanas)} (path identity, int8 "
        "x int8 kernel head vs int8-dequant oracle)")
    assert par_int8 >= 0.9 * len(kanas), "int8 beam-10 parity collapsed"

    cfg5 = (cfg5 or config5()).replace(seed=1)
    p5 = init_params(cfg5)
    r5 = BeamDecoder(p5, lexicon, vocab, cfg5, precision="default"
                     ).decode_batch(stream[:n5], n_best=1)
    r5f = BeamDecoder(p5, lexicon, vocab, cfg5, precision="highest"
                      ).decode_batch(kanas, n_best=1)
    agree = sum(a[0].segments == b[0].segments for a, b in zip(r5, r5f))
    gap = max(abs(a[0].score - b[0].score) for a, b in zip(r5, r5f))
    log(f"config-5 batch (2-layer, {cfg5.vocab_size} D-softmax): {len(r5)} "
        f"lattices; bf16 kernel vs fp32 top-1 paths "
        f"{agree}/{min(len(r5), len(r5f))}, "
        f"max score gap {gap:.3g} (tol {SPEED_SCORE_TOL})")
    assert all(np.isfinite(r[0].score) for r in r5)
    assert gap <= SPEED_SCORE_TOL, "config-5 kernel engine drifted"


@timed("keystroke")
def phase_keystroke(setup):
    from jlm.decoder.engine import BeamDecoder
    from jlm.decoder.incremental import IncrementalDecoder
    from jlm.decoder.server import SessionServer
    from jlm.ops.quant import quantize_params

    config, vocab, lexicon, params, kanas, _ = setup
    qp = quantize_params(params)
    texts = kanas[:4]
    for precision, tol in (("highest", PARITY_SCORE_TOL),
                           ("default", SPEED_SCORE_TOL)):
        batch = BeamDecoder(qp, lexicon, vocab, config, precision=precision)
        ref = {t: batch.decode_batch([t])[0][0] for t in texts}
        inc = IncrementalDecoder(qp, lexicon, vocab, config,
                                 precision=precision)
        paths, gap = 0, 0.0
        for t in texts:
            inc.reset()
            for ch in t[:-1]:
                inc.push(ch)
            inc.push("あ")
            inc.pop()  # backspace, then the real last kana
            top = inc.push(t[-1])[0]
            paths += top.segments == ref[t].segments
            gap = max(gap, abs(top.score - ref[t].score))
        srv = SessionServer(qp, lexicon, vocab, config, max_sessions=8,
                            precision=precision)
        sids = [srv.open() for _ in texts]
        for i in range(max(len(t) for t in texts)):
            srv.push([(s, t[i]) for s, t in zip(sids, texts) if i < len(t)])
        s_paths, s_gap = 0, 0.0
        for s, t in zip(sids, texts):
            top = srv.results(s)[0]
            s_paths += top.segments == ref[t].segments
            s_gap = max(s_gap, abs(top.score - ref[t].score))
        log(f"keystrokes ({precision}) vs decode_batch: incremental top-1 "
            f"paths {paths}/{len(texts)} (max score gap {gap:.3g}), server "
            f"{s_paths}/{len(texts)} (gap {s_gap:.3g}); tol {tol}")
        assert gap <= tol and s_gap <= tol, "keystroke scores drifted"
        if precision == "highest":
            assert paths == s_paths == len(texts), "keystroke parity failed"


@timed("train")
def phase_train(cfg5=None, batch=32, steps=4):
    import jax
    import numpy as np

    from jlm.train.trainer import Trainer

    cfg = (cfg5 or config5()).replace(batch_size=batch, num_steps=32,
                                      compute_dtype="bfloat16", seed=2)
    tr = Trainer(cfg)
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, batch * 32 * steps + 1).astype(np.int32)
    t0 = time.perf_counter()
    ppl = tr.run_epoch(ids, 0, jax.random.key(0))
    log(f"train: {steps} steps of {batch}x32 tokens, 2 layers, "
        f"{cfg.vocab_size} D-softmax, bf16: ppl {ppl:.1f} "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")
    assert np.isfinite(ppl), "training loss not finite"


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

@timed("four_decode")
def phase_four_decode(setup, vocab_size=50_000, hidden=512, n=512):
    """Config-3 D-softmax decode on a (data=1, vocab=4) mesh vs one card."""
    import numpy as np

    from jlm.config import Config, default_dsoftmax_blocks
    from jlm.decoder.engine import BeamDecoder
    from jlm.models.params import init_params
    from jlm.parallel.mesh import make_mesh
    from jlm.parallel.sharded_head import make_sharded_forward, shard_params

    _, vocab, lexicon, _, _, stream = setup
    cfg = Config(vocab_size=vocab_size, hidden_size=hidden, beam_width=10,
                 head="dsoftmax",
                 dsoftmax=default_dsoftmax_blocks(vocab_size, hidden,
                                                  multiple=4),
                 mesh_data=1, mesh_vocab=4, n_best_max=1, seed=3)
    mesh = make_mesh(cfg)
    params = init_params(cfg)
    batch = stream[:n]
    for precision, tol in (("default", SPEED_SCORE_TOL),
                           ("highest", PARITY_SCORE_TOL)):
        one = BeamDecoder(params, lexicon, vocab, cfg, precision=precision)
        fwd = make_sharded_forward(mesh, cfg, precision=precision)
        four = BeamDecoder(shard_params(params, cfg, mesh), lexicon, vocab,
                           cfg, forward_fn=fwd, precision=precision)
        r1 = one.decode_batch(batch)
        r4 = four.decode_batch(batch)
        same = sum(a[0].segments == b[0].segments for a, b in zip(r1, r4))
        gap = max(abs(a[0].score - b[0].score) for a, b in zip(r1, r4))
        log(f"vocab-sharded decode ({precision}, mesh data=1 x vocab=4, "
            f"{len(batch)} lattices): top-1 identical {same}/{len(batch)}, "
            f"max score gap {gap:.3g} (tol {tol})")
        assert same == len(batch), "sharded decode top-1 differs"
        assert np.isfinite(gap) and gap <= tol


@timed("four_train")
def phase_four_train(vocab_size=100_000, hidden=512, batch=32):
    """One sharded train step on (data=2, vocab=2) vs the one-card step."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from jlm.models.lstm import initial_state
    from jlm.models.params import init_params
    from jlm.parallel.mesh import make_mesh
    from jlm.train.trainer import Trainer

    cfg = config5(vocab_size, hidden, multiple=2, batch_size=batch,
                  num_steps=32, mesh_data=2, mesh_vocab=2, seed=4)
    params = init_params(cfg)
    rng = np.random.default_rng(1)
    x = rng.integers(0, cfg.vocab_size, (batch, 32)).astype(np.int32)
    y = rng.integers(0, cfg.vocab_size, (batch, 32)).astype(np.int32)
    losses = {}
    for name, mesh in (("one", None), ("four", make_mesh(cfg))):
        tr = Trainer(cfg, params=params, mesh=mesh)
        st = jax.tree.map(lambda s: tr._feed(np.asarray(s), 1),
                          initial_state(cfg, batch))
        _, _, _, loss = tr._train_step(
            tr.params, tr.opt_state, st, tr._feed(x), tr._feed(y),
            jax.random.key(0), jnp.float32(cfg.learning_rate))
        losses[name] = float(loss)
    # both layouts run their fp32 matmuls in TF32 (10-bit mantissa), in a
    # different summation order: relative tolerance 5e-3
    rel = abs(losses["one"] - losses["four"]) / abs(losses["one"])
    log(f"sharded train step (data=2 x vocab=2) loss {losses['four']:.6f} "
        f"vs one card {losses['one']:.6f} (rel diff {rel:.2e}, tol 5e-3)")
    assert np.isfinite(losses["four"]) and rel <= 5e-3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths (needs 4 GPUs)")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(REPO, "jlm")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(no jlm/ package beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform!r} devices",
              file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"need {need} GPUs, JAX found {len(devices)}", file=sys.stderr)
        return 1
    from jlm.backend import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    log(f"device: {devices[0].device_kind} x {len(devices)}; "
        f"jax {jax.__version__}")
    log(f"nvidia-smi: {card_info()}")
    setup = bench_setup()
    if args.four:
        phase_four_decode(setup)
        phase_four_train()
    else:
        phase_kernel()
        phase_batch(setup)
        phase_keystroke(setup)
        phase_train()
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
