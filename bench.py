#!/usr/bin/env python
"""Benchmark: kana-kanji conversion chars/sec on one GPU vs the CPU oracle.

Protocol (BASELINE.md): no published digits exist for the reference, so the
measured numpy CPU oracle (BASELINE config 1: 1-layer 512-hidden LSTM, 50k
vocab, full softmax, greedy Viterbi over the fixed synthetic test file) is
the de-facto baseline.  The benchmarked device path is the harder config-2
workload — beam-10 lattice decoding, streaming batched over the whole test
set in one device-resident scan — at flagship dims on one card.

Prints exactly ONE JSON line on stdout:
  {"metric": ..., "value": ..., "unit": "chars/s", "vs_baseline": ...,
   "device": {...}}
Diagnostics (oracle baseline, parity vs oracle, timing splits) go to stderr.
Refuses to run without a GPU.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


# Published dense peaks per card, keyed by JAX's ``device_kind`` (NVIDIA
# H100 SXM data sheet: bf16 989 TFLOP/s, int8 1,979 TOP/s, HBM3 3.35 TB/s,
# at the full 700 W power limit).  A card not in the table is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "int8_tops": 1979.0,
                              "hbm_tbps": 3.35},
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    from jlm.backend import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    if dev.device_kind not in PEAKS:
        raise SystemExit(f"no published peaks for {dev.device_kind!r}: "
                         "add them to PEAKS with their source")
    peak = PEAKS[dev.device_kind]
    enable_compile_cache()

    from jlm.config import Config
    from jlm.data import (
        Lexicon,
        build_vocab,
        generate_corpus,
        generate_test_set,
    )
    from jlm.decoder.engine import BeamDecoder
    from jlm.models.params import init_params
    from jlm.oracle import OracleDecoder, OracleLM

    log(f"devices: {jax.devices()}")

    # Flagship dims (BASELINE configs 1/2): vocab padded to 50k — the
    # synthetic lexicon occupies the low ids; the model pays the full
    # 50k-softmax cost either way, which is what we are measuring.
    config = Config(
        vocab_size=50_000,
        embed_size=256,
        hidden_size=512,
        num_layers=1,
        beam_width=10,
        n_best_max=1,  # top-1 bench: keep the fetched path payload minimal
        seed=0,
    )
    vocab = build_vocab(generate_corpus(2000, seed=1234), config.vocab_size)
    lexicon = Lexicon.from_vocab(vocab)
    params = init_params(config)
    tests = generate_test_set(50, seed=777)
    kanas = [k for k, _ in tests]
    n_chars = sum(len(k) for k in kanas)

    # --- CPU oracle baseline: config 1 (greedy, numpy) -------------------
    greedy_cfg = config.replace(beam_width=1)
    oracle = OracleDecoder(
        OracleLM(params, greedy_cfg), lexicon, vocab, greedy_cfg
    )
    # best-of-2 passes: the baseline must reflect the oracle's actual
    # speed, not transient CPU contention on the shared host
    oracle_dt = float("inf")
    for _ in range(2):
        t0 = time.time()
        oracle_results = [oracle.decode(k)[0] for k in kanas]
        oracle_dt = min(oracle_dt, time.time() - t0)
    baseline = n_chars / oracle_dt
    log(f"oracle (CPU greedy, config 1): {n_chars} chars in "
        f"{oracle_dt:.2f}s = {baseline:.1f} chars/s")

    # --- device engine: speed mode (beam-10, streaming batched) ----------
    # Streaming regime (BASELINE config 5's per-card unit): many
    # 2048-lattice chunks are DISPATCHED before any result is fetched, so
    # chunk k's device scan overlaps chunk k-1's result fetch.
    #
    # The headline engine uses int8 weights with the int8 x int8 kernel
    # head — the reference's OWN headline recipe is int8 quantization for
    # speed (SURVEY.md §4.3; JLM:README.md).  Greedy top-1 parity vs the
    # oracle is still asserted on the exact fp32 path below.
    from jlm.ops.quant import quantize_params

    qp = quantize_params(params)
    # int8_mxu=True is the config default: quantized weights +
    # precision="default" IS the headline recipe.
    engine = BeamDecoder(qp, lexicon, vocab, config, precision="default")
    CHUNK = 2048
    stream = (kanas * ((CHUNK + 49) // 50))[:CHUNK]
    stream_chars = sum(len(k) for k in stream)
    t0 = time.time()
    results = engine.decode_batch(stream, n_best=1)
    log(f"device compile+first run: {time.time() - t0:.1f}s")
    reps = 12
    # Warm every length-sorted chunk shape once (distinct T buckets compile
    # separately) so the timed passes measure steady state, not compiles.
    engine.decode_stream(stream * reps, chunk_size=CHUNK, n_best=1)
    # best of 4 passes
    dev_dt = float("inf")
    for _ in range(4):
        t0 = time.time()
        results = engine.decode_stream(stream * reps, chunk_size=CHUNK,
                                       n_best=1)
        dev_dt = min(dev_dt, (time.time() - t0) / reps)
    value = stream_chars / dev_dt
    log(f"device (beam-10 streaming, {reps}x{len(stream)} lattices, "
        f"length-sorted chunks): {stream_chars * reps} chars in "
        f"{dev_dt:.3f}s/chunk = {value:.1f} chars/s")
    results = results[: len(kanas)]

    # --- utilization accounting ------------------------------------------
    B = config.beam_pad
    S, H, E, V = CHUNK, config.hidden_size, config.embed_size, config.vocab_size
    # Scanned frames: reproduce the engine's own chunking — length-sorted
    # stream, CHUNK-sentence chunks, each scanning t_bucket(max len in
    # chunk) frames.
    sorted_lens = sorted(len(k) for k in stream * reps)
    total_frames = sum(
        min(engine._t_bucket(max(sorted_lens[i:i + CHUNK])),
            config.max_kana_len)
        for i in range(0, len(sorted_lens), CHUNK)
    ) / reps  # per-rep frames across the sorted chunks
    lstm_fl = 2 * S * B * (E + H) * 4 * H
    head_fl = 2 * S * B * H * V
    tflops = total_frames * (lstm_fl + head_fl) / dev_dt / 1e12
    # Useful work only: live beam rows (B = beam_pad = 10).
    log(f"achieved {tflops:.1f} TFLOP/s useful over {total_frames:.1f} "
        f"frames/rep = {100 * tflops / peak['bf16_tflops']:.1f}% of the "
        f"{dev.device_kind} bf16 peak ({peak['bf16_tflops']:.0f}), "
        f"{100 * tflops / peak['int8_tops']:.1f}% of its int8 peak")

    # --- parity: beam-1 fp32 engine must reproduce the oracle's exact
    # greedy paths (top-1 path identity, the BASELINE north-star check) ----
    greedy_eng = BeamDecoder(params, lexicon, vocab, greedy_cfg,
                             precision="highest")
    greedy_results = greedy_eng.decode_batch(kanas, n_best=1)
    exact = sum(
        r[0].segments == o.segments
        for r, o in zip(greedy_results, oracle_results)
    )
    log(f"greedy parity {exact}/{len(kanas)} (top-1 path identity vs oracle)")
    assert exact == len(kanas), "greedy path-identity parity failed"

    # --- beam parity at scale: beam-10 top-1 PATH IDENTITY
    # vs the numpy oracle on all 50 sentences, for BOTH decode heads. ------
    # Referee 1: the int8-tolerance oracle (beam-10 over exactly-dequantized
    # int8 weights, fp32 math) judges the headline int8 x int8 engine — its
    # in-kernel activation quantization perturbs scores ~1e-2 but must not
    # change the argmax path.
    beam_cfg = config  # beam_width=10
    orc_q = OracleDecoder(OracleLM(qp, beam_cfg), lexicon, vocab, beam_cfg)
    t0 = time.time()
    orc_beam_q = [orc_q.decode(k)[0] for k in kanas]
    log(f"oracle beam-10 referee (int8 dequant): {time.time() - t0:.1f}s")
    par_int8 = sum(
        r[0].segments == o.segments for r, o in zip(results, orc_beam_q)
    )
    log(f"beam parity {par_int8}/{len(kanas)} (path identity, int8 x int8 head "
        "vs int8-tolerance oracle)")
    # Referee 2: the fp32 oracle judges the bf16 full-softmax head.
    bf16_eng = BeamDecoder(params, lexicon, vocab, config, precision="default")
    bf16_results = bf16_eng.decode_batch(kanas, n_best=1)
    orc_f = OracleDecoder(OracleLM(params, beam_cfg), lexicon, vocab, beam_cfg)
    t0 = time.time()
    orc_beam_f = [orc_f.decode(k)[0] for k in kanas]
    log(f"oracle beam-10 referee (fp32): {time.time() - t0:.1f}s")
    par_bf16 = sum(
        r[0].segments == o.segments for r, o in zip(bf16_results, orc_beam_f)
    )
    log(f"beam parity {par_bf16}/{len(kanas)} (path identity, bf16 head vs "
        "fp32 oracle)")

    print(
        json.dumps(
            {
                "metric": "kana_kanji_chars_per_sec_per_card",
                "value": round(value, 1),
                "unit": "chars/s",
                "vs_baseline": round(value / baseline, 2),
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )


if __name__ == "__main__":
    main()
