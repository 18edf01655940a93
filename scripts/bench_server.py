#!/usr/bin/env python
"""Multi-session server latency/throughput under load.

Simulates M concurrent typing sessions pushing keystrokes in batches of E
events per device step and reports the per-step latency distribution
(median/p95/p99), per-keystroke amortized latency, and keystrokes/s.

Each synchronous step pays one dispatch and one fetch; batching E
keystrokes per step is what keeps throughput up — that ratio
(events/step-latency) is the serving number.  Needs a GPU.

Usage: python scripts/bench_server.py [--sessions 64] [--events 64]
       [--steps 40] [--quick]
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=64)
    ap.add_argument("--events", type=int, default=64,
                    help="keystroke events batched per device step")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    if args.quick:
        args.sessions, args.events, args.steps = 16, 16, 10

    import jax

    from jlm.backend import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench_server.py needs a GPU")
    enable_compile_cache()

    from jlm.config import Config
    from jlm.data import Lexicon, build_vocab, generate_corpus, generate_test_set
    from jlm.decoder.server import SessionServer
    from jlm.models.params import init_params

    config = Config(
        vocab_size=50_000, embed_size=256, hidden_size=512, num_layers=1,
        beam_width=10, seed=0,
    )
    vocab = build_vocab(generate_corpus(2000, seed=1234), config.vocab_size)
    lexicon = Lexicon.from_vocab(vocab)
    params = init_params(config)
    srv = SessionServer(params, lexicon, vocab, config,
                        max_sessions=args.sessions, precision="default")

    kanas = [k for k, _ in generate_test_set(200, seed=777)]
    streams = [itertools.cycle(kanas[i % len(kanas)]) for i in range(args.sessions)]
    sids = [srv.open() for _ in range(args.sessions)]
    # reset a session when its input would exceed the static bound
    typed = [0] * args.sessions

    def make_events(n):
        evs = []
        for _ in range(n):
            i = len(evs) % args.sessions
            if typed[i] >= config.max_kana_len - 1:
                srv.close(sids[i])
                sids[i] = srv.open()
                typed[i] = 0
            evs.append((sids[i], next(streams[i])))
            typed[i] += 1
        return evs

    srv.push(make_events(args.events))  # compile + warm
    lat = []
    t_all = time.time()
    for _ in range(args.steps):
        evs = make_events(args.events)
        t0 = time.time()
        srv.push(evs)
        srv.results(evs[0][0], 1)  # force sync: one session's materialized result
        lat.append(time.time() - t0)
    wall = time.time() - t_all
    lat.sort()
    n = len(lat)
    med, p95, p99 = lat[n // 2], lat[int(n * 0.95)], lat[min(n - 1, int(n * 0.99))]
    ev_total = args.steps * args.events
    log(f"sessions={args.sessions} events/step={args.events} steps={args.steps}")
    log(f"step latency ms: median {med*1e3:.1f}  p95 {p95*1e3:.1f}  "
        f"p99 {p99*1e3:.1f}")
    log(f"amortized per-keystroke: {med*1e3/args.events:.2f} ms; "
        f"throughput {ev_total/wall:.0f} keystrokes/s")
    print({"median_step_ms": round(med * 1e3, 1),
           "p95_step_ms": round(p95 * 1e3, 1),
           "p99_step_ms": round(p99 * 1e3, 1),
           "keystrokes_per_sec": round(ev_total / wall, 1)})


if __name__ == "__main__":
    main()
