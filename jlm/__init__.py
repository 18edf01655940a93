"""jlm — a kana-kanji conversion engine for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference ``jiali-ms/JLM`` (LSTM language model + lattice beam-Viterbi
decoding for real-time Japanese IME conversion; see SURVEY.md for the
full component inventory and behavioral spec of the reference).

Layer map (mirrors SURVEY.md §2, re-designed for an accelerator):

- ``jlm.data``     — corpus prep, frequency vocab, lexicon/reading dict,
                         truncated-BPTT batch reader.       (ref: JLM:data/)
- ``jlm.oracle``   — pure-numpy CPU reference LM + decoder; defines the
                         golden parity outputs (stands in for the reference's
                         numpy inference engine, JLM:decoder/).
- ``jlm.models``   — JAX LSTM LM (init/apply pytrees, lax.scan), output
                         heads: full / sampled / D-softmax. (ref: JLM:train/lm.py)
- ``jlm.ops``      — the Hopper head kernel (output projection with
                         in-kernel int8 dequant and online logsumexp, Pallas
                         through Triton), quantization.     (the native layer)
- ``jlm.backend``  — which path runs on which platform; the compile cache.
- ``jlm.decoder``  — lattice construction + device-resident beam-Viterbi
                         (whole search is one lax.scan on device) and the
                         incremental per-keystroke engine.  (ref: JLM:decoder/decoder.py)
- ``jlm.parallel`` — device mesh, vocab-sharded output head with
                         globally-consistent top-k, multi-host bootstrap.
- ``jlm.train``    — optax trainer with truncated BPTT, lr decay, grad
                         clip, PPL eval, checkpointing.     (ref: JLM:train/train.py)
- ``jlm.eval``     — conversion accuracy / latency harness.
"""

__version__ = "0.1.0"
