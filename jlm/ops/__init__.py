"""Kernels and low-level ops — the build's native layer.

The reference contains zero native code; its numpy inference engine is the
stand-in for native kernels (SURVEY.md §3.2).  The one hot path that earns
a hand-written kernel on the GPU is the decode head's normaliser
(:mod:`jlm.ops.project`: output projection with in-kernel int8 dequant and
online logsumexp, Pallas through Triton); the LSTM cell and candidate
scoring are plain XLA.  :mod:`jlm.ops.quant` holds int8 quantization.
"""
