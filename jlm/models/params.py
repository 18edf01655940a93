"""Model parameter initialization and the weight spec.

Single source of truth for the parameter pytree shared by the numpy oracle,
the JAX engine, the trainer, and the checkpoints (the "weight spec" contract
of SURVEY.md §7 "Checkpoint / resume").  Initialization is numpy-seeded so
the oracle needs no JAX and golden fixtures are reproducible bit-for-bit.

Layout (model spec per SURVEY.md §4.2, ref: JLM:train/lm.py):

```
{
  "embedding": f32[V, E],
  "lstm": [ {"W": f32[in_l + H, 4H], "b": f32[4H]} ],   # in_0 = E, in_l = H
  "head": {"W": f32[H, V], "b": f32[V]}                       # full softmax
        | {"blocks": [{"W": f32[d_k, s_k], "b": f32[s_k]}]}   # D-softmax
}
```

Gate order inside the fused ``4H`` dimension is ``i, j, f, o`` (input gate,
cell candidate, forget gate, output gate) — the standard fused-LSTM layout
the reference's numpy engine re-implements (SURVEY.md §4.2).  The forget
bias offset is applied at run time (``config.forget_bias``), not baked into
``b``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from jlm.config import Config

INIT_SCALE = 0.05  # PTB-style uniform init


def init_params(config: Config, seed: int | None = None) -> Dict[str, Any]:
    rng = np.random.default_rng(config.seed if seed is None else seed)

    def u(*shape):
        return rng.uniform(-INIT_SCALE, INIT_SCALE, size=shape).astype(np.float32)

    V, E, H = config.vocab_size, config.embed_size, config.hidden_size
    lstm: List[Dict[str, np.ndarray]] = []
    for layer in range(config.num_layers):
        in_dim = E if layer == 0 else H
        lstm.append({"W": u(in_dim + H, 4 * H), "b": np.zeros(4 * H, np.float32)})

    if config.head == "dsoftmax":
        assert config.dsoftmax is not None, "dsoftmax config required"
        assert sum(config.dsoftmax.block_sizes) == V, (
            f"dsoftmax blocks {config.dsoftmax.block_sizes} must sum to vocab {V}"
        )
        if config.dsoftmax.mode == "disjoint":
            assert sum(config.dsoftmax.block_dims) <= H
        blocks = [
            {"W": u(d, s), "b": np.zeros(s, np.float32)}
            for s, d in zip(config.dsoftmax.block_sizes, config.dsoftmax.block_dims)
        ]
        head: Dict[str, Any] = {"blocks": blocks}
    else:
        head = {"W": u(H, V), "b": np.zeros(V, np.float32)}

    return {"embedding": u(V, E), "lstm": lstm, "head": head}


def param_spec(params: Dict[str, Any]) -> Dict[str, Any]:
    """Names/shapes/dtypes of every leaf — the trainer↔engine contract."""

    def walk(p, prefix=""):
        out = {}
        if isinstance(p, dict):
            for k, v in p.items():
                out.update(walk(v, f"{prefix}{k}/"))
        elif isinstance(p, (list, tuple)):
            for i, v in enumerate(p):
                out.update(walk(v, f"{prefix}{i}/"))
        else:
            arr = np.asarray(p)
            out[prefix[:-1]] = {"shape": tuple(arr.shape), "dtype": str(arr.dtype)}
        return out

    return walk(params)
