"""Import reference-exported weights into the build's weight spec.

The reference trains in TF 1.x and exports a plain ``name -> numpy array``
dict for its numpy/C++ inference engines (ref: JLM:decoder/ exporter —
SURVEY.md §3.1 "Checkpoint→numpy exporter", §7 "pickled numpy weight
dict").  This module is the counterpart: it reads such an export (``.npz``
or pickle) and re-keys it into :func:`jlm.models.params.init_params`'s
pytree so a user can drop reference-trained weights straight into the
engine.

The mount at ``/root/reference`` was empty at build time, so the exact
variable names are [C-med] unverifiable (SURVEY.md §0); matching is
therefore SHAPE-DRIVEN with name hints covering the common TF-1.x LM
conventions:

- embedding: ``[V, E]`` (name contains ``embedding``/``embed``);
- LSTM layer l: fused kernel ``[(in_l + H), 4H]`` + bias ``[4H]``
  (``lstm``/``cell``/``rnn`` + ``kernel``/``weights`` | ``bias``); TF's
  BasicLSTMCell gate order is i, j, f, o — identical to ours (SURVEY.md
  §4.2), and TF keeps the forget-gate bias as a runtime offset, matching
  ``config.forget_bias``, so the kernel/bias import VERBATIM;
- full-softmax head: ``[H, V]`` (or ``[V, H]``, auto-transposed) + ``[V]``
  (``softmax``/``proj``/``output`` + ``w``/``b``);
- D-softmax blocks: per-block ``[d_k, s_k]`` matched by block shape.

Anything unmatched or shape-mismatched raises with a mapping report —
silent partial imports would corrupt parity.
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Dict, List, Tuple

import numpy as np

from jlm.config import Config


def load_export(path: str) -> Dict[str, np.ndarray]:
    """Read a reference weight export: ``.npz`` or a pickled dict."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    with open(path, "rb") as f:
        obj = pickle.load(f)
    assert isinstance(obj, dict), f"expected a dict export, got {type(obj)}"
    return {str(k): np.asarray(v) for k, v in obj.items()}


def _score_name(name: str, hints: Tuple[str, ...]) -> int:
    n = name.lower()
    return sum(1 for h in hints if h in n)


def _take(
    cands: Dict[str, np.ndarray],
    shapes: List[Tuple[int, ...]],
    hints: Tuple[str, ...],
    what: str,
    allow_transpose: bool = False,
) -> Tuple[str, np.ndarray]:
    """Pop the best candidate matching one of ``shapes`` (hints break ties)."""
    matches = []
    for name, arr in cands.items():
        if tuple(arr.shape) in shapes:
            matches.append((name, arr, False))
        elif allow_transpose and arr.ndim == 2 and arr.shape[::-1] in [
            tuple(s) for s in shapes
        ]:
            matches.append((name, arr, True))
    if not matches:
        raise KeyError(
            f"no exported tensor matches {what} (shapes {shapes}); "
            f"available: { {k: v.shape for k, v in cands.items()} }"
        )
    matches.sort(key=lambda m: (-_score_name(m[0], hints), m[0]))
    name, arr, transpose = matches[0]
    del cands[name]
    return name, (arr.T if transpose else arr)


# natural-sort for layer ordering ("cell_0" < "cell_2" < "cell_10")
def _natkey(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def import_reference_weights(
    export: Dict[str, np.ndarray], config: Config
) -> Tuple[Dict[str, Any], Dict[str, str]]:
    """Re-key a reference export into the build's param pytree.

    Returns ``(params, mapping)`` where ``mapping`` records
    ``our-name -> their-name`` for audit.  Raises on any unmatched or
    leftover weight tensor (scales/metadata leftovers are reported, not
    fatal).
    """
    V, E, H = config.vocab_size, config.embed_size, config.hidden_size
    cands = dict(export)
    mapping: Dict[str, str] = {}

    name, emb = _take(cands, [(V, E)], ("embed",), "embedding")
    mapping["embedding"] = name

    lstm: List[Dict[str, np.ndarray]] = []
    kernels: List[Tuple[str, np.ndarray]] = []
    for layer in range(config.num_layers):
        in_dim = E if layer == 0 else H
        kname, k = _take(
            cands, [(in_dim + H, 4 * H)],
            ("lstm", "cell", "rnn", "kernel", "weight"),
            f"lstm kernel layer {layer}", allow_transpose=True,
        )
        kernels.append((kname, k))
    # order multi-layer kernels by their exported names (natural sort), so
    # "cell_0/..." maps to layer 0 even if _take popped them out of order —
    # only unambiguous when layer input dims differ or names carry indices
    if config.num_layers > 1 and all(
        k[1].shape == kernels[0][1].shape for k in kernels
    ):
        kernels.sort(key=lambda t: _natkey(t[0]))
    biases: List[Tuple[str, np.ndarray]] = []
    for layer in range(config.num_layers):
        bname, b = _take(
            cands, [(4 * H,)], ("lstm", "cell", "rnn", "bias"),
            f"lstm bias layer {layer}",
        )
        biases.append((bname, b))
    if config.num_layers > 1:
        biases.sort(key=lambda t: _natkey(t[0]))
    for layer, ((kname, k), (bname, b)) in enumerate(zip(kernels, biases)):
        lstm.append({"W": k.astype(np.float32), "b": b.astype(np.float32)})
        mapping[f"lstm/{layer}/W"] = kname
        mapping[f"lstm/{layer}/b"] = bname

    if config.head == "dsoftmax":
        ds = config.dsoftmax
        blocks = []
        for k, (s, d) in enumerate(zip(ds.block_sizes, ds.block_dims)):
            wname, w = _take(
                cands, [(d, s)], ("softmax", "block", "w"),
                f"dsoftmax block {k} W", allow_transpose=True,
            )
            bname, bb = _take(
                cands, [(s,)], ("softmax", "block", "b"),
                f"dsoftmax block {k} b",
            )
            blocks.append({"W": w.astype(np.float32),
                           "b": bb.astype(np.float32)})
            mapping[f"head/blocks/{k}/W"] = wname
            mapping[f"head/blocks/{k}/b"] = bname
        head: Dict[str, Any] = {"blocks": blocks}
    else:
        wname, w = _take(
            cands, [(H, V)], ("softmax", "proj", "output", "w"),
            "head W", allow_transpose=True,
        )
        bname, bb = _take(cands, [(V,)], ("softmax", "proj", "b"), "head b")
        head = {"W": w.astype(np.float32), "b": bb.astype(np.float32)}
        mapping["head/W"] = wname
        mapping["head/b"] = bname

    params = {"embedding": emb.astype(np.float32), "lstm": lstm, "head": head}

    # sanity: the import must satisfy the weight-spec contract exactly
    from jlm.models.params import init_params, param_spec

    want = param_spec(init_params(config))
    got = param_spec(params)
    assert got == want, f"imported spec mismatch:\n got {got}\nwant {want}"
    if cands:
        import sys

        print(
            f"import_reference_weights: {len(cands)} unmatched exported "
            f"tensors ignored: { {k: v.shape for k, v in cands.items()} }",
            file=sys.stderr,
        )
    return params, mapping
