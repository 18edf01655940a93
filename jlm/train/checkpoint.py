"""Checkpoint save/load and the trainer↔engine weight contract.

Analogue of the reference's TF Saver checkpoints + pickled numpy
weight dict (ref: JLM:train/train.py Saver usage, JLM:decoder/ exporter —
SURVEY.md §5.3, §7 "Checkpoint / resume").  Format: a directory per
experiment holding

- ``config.json`` — the full Config (hyperparams recorded per experiment
  dir, mirroring the reference's numbered experiment dirs);
- ``ckpt-<tag>.npz`` — flat ``name → numpy array`` archive of the param
  pytree (the weight spec of :func:`jlm.models.params.param_spec` is
  exactly the archive's key set), including int8 ``q``/``scale`` pairs;
- ``log.jsonl`` — per-epoch metrics appended by the trainer.

Flat npz (not pickle) keeps checkpoints language-neutral and safely
loadable.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from jlm.config import Config


def _flatten(p: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(p, dict):
        for k, v in p.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(p, (list, tuple)):
        for i, v in enumerate(p):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(p)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    """Rebuild the nested pytree; integer path segments become lists."""

    def insert(tree: Dict, path: List[str], leaf):
        head = path[0]
        if len(path) == 1:
            tree[head] = leaf
        else:
            insert(tree.setdefault(head, {}), path[1:], leaf)

    root: Dict = {}
    for name, arr in flat.items():
        insert(root, name.split("/"), arr)

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_checkpoint(
    exp_dir: str, params: Any, config: Config, tag: str = "latest"
) -> str:
    os.makedirs(exp_dir, exist_ok=True)
    cfg_path = os.path.join(exp_dir, "config.json")
    if not os.path.exists(cfg_path):
        with open(cfg_path, "w") as f:
            f.write(config.to_json())
    path = os.path.join(exp_dir, f"ckpt-{tag}.npz")
    np.savez(path, **_flatten(params))
    return path


def load_checkpoint(
    exp_dir: str, tag: str = "latest"
) -> Tuple[Any, Optional[Config]]:
    path = os.path.join(exp_dir, f"ckpt-{tag}.npz")
    with np.load(path) as z:
        params = _unflatten({k: z[k] for k in z.files})
    cfg_path = os.path.join(exp_dir, "config.json")
    config = None
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = Config.from_json(f.read())
    return params, config


def append_log(exp_dir: str, record: Dict[str, Any]) -> None:
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "log.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")
