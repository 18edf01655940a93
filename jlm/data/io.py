"""Data-directory persistence for prep artifacts.

Rebuild of the reference's pickled vocab/lexicon + .npy corpus artifacts
(ref: JLM:data/ — SURVEY.md §5.1 "pickle/np.save artifacts into data
dir"), in transparent formats: vocab as a TSV (``display/reading/POS\\tcount``
per line, id = line order), encoded splits as one ``corpus.npz``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from jlm.data.corpus import Token, Vocab, parse_token


def save_vocab(path: str, vocab: Vocab) -> None:
    with open(path, "w") as f:
        for tok, cnt in zip(vocab.tokens, vocab.counts):
            f.write(f"{tok.key}\t{int(cnt)}\n")


def load_vocab(path: str) -> Vocab:
    tokens, counts = [], []
    with open(path) as f:
        for line in f:
            key, _, cnt = line.rstrip("\n").rpartition("\t")
            tokens.append(parse_token(key))
            counts.append(int(cnt))
    id_of = {t.key: i for i, t in enumerate(tokens)}
    return Vocab(tokens=tokens, id_of=id_of, counts=np.asarray(counts, np.int64))


def save_dataset(
    data_dir: str,
    vocab: Vocab,
    train: np.ndarray,
    dev: np.ndarray,
    test: np.ndarray,
) -> None:
    os.makedirs(data_dir, exist_ok=True)
    save_vocab(os.path.join(data_dir, "vocab.tsv"), vocab)
    np.savez(
        os.path.join(data_dir, "corpus.npz"), train=train, dev=dev, test=test
    )


def load_dataset(
    data_dir: str,
) -> Tuple[Vocab, np.ndarray, np.ndarray, np.ndarray]:
    """Load a data dir — in-memory npz or streamed bin (memory-mapped)."""
    if not os.path.exists(os.path.join(data_dir, "corpus.npz")) and os.path.exists(
        os.path.join(data_dir, "meta.json")
    ):
        from jlm.data.streaming import load_dataset_bin

        return load_dataset_bin(data_dir)
    vocab = load_vocab(os.path.join(data_dir, "vocab.tsv"))
    with np.load(os.path.join(data_dir, "corpus.npz")) as z:
        return vocab, z["train"], z["dev"], z["test"]
