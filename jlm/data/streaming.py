"""Streaming corpus prep for corpora that don't fit in memory.

The reference loads the whole corpus into Python lists (ref: JLM:data/
data.py — fine at BCCWJ scale, SURVEY.md §5.1); this module re-does the
same two passes bounded by O(unique tokens) + O(chunk):

1. vocab pass — stream lines through the existing Counter-based
   :func:`jlm.data.corpus.build_vocab` (it already takes an iterable);
2. encode pass — chunk the file at line boundaries, encode each chunk with
   the native C++ encoder (:mod:`jlm.native.encoder_lib`; Python
   fallback is bit-identical), and append raw int32 to ``corpus.bin``.

The resulting data dir holds ``vocab.tsv`` + ``corpus.bin`` + ``meta.json``
(split offsets); :func:`jlm.data.io.load_dataset` memory-maps the bin,
so training reads windows straight from the page cache.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator, Tuple

import numpy as np

from jlm.data.corpus import Vocab, build_vocab, encode_corpus

DEFAULT_CHUNK_BYTES = 8 << 20


def stream_lines(path: str) -> Iterator[str]:
    """Line iterator over a corpus file (constant memory)."""
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            yield line.rstrip("\n")


def iter_line_chunks(
    path: str, chunk_bytes: int = DEFAULT_CHUNK_BYTES
) -> Iterator[bytes]:
    """Yield byte chunks of the file, each ending on a line boundary."""
    with open(path, "rb") as f:
        carry = b""
        while True:
            block = f.read(chunk_bytes)
            if not block:
                if carry:
                    yield carry
                return
            block = carry + block
            cut = block.rfind(b"\n")
            if cut < 0:
                carry = block  # pathological single line longer than chunk
                continue
            yield block[: cut + 1]
            carry = block[cut + 1 :]


def build_vocab_file(path: str, vocab_size: int) -> Vocab:
    """Streaming frequency-vocab pass (memory = O(unique tokens))."""
    return build_vocab(stream_lines(path), vocab_size)


def encode_corpus_file(
    path: str,
    vocab: Vocab,
    out_bin: str,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    use_native: bool = True,
) -> int:
    """Encode ``path`` into raw little-endian int32 at ``out_bin``.

    Returns the total id count.  Uses the native C++ encoder when a
    toolchain is available; the Python fallback is the in-memory
    :func:`encode_corpus` applied per chunk (same output by construction —
    chunks end on line boundaries and encoding is line-local).
    """
    enc = None
    if use_native:
        from jlm.native import encoder_lib

        if encoder_lib.available():
            enc = encoder_lib.NativeEncoder(vocab)
    total = 0
    with open(out_bin, "wb") as out:
        for chunk in iter_line_chunks(path, chunk_bytes):
            if enc is not None:
                ids = enc.encode_chunk(chunk)
            else:
                lines = chunk.decode("utf-8").split("\n")
                ids = encode_corpus(lines, vocab)
            ids = np.ascontiguousarray(ids, dtype="<i4")
            out.write(ids.tobytes())
            total += len(ids)
    return total


def save_dataset_streamed(
    data_dir: str,
    corpus_path: str,
    vocab_size: int,
    dev_frac: float = 0.05,
    test_frac: float = 0.05,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    use_native: bool = True,
) -> Tuple[Vocab, int]:
    """Full streaming prep: vocab pass + encode pass + split metadata.

    Splits are contiguous offsets into one ``corpus.bin`` (same slicing rule
    as :func:`jlm.data.corpus.split_corpus`), so no id is ever copied.
    """
    from jlm.data.io import save_vocab

    os.makedirs(data_dir, exist_ok=True)
    vocab = build_vocab_file(corpus_path, vocab_size)
    save_vocab(os.path.join(data_dir, "vocab.tsv"), vocab)
    n = encode_corpus_file(
        corpus_path, vocab, os.path.join(data_dir, "corpus.bin"),
        chunk_bytes, use_native,
    )
    n_dev = int(n * dev_frac)
    n_test = int(n * test_frac)
    n_train = n - n_dev - n_test
    meta = {
        "total": n,
        "train": [0, n_train],
        "dev": [n_train, n_train + n_dev],
        "test": [n_train + n_dev, n],
        "dtype": "<i4",
    }
    with open(os.path.join(data_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return vocab, n


def load_dataset_bin(data_dir: str):
    """Memory-mapped (vocab, train, dev, test) from a streamed data dir."""
    from jlm.data.io import load_vocab

    vocab = load_vocab(os.path.join(data_dir, "vocab.tsv"))
    with open(os.path.join(data_dir, "meta.json")) as f:
        meta = json.load(f)
    ids = np.memmap(
        os.path.join(data_dir, "corpus.bin"), dtype=meta["dtype"], mode="r",
        shape=(meta["total"],),
    )
    return (
        vocab,
        ids[meta["train"][0] : meta["train"][1]],
        ids[meta["dev"][0] : meta["dev"][1]],
        ids[meta["test"][0] : meta["test"][1]],
    )
