"""ctypes loader + wrapper for the native corpus encoder (encoder.cpp).

Same compile-on-first-use pattern as the native lattice builder: plain
``g++ -O3 -shared`` cached by source hash, transparent Python fallback when
no compiler is present (callers check :func:`available`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

from jlm.config import EOS_ID, UNK_ID
from jlm.data.corpus import Vocab

_SRC = os.path.join(os.path.dirname(__file__), "encoder.cpp")
_lib = None
_lib_error: Optional[str] = None


def _load_lib():
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(tempfile.gettempdir(), f"jlm_libencoder_{tag}.so")
        if not os.path.exists(so):
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", so],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(so)
        lib.jlm_encoder_create.restype = ctypes.c_void_p
        lib.jlm_encoder_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.jlm_encoder_destroy.argtypes = [ctypes.c_void_p]
        lib.jlm_encode_chunk.restype = ctypes.c_int64
        lib.jlm_encode_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        _lib = lib
    except Exception as e:  # no compiler / load failure → python fallback
        _lib_error = str(e)
    return _lib


def available() -> bool:
    return _load_lib() is not None


class NativeEncoder:
    """Chunked corpus → int32-id encoder, bit-identical to encode_corpus.

    The vocab's keys are shipped once as a UTF-8 blob + offsets; each
    :meth:`encode_chunk` call tokenizes a buffer of complete lines in C++.
    """

    def __init__(self, vocab: Vocab):
        lib = _load_lib()
        assert lib is not None, f"native encoder unavailable: {_lib_error}"
        self._lib = lib
        keys = [t.key.encode("utf-8") for t in vocab.tokens]
        blob = b"".join(keys)
        offsets = np.zeros(len(keys) + 1, np.int64)
        np.cumsum([len(k) for k in keys], out=offsets[1:])
        self._blob = np.frombuffer(blob, np.uint8).copy()
        self._offsets = offsets
        self._h = lib.jlm_encoder_create(
            self._blob.ctypes.data_as(ctypes.c_void_p),
            offsets.ctypes.data_as(ctypes.c_void_p),
            np.int32(len(keys)), np.int32(EOS_ID), np.int32(UNK_ID),
        )

    def encode_chunk(self, data: bytes) -> np.ndarray:
        """Encode a byte buffer of complete lines → int32 id array."""
        buf = np.frombuffer(data, np.uint8)
        cap = len(buf) + 1
        out = np.empty(cap, np.int32)
        n = self._lib.jlm_encode_chunk(
            self._h,
            buf.ctypes.data_as(ctypes.c_void_p), np.int64(len(buf)),
            out.ctypes.data_as(ctypes.c_void_p), np.int64(cap),
        )
        assert n >= 0, "native encoder output overflow (impossible by sizing)"
        return out[:n].copy()

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.jlm_encoder_destroy(self._h)
                self._h = None
        except Exception:
            pass
