"""Where the program runs: the head path per platform, and the compile cache.

One decision point for every entry that can run the Hopper kernel head
(``BeamDecoder``, ``IncrementalDecoder``, ``SessionServer`` and the
vocab-sharded forward):

- ``gpu``: the kernel head in speed mode (``precision="default"``), the
  plain fp32 path in parity mode (``"highest"``);
- ``cpu``: the plain path;
- any other platform: an error, never a silent fallback.

Pallas interpret mode is never chosen here: only a caller that passes
``interpret=True`` (the tests) gets it.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def use_kernels(precision: str, platform: Optional[str] = None) -> bool:
    """Whether the decode paths take the kernel head on ``platform``
    (default: JAX's default backend)."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return precision == "default"
    if platform == "cpu":
        return False
    raise RuntimeError(
        f"unsupported JAX platform {platform!r}: this program runs on an "
        "NVIDIA GPU ('gpu') or, for tests, on the CPU ('cpu')"
    )


def enable_compile_cache(environ: Optional[Mapping[str, str]] = None) -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads
    it itself, so nothing is set here).  Otherwise the cache is
    ``<repo>/.jax_cache``: a fixed path, because the path is part of the
    cache key and a moving directory never hits.
    """
    environ = os.environ if environ is None else environ
    path = environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = os.path.join(_REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
