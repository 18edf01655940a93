"""Device mesh construction and multi-host bootstrap.

Replacement for the communication backend the reference lacks
(SURVEY.md §3.3, §7 "Distributed comm backend"): a ``(data, vocab)``
``jax.sharding.Mesh``; XLA hands the collectives to NCCL.  The
multi-host launcher is the MPI-equivalent: one process per host,
``jax.distributed.initialize``, identical SPMD program everywhere.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np

from jlm.config import Config

DATA_AXIS = "data"
VOCAB_AXIS = "vocab"
SEQ_AXIS = "seq"


def make_mesh(config: Config, devices: Optional[Sequence] = None) -> jax.sharding.Mesh:
    """Mesh of shape ``(mesh_data, mesh_vocab)`` with axes ``(data, vocab)``.

    The vocab axis carries the per-step logsumexp and candidate
    exchanges; the data axis carries no per-step traffic, so it is the
    one to stretch across hosts.  Within a host the cards are joined all
    to all by NVLink, so the order of devices within the mesh does not
    matter there.
    """
    n = config.mesh_data * config.mesh_vocab
    devs = list(devices) if devices is not None else jax.devices()
    assert len(devs) >= n, f"need {n} devices, have {len(devs)}"
    return jax.sharding.Mesh(
        np.asarray(devs[:n]).reshape(config.mesh_data, config.mesh_vocab),
        (DATA_AXIS, VOCAB_AXIS),
    )


def make_seq_mesh(
    config: Config, devices: Optional[Sequence] = None
) -> jax.sharding.Mesh:
    """1-D ``('seq',)`` mesh for time-block pipeline training.

    The seq axis carries per-round (c, h) carry ppermutes between
    neighbor stages — keep it within one host.
    """
    n = config.mesh_seq
    devs = list(devices) if devices is not None else jax.devices()
    assert len(devs) >= n, f"need {n} devices, have {len(devs)}"
    return jax.sharding.Mesh(np.asarray(devs[:n]), (SEQ_AXIS,))


def multihost_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the JAX multi-process runtime (no-op for 1 process).

    Fails fast on mesh mismatch by construction: every process must call
    this before ``make_mesh``, and ``jax.devices()`` then reflects the
    global device set (SURVEY.md §7 "Failure detection" minimum).
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
