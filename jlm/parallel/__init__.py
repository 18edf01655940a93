"""Parallelism layer: device mesh, vocab sharding, multi-host bootstrap.

The reference has NO parallelism (SURVEY.md §3.3); this layer is the
build's [NORM] distributed dimension:

- ``vocab`` mesh axis — tensor parallelism over the large output
  vocabulary (D-softmax blocks / full head columns), with per-shard
  candidate logits exchanged via XLA collectives so the beam stays
  globally consistent;
- ``data`` mesh axis — independent lattice streams / training batch rows;
- collectives are XLA's, handed to NCCL (NVLink between the cards of a
  host, the network across hosts); multi-host bootstrap is
  ``jax.distributed.initialize`` + one SPMD program.
"""

from jlm.parallel.mesh import make_mesh, multihost_init  # noqa: F401
from jlm.parallel.sharded_head import (  # noqa: F401
    make_sharded_forward,
    param_shardings,
    shard_params,
    sharded_topk,
    vocab_parallel_nll,
)
