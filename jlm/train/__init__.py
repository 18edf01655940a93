"""Training layer: optax trainer, PPL eval, checkpointing (ref: JLM:train/)."""

from jlm.train.trainer import Trainer, train_lm  # noqa: F401
from jlm.train.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
