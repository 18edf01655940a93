"""JAX model core: LSTM LM pytrees and output heads (ref: JLM:train/lm.py)."""

from jlm.models.params import init_params, param_spec  # noqa: F401
