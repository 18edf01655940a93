"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-card hardware is unavailable in CI; all sharding logic is exercised
on ``--xla_force_host_platform_device_count=8`` per SURVEY.md §6.4.  This
must run before the first ``import jax`` anywhere in the test process.
The CPU is the default; ``JAX_PLATFORMS=cuda`` selects the card for the
tests marked ``gpu`` (``python -m pytest -m gpu tests/``).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest

from jlm.config import Config
from jlm.data import (
    Lexicon,
    build_vocab,
    encode_corpus,
    generate_corpus,
    generate_test_set,
    split_corpus,
)
from jlm.models.params import init_params


TINY = Config(
    vocab_size=256,
    embed_size=32,
    hidden_size=64,
    num_layers=1,
    beam_width=4,
    max_kana_len=30,
    max_nodes_per_frame=16,
    max_lookahead=48,
    batch_size=4,
    num_steps=8,
    seed=42,
)


@pytest.fixture(scope="session")
def tiny_config() -> Config:
    return TINY


@pytest.fixture(scope="session")
def corpus_lines():
    return generate_corpus(n_sentences=800, seed=1234)


@pytest.fixture(scope="session")
def vocab(corpus_lines, tiny_config):
    return build_vocab(corpus_lines, tiny_config.vocab_size)


@pytest.fixture(scope="session")
def lexicon(vocab):
    return Lexicon.from_vocab(vocab)


@pytest.fixture(scope="session")
def encoded(corpus_lines, vocab):
    ids = encode_corpus(corpus_lines, vocab)
    return split_corpus(ids)


@pytest.fixture(scope="session")
def tiny_params(tiny_config):
    return init_params(tiny_config)


@pytest.fixture(scope="session")
def test_sentences():
    return generate_test_set(n_sentences=12, seed=777)
