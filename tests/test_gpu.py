"""Tests that need an NVIDIA GPU: the head kernel compiled for the card.

They skip on the CPU.  On a machine with a card:
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jlm.config import Config
from jlm.ops.project import project_lse, project_lse_plain
from jlm.ops.quant import quantize_weight

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: the Triton kernel has no CPU "
                    "lowering outside interpret mode")


@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_mxu"])
@pytest.mark.parametrize("R,V", [(10, 50_000), (1000, 4099)])
def test_kernel_on_card_matches_reference(gpu, mode, R, V):
    rng = np.random.default_rng(R + V)
    H = 512
    cfg = Config(vocab_size=V, hidden_size=H)
    h = jnp.tanh(jnp.asarray(rng.normal(size=(R, H)), jnp.float32))
    w = rng.normal(size=(H, V)).astype(np.float32) * 0.05
    b = jnp.asarray(rng.normal(size=(V,)).astype(np.float32) * 0.01)
    if mode == "bf16":
        head = {"W": jnp.asarray(w, jnp.bfloat16), "b": b}
        ref_head = {"W": jnp.asarray(w), "b": b}
    else:
        q = quantize_weight(w, axis=0)
        head = ref_head = {"W": {"q": jnp.asarray(q["q"]),
                                 "scale": jnp.asarray(q["scale"])}, "b": b}
    lse = project_lse(h.astype(jnp.bfloat16), head, cfg,
                      int8_mxu=mode == "int8_mxu")
    ref = project_lse_plain(h, ref_head, cfg)
    tol = 0.05 if mode == "int8_mxu" else 3e-2
    np.testing.assert_allclose(np.asarray(lse), np.asarray(ref), atol=tol)


def test_speed_engine_on_card_matches_oracle(gpu, tiny_params, tiny_config,
                                             lexicon, vocab):
    from jlm.decoder.engine import BeamDecoder
    from jlm.oracle import OracleDecoder, OracleLM

    eng = BeamDecoder(tiny_params, lexicon, vocab, tiny_config,
                      precision="default")
    orc = OracleDecoder(OracleLM(tiny_params, tiny_config), lexicon, vocab,
                        tiny_config)
    for kana in ["きょうはいい", "あめがふる"]:
        r_e, r_o = eng.decode(kana)[0], orc.decode(kana)[0]
        assert r_e.segments == r_o.segments, kana
        assert abs(r_e.score - r_o.score) < 0.1
