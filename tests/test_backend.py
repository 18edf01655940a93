"""Platform selection, the compile cache, retired config keys, and the
chip smoke script's refusal to run without a GPU."""

import inspect
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from jlm import backend
from jlm.backend import enable_compile_cache, use_kernels
from jlm.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,precision,expected", [
    ("gpu", "default", True),
    ("gpu", "highest", False),
    ("cpu", "default", False),
    ("cpu", "highest", False),
])
def test_use_kernels_by_platform(platform, precision, expected):
    assert use_kernels(precision, platform) is expected


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_use_kernels_rejects_other_platforms(platform):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        use_kernels("default", platform)


def test_use_kernels_defaults_to_jax_backend():
    # the test process runs on the CPU: the plain path in both modes
    assert use_kernels("default") is False
    assert use_kernels("highest") is False


@pytest.mark.parametrize("entry", [
    "jlm.decoder.engine:make_pallas_forward",
    "jlm.parallel.sharded_head:make_sharded_forward",
    "jlm.decoder.incremental:IncrementalDecoder",
    "jlm.decoder.server:SessionServer",
])
def test_interpret_is_never_implied(entry):
    """Every entry that can run the kernel defaults to interpret=False."""
    import importlib

    mod, name = entry.split(":")
    fn = getattr(importlib.import_module(mod), name)
    assert inspect.signature(fn).parameters["interpret"].default is False


def test_kernel_without_interpret_does_not_run_on_cpu():
    """With interpret left at its default the Triton kernel is compiled for
    the device, which the CPU refuses — no silent interpreter fallback."""
    from jlm.ops.project import project_lse

    cfg = Config(vocab_size=64, hidden_size=16)
    head = {"W": jnp.ones((16, 64), jnp.float32),
            "b": jnp.zeros((64,), jnp.float32)}
    with pytest.raises(Exception):
        jax.block_until_ready(
            project_lse(jnp.ones((4, 16)), head, cfg,
                        compute_dtype=jnp.float32))


def test_compile_cache_uses_env_dir(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a), raising=False)
    path = enable_compile_cache({"JAX_COMPILATION_CACHE_DIR": "/x/cache"})
    assert path == "/x/cache"
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a), raising=False)
    path = enable_compile_cache({})
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert backend._REPO == REPO


def test_config_from_json_drops_retired_keys():
    """An old experiment's config.json still carries the switches of the
    removed fused-CE and Pallas-scan kernels; it must load."""
    d = json.loads(Config(vocab_size=300, hidden_size=32).to_json())
    d.update(fused_ce=True, use_pallas_scan=False)
    cfg = Config.from_json(json.dumps(d))
    assert cfg == Config(vocab_size=300, hidden_size=32)


def test_config_json_round_trip_dsoftmax():
    from jlm.config import default_dsoftmax_blocks

    cfg = Config(vocab_size=1000, hidden_size=64, head="dsoftmax",
                 dsoftmax=default_dsoftmax_blocks(1000, 64))
    assert Config.from_json(cfg.to_json()) == cfg


def _run_smoke(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_without_gpu():
    r = _run_smoke(REPO, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_refuses_outside_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
