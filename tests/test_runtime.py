"""Process set-up: compile-cache placement, the GPU requirement of the
measurement paths, and the tape-memory rule of the window backward."""

import os

import jax
import pytest

from vpt_tpu.kernels import spectral_backward as SB
from vpt_tpu.utils import runtime


class _Device:
    def __init__(self, platform="cpu", stats=None):
        self.platform = platform
        self.device_kind = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_require_gpu_refuses_cpu(monkeypatch):
    monkeypatch.setattr(jax, "devices", lambda *a: [_Device("cpu")])
    with pytest.raises(SystemExit, match="no GPU found"):
        runtime.require_gpu()


@pytest.mark.parametrize("env", [None, "/var/cache/jax-programs"])
def test_compile_cache_placement(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    before = jax.config.jax_compilation_cache_dir
    try:
        used = runtime.init_compile_cache()
        if env is None:
            # a fixed directory of this checkout, ignored by git
            assert used == runtime.DEFAULT_COMPILE_CACHE_DIR
            assert jax.config.jax_compilation_cache_dir == used
            root = os.path.dirname(used)
            assert os.path.isfile(os.path.join(root, "pyproject.toml"))
            with open(os.path.join(root, ".gitignore")) as f:
                assert ".jax_cache/" in f.read().split()
        else:
            # JAX reads the variable itself: nothing else is set
            assert used == env
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("stats,want", [
    (None, SB._TAPE_LIMIT_UNREPORTED_BYTES),
    ({}, SB._TAPE_LIMIT_UNREPORTED_BYTES),
    ({"bytes_limit": 60 * 1024**3}, 15 * 1024**3),
])
def test_tape_limit_follows_device_memory(stats, want):
    assert SB._tape_auto_limit_bytes(_Device(stats=stats)) == want
