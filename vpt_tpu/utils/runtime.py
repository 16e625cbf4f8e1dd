"""Process set-up shared by the command-line entry points: the persistent
compile cache, the GPU requirement of measurement paths, and the card's
own report of its name and power limit.

Nothing here runs at import; each entry point calls what it needs before
its first compile.
"""

from __future__ import annotations

import os
import subprocess

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Fixed so that every run of this checkout finds the programs the last one
# compiled: the path is part of the cache key, so a temp-, PID- or
# time-based directory would never hit. Listed in .gitignore.
DEFAULT_COMPILE_CACHE_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def compile_cache_dir() -> tuple[str, bool]:
    """(directory, from_env): where JAX's persistent compile cache lives.
    ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself);
    otherwise the fixed ``.jax_cache/`` of this checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env, True
    return DEFAULT_COMPILE_CACHE_DIR, False


def init_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``compile_cache_dir()``.
    Call before the first compile. Sets nothing when the environment
    already names a directory. Returns the directory in use."""
    import jax

    path, from_env = compile_cache_dir()
    if not from_env:
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The local devices, or SystemExit when JAX's default backend is not a
    GPU. Measurement paths call this instead of falling back to the CPU:
    a CPU time is never a device metric."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX's default backend is "
            f"{devices[0].platform!r} ({devices[0].device_kind}); this "
            f"measures an NVIDIA GPU and does not fall back")
    return devices


def card_label() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reports them.
    Runs nvidia-smi in a child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def device_record(devices) -> dict:
    """The device fields every result line carries."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
