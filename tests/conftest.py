"""Test env: JAX on the CPU with 8 virtual devices, so unit and sharding
tests run anywhere. ``JAX_PLATFORMS`` is only defaulted, so the tests
marked ``gpu`` can select the card explicitly:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def small_scene():
    """A 32^3 sphere-in-cube scene with a simple material, shared by tests."""
    from vpt_tpu.scene.volume import Volume
    from vpt_tpu.utils.config import LightConfig, MaterialTF, SpectrumConfig

    volume = Volume.sphere_in_cube(32)
    material = MaterialTF.constant(albedo=0.8, alpha=0.9, anisotropy_g=0.3)
    light = LightConfig(direction=(1.0, 0.5, 0.2))
    spectrum = SpectrumConfig()
    return dict(volume=volume, material=material, light=light, spectrum=spectrum)


@pytest.fixture
def gpu():
    """The local GPU devices; skips the test when JAX's default backend is
    not a GPU (tests marked ``gpu`` run on the card only)."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run with JAX_PLATFORMS=cuda")
    return devices


@pytest.fixture(scope="session")
def native_lib():
    """Build libvptio from native/ (make -C native) for the parity tests;
    skips when no C++ toolchain can build it."""
    from vpt_tpu.scene import native_io

    if not native_io.build():
        pytest.skip("libvptio could not be built (make -C native)")
    return native_io
