"""Contracts that only the card can check; they skip elsewhere.

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_u8_sampling_bit_exact_on_card(gpu):
    """The barriered Newton dequantize survives the GPU compiler
    (interp._dequantize_rows)."""
    from bench import check_u8_bit_exact

    assert check_u8_bit_exact()


def test_color_contraction_is_full_f32_on_card(gpu):
    """radiance_to_rgb's contractions run at full f32 precision: TF32
    (10-bit mantissa) would miss this bound by ~100x."""
    import jax.numpy as jnp

    from vpt_tpu.models.mcm_spectral import radiance_to_rgb
    from vpt_tpu.ops.spectral import XYZ_TO_SRGB_KERNEL

    rng = np.random.default_rng(0)
    radiance = rng.uniform(size=(12, 64, 64)).astype(np.float32)
    bin_xyz = rng.uniform(size=(3, 12)).astype(np.float32)
    got = np.asarray(radiance_to_rgb(jnp.asarray(radiance),
                                     jnp.asarray(bin_xyz)))
    xyz = np.einsum("bhw,cb->hwc", radiance.astype(np.float64),
                    bin_xyz.astype(np.float64))
    want = xyz @ np.asarray(XYZ_TO_SRGB_KERNEL, np.float64).T
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
