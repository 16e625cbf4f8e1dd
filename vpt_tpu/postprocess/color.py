"""Color-space conversions — the reference's GLSL color mixins as jnp ops.

Parity targets (GLSL mat3 constructors are column-major; the matrices below
are the equivalent row-major math):
  - rgb<->xyz, xyz<->xyY: /root/reference/src/glsl/mixins/XYZITU2002.glsl
  - rgb<->yuv BT.601:     .../YUVBT601.glsl
  - rgb<->yuv BT.709:     .../YUVBT709.glsl
  - hue ramp:             .../hue.glsl
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# GLSL mat3(c0, c1, c2) lists columns; transposed here into row-major.
RGB2XYZ = np.array([
    [0.412453, 0.357580, 0.180423],
    [0.212671, 0.715160, 0.072169],
    [0.019334, 0.119193, 0.950227],
], np.float32)

XYZ2RGB = np.array([
    [3.240481, -1.537152, -0.498536],
    [-0.969255, 1.875990, 0.041556],
    [0.055647, -0.204041, 1.057311],
], np.float32)

RGB2YUV_BT601 = np.array([
    [0.29900, 0.58700, 0.11400],
    [-0.14713, -0.28886, 0.43600],
    [0.61500, -0.51499, -0.10001],
], np.float32)

YUV2RGB_BT601 = np.array([
    [1.0, 0.0, 1.13983],
    [1.0, -0.39465, -0.58060],
    [1.0, 2.03211, 0.0],
], np.float32)

RGB2YUV_BT709 = np.array([
    [0.21260, 0.71520, 0.07220],
    [-0.09991, -0.33609, 0.43600],
    [0.61500, -0.55861, -0.05639],
], np.float32)

YUV2RGB_BT709 = np.array([
    [1.0, 0.0, 1.28033],
    [1.0, -0.21482, -0.38059],
    [1.0, 2.12798, 0.0],
], np.float32)


def _apply(m, v):
    return jnp.matmul(v, jnp.asarray(m).T,
                      precision=jax.lax.Precision.HIGHEST)


def rgb2xyz(rgb):
    return _apply(RGB2XYZ, rgb)


def xyz2rgb(xyz):
    return _apply(XYZ2RGB, xyz)


def xyz2xyY(xyz):
    s = xyz[..., 0] + xyz[..., 1] + xyz[..., 2]
    return jnp.stack([xyz[..., 0] / s, xyz[..., 1] / s, xyz[..., 1]], axis=-1)


def xyY2xyz(xyY):
    x, y, Y = xyY[..., 0], xyY[..., 1], xyY[..., 2]
    scale = Y / y
    return jnp.stack([x * scale, y * scale, (1.0 - x - y) * scale], axis=-1)


def rgb2yuv(rgb, standard: str = "bt601"):
    return _apply(RGB2YUV_BT601 if standard == "bt601" else RGB2YUV_BT709, rgb)


def yuv2rgb(yuv, standard: str = "bt601"):
    return _apply(YUV2RGB_BT601 if standard == "bt601" else YUV2RGB_BT709, yuv)


def _smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def hue(x):
    """The hue color ramp (hue.glsl) -> (..., 4) RGBA."""
    p = 1.0 / 6.0
    r = _smoothstep(1 * p, 2 * p, x) - _smoothstep(4 * p, 5 * p, x)
    g = _smoothstep(0 * p, 1 * p, x) - _smoothstep(3 * p, 4 * p, x)
    b = _smoothstep(2 * p, 3 * p, x) - _smoothstep(5 * p, 6 * p, x)
    return jnp.stack([1.0 - r, g, b, jnp.ones_like(x)], axis=-1)
