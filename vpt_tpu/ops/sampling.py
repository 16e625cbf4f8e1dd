"""Counter/hash RNG and sampling distributions (vectorized, lane-masked).

The reference advances a per-thread uint32 hash chain (PCG-style) and draws
a *data-dependent* number of uniforms per Woodcock step (branch divergence).
In a vectorized kernel every lane executes every branch, so this module
exposes *masked* draws: the chain advances only where ``mask`` is set, which
reproduces the sequential per-thread draw order bit-exactly while staying
fully vectorized.

The chain seed is a pure function of (global pixel x, global pixel y,
frame_seed) — mesh-shape independent by construction, which is the
reproducibility contract (renders are bit-identical across device meshes).

Parity targets:
  - pcg hash:           /root/reference/src/wgsl/mixins/random/hash/pcg.wgsl:3-7
  - squash-linear hash3: .../random/hash/squashlinear.wgsl (hash3)
  - uniform:            .../random/distribution/uniformdivision.wgsl:3-6
  - square/disk/sphere/exponential: .../random/distribution/*.wgsl
  - HG sampling:        /root/reference/src/wgsl/renderers/MCMSpectralComputeRenderer.wgsl:82-97
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

TWOPI = 6.28318530718
EPS = 1e-5

# f32(~0u) in WGSL: 4294967295 rounds to 2^32 as float32.
_INV_U32_MAX = np.float32(1.0) / np.float32(np.float64(0xFFFFFFFF))


def pcg_hash(x):
    """PCG-style avalanche hash on uint32 lanes."""
    x = x.astype(jnp.uint32)
    x = x * np.uint32(747796405) + np.uint32(2891336453)
    x = ((x >> ((x >> np.uint32(28)) + np.uint32(4))) ^ x) * np.uint32(277803737)
    return (x >> np.uint32(22)) ^ x


def hash3(x, y, z):
    """Squash-linear 3-component seed hash (uint32 lanes)."""
    x = x.astype(jnp.uint32)
    y = y.astype(jnp.uint32)
    z = z.astype(jnp.uint32)
    return pcg_hash(
        np.uint32(19) * x + np.uint32(47) * y + np.uint32(101) * z + np.uint32(131)
    )


def seed_state(ix, iy, frame_seed_bits):
    """Per-pixel chain seed: hash3(pixel_x, pixel_y, frame_seed_bits).

    ``frame_seed_bits`` is the uint32 bit pattern of the f32 frame seed
    (the reference bitcasts a float seed; we accept the bits directly)."""
    return hash3(ix, iy, jnp.broadcast_to(jnp.uint32(frame_seed_bits), jnp.shape(ix)))


def uniform_from_state(state):
    """Map a uint32 state to [0,1) the way WGSL's f32 division does."""
    return state.astype(jnp.float32) * _INV_U32_MAX


def draw(state, mask):
    """Advance the chain where ``mask``; return (new_state, uniform).

    Where mask is False the state is untouched and the returned uniform is
    garbage (callers must select it away)."""
    new = pcg_hash(state)
    state = jnp.where(mask, new, state)
    return state, uniform_from_state(state)


def draw_square(state, mask):
    """Two masked draws -> (state, (u, v)) uniform in the unit square."""
    state, x = draw(state, mask)
    state, y = draw(state, mask)
    return state, (x, y)


def draw_disk(state, mask):
    """Two masked draws -> (state, (x, y)) uniform on the unit disk (polar)."""
    state, u1 = draw(state, mask)
    state, u2 = draw(state, mask)
    radius = jnp.sqrt(u1)
    angle = np.float32(TWOPI) * u2
    return state, (radius * jnp.cos(angle), radius * jnp.sin(angle))


def draw_sphere(state, mask):
    """Marsaglia (1972) uniform direction: disk sample -> sphere point."""
    state, (dx, dy) = draw_disk(state, mask)
    norm = dx * dx + dy * dy
    radius = 2.0 * jnp.sqrt(jnp.maximum(1.0 - norm, 0.0))
    return state, (radius * dx, radius * dy, 1.0 - 2.0 * norm)


def draw_exponential(state, mask, rate):
    """Free-flight distance: -ln(u)/rate."""
    state, u = draw(state, mask)
    return state, -jnp.log(u) / rate


def draw_hg(state, mask, g, dx, dy, dz):
    """Henyey-Greenstein scattered direction about (dx,dy,dz) with per-lane g.

    Matches sampleHenyeyGreenstein: a uniform sphere direction is returned
    as-is where |g| < EPS (isotropic); otherwise it is bent so the deflection
    cosine follows the HG inversion. The cosine draw happens only on lanes
    where |g| >= EPS (draw-order parity with the branchy reference)."""
    state, (ux, uy, uz) = draw_sphere(state, mask)
    aniso = jnp.abs(g) >= EPS
    state, ucos = draw(state, mask & aniso)

    # double-where: evaluate the inversion with a safe g on isotropic lanes
    # so neither the primal nor the cotangent produces NaN there
    gs = jnp.where(aniso, g, 0.5)
    g2 = gs * gs
    c = (1.0 - g2) / (1.0 - gs + 2.0 * gs * ucos)
    hgcos = (1.0 + g2 - c * c) / (2.0 * gs)
    hgcos = jnp.where(aniso, hgcos, 0.0)

    udotd = ux * dx + uy * dy + uz * dz
    cx = ux - udotd * dx
    cy = uy - udotd * dy
    cz = uz - udotd * dz
    cn = jax_rsqrt_safe(cx * cx + cy * cy + cz * cz)
    s = jnp.sqrt(jnp.maximum(1.0 - hgcos * hgcos, 0.0))
    ox = s * cx * cn + hgcos * dx
    oy = s * cy * cn + hgcos * dy
    oz = s * cz * cn + hgcos * dz

    ox = jnp.where(aniso, ox, ux)
    oy = jnp.where(aniso, oy, uy)
    oz = jnp.where(aniso, oz, uz)
    return state, (ox, oy, oz)


def jax_rsqrt_safe(x):
    """1/sqrt(x) with 0-input guarded (degenerate tangent frame)."""
    return jnp.where(x > 0, 1.0 / jnp.sqrt(jnp.maximum(x, 1e-30)), 0.0)
