"""vpt_tpu — a differentiable spectral volume path-tracing framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of UL-FRI-LGM/VPT
(spectral-volume-rendering branch): progressive volumetric path tracing
(Woodcock/delta tracking, Henyey-Greenstein scattering, hero-wavelength binned
spectral transport with CIE-XYZ integration), plus the surrounding framework —
volume I/O, scene/camera model, transfer functions, tone mapping, progressive
render sessions, multi-chip sharding, and differentiable inverse rendering.

Reference behavioral spec: /root/reference (see SURVEY.md). This is not a port:
the compute path is jit-compiled XLA megakernels over lane-masked ray state
(Pallas variants were measured and rejected — ARCHITECTURE.md records the
numbers), scaled across a ``jax.sharding.Mesh`` instead of per-pixel GPU
threads.
"""

__version__ = "0.1.0"

from vpt_tpu.scene.volume import Volume  # noqa: F401
from vpt_tpu.scene.camera import Camera  # noqa: F401
from vpt_tpu.utils.config import (  # noqa: F401
    SpectrumConfig,
    LightConfig,
    MCMSpectralConfig,
)
