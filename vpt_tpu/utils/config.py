"""Typed config system — this build's equivalent of the reference's
property-metadata + auto-UI layer (PropertyBag.js + registerProperties +
DialogConstructor). Each renderer config is a frozen dataclass whose fields
carry the same name/min/max/default metadata; the reference's
"reset()-on-any-change" contract becomes "configs are immutable — a new
config object invalidates the accumulator state" (see session.py).

Parity targets:
  - property registration: WebGPUMCMSpectralComputeRenderer.js:19-73
  - spectrum representation: ui/SpectrumRepresentation.js:65-89
    (exponential arrange(k): x = (exp(k t) - 1)/(exp(k) - 1), 400 + 300x nm)
  - material TF painting: ui/MaterialTransferFunction.js:22,61-73
  - light editor: ui/LightEditor.js:16-25
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


def _meta(label, *, minimum=None, maximum=None, widget="spinner"):
    return {"label": label, "min": minimum, "max": maximum, "widget": widget}


def property_metadata(cls):
    """Expose dataclass fields as the reference's property-metadata list."""
    out = []
    for f in dataclasses.fields(cls):
        m = dict(f.metadata) if f.metadata else {}
        out.append(
            {
                "name": f.name,
                "label": m.get("label", f.name),
                "type": m.get("widget", "spinner"),
                "value": None if f.default is dataclasses.MISSING else f.default,
                "min": m.get("min"),
                "max": m.get("max"),
            }
        )
    return out


# --------------------------------------------------------------------------
# Spectrum representation
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class SpectrumConfig:
    """Wavelength bin boundaries for the binned spectral estimator."""

    boundaries: Tuple[float, ...] = tuple(400.0 + 25.0 * i for i in range(13))

    def __post_init__(self):
        assert len(self.boundaries) >= 2
        assert list(self.boundaries) == sorted(self.boundaries)

    @property
    def n_bins(self) -> int:
        return len(self.boundaries) - 1

    @property
    def min_wavelength(self) -> float:
        return self.boundaries[0]

    @property
    def max_wavelength(self) -> float:
        return self.boundaries[-1]

    @staticmethod
    def uniform(n_bins: int = 12, lo: float = 400.0, hi: float = 700.0) -> "SpectrumConfig":
        return SpectrumConfig(tuple(np.linspace(lo, hi, n_bins + 1).tolist()))

    @staticmethod
    def exponential(n_bins: int, k: float, lo: float = 400.0, hi: float = 700.0) -> "SpectrumConfig":
        """The UI's arrange(k) spacing: x = (exp(k t)-1)/(exp(k)-1)."""
        t = np.linspace(0.0, 1.0, n_bins + 1)
        x = t if k == 0 else (np.exp(k * t) - 1.0) / (np.exp(k) - 1.0)
        # the UI rounds marker wavelengths to whole nm
        return SpectrumConfig(tuple(np.round(lo + x * (hi - lo)).tolist()))

    def representation_buffer(self, max_len: int = 64) -> np.ndarray:
        from vpt_tpu.ops.spectral import spectrum_representation_buffer

        return spectrum_representation_buffer(np.array(self.boundaries), max_len)


# --------------------------------------------------------------------------
# Light
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class LightConfig:
    """Directional (or isotropic) light with a 256-entry spectral power
    distribution in [0,1] (the editor's uint8 curve / 255)."""

    direction: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    spectrum: Tuple[float, ...] = tuple([100.0 / 255.0] * 256)

    def spectrum_array(self) -> np.ndarray:
        return np.asarray(self.spectrum, np.float32)

    @staticmethod
    def from_uint8(direction, spectrum_u8) -> "LightConfig":
        return LightConfig(tuple(direction), tuple((np.asarray(spectrum_u8) / 255.0).tolist()))


# --------------------------------------------------------------------------
# Material transfer function
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class MaterialTF:
    """2D material transfer function: rows=density, cols=wavelength,
    channels=(albedo, alpha, anisotropy_raw, unused), values in [0,1].

    anisotropy_raw maps to g via g = raw*2 - 1 inside the kernel
    (MCMSpectralComputeRenderer.wgsl:130).
    """

    table: np.ndarray = field(
        default_factory=lambda: np.zeros((256, 256, 4), np.float32)
    )

    def __post_init__(self):
        assert self.table.shape[-1] == 4
        # frozen dataclass with ndarray: freeze content too
        self.table.setflags(write=False)

    def __hash__(self):
        return hash(self.table.tobytes())

    def __eq__(self, other):
        return isinstance(other, MaterialTF) and np.array_equal(self.table, other.table)

    @staticmethod
    def from_uint8(table_u8: np.ndarray) -> "MaterialTF":
        return MaterialTF((np.asarray(table_u8, np.float32) / 255.0).reshape(256, 256, 4))

    @staticmethod
    def from_materials(materials, size: int = 256) -> "MaterialTF":
        """Paint per-density-row material spectra (MaterialTransferFunction.js
        :61-73): each material owns a density row range [lo, hi) and supplies
        256-wide albedo/alpha/anisotropy curves in [0,1]."""
        table = np.zeros((size, size, 4), np.float32)
        for m in materials:
            lo = int(round(m["density_lo"] * (size - 1)))
            hi = int(round(m["density_hi"] * (size - 1))) + 1
            table[lo:hi, :, 0] = np.asarray(m["albedo"], np.float32)
            table[lo:hi, :, 1] = np.asarray(m["alpha"], np.float32)
            table[lo:hi, :, 2] = np.asarray(m.get("anisotropy", np.full(size, 0.5)), np.float32)
        return MaterialTF(table)

    @staticmethod
    def constant(albedo: float, alpha: float, anisotropy_g: float = 0.0,
                 density_lo: float = 0.0, density_hi: float = 1.0, size: int = 256) -> "MaterialTF":
        """Uniform material over a density range; g given in [-1,1]."""
        raw = (anisotropy_g + 1.0) / 2.0
        return MaterialTF.from_materials(
            [
                {
                    "density_lo": density_lo,
                    "density_hi": density_hi,
                    "albedo": np.full(size, albedo),
                    "alpha": np.full(size, alpha),
                    "anisotropy": np.full(size, raw),
                }
            ],
            size=size,
        )


# --------------------------------------------------------------------------
# Renderer configs
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class MCMSpectralConfig:
    """North-star renderer config (WebGPUMCMSpectralComputeRenderer.js:19-73)."""

    extinction: float = field(default=1.0, metadata=_meta("Extinction", minimum=0))
    anisotropy: float = field(
        default=0.0, metadata=_meta("Anisotropy", minimum=-1, maximum=1, widget="slider")
    )
    bounces: int = field(default=8, metadata=_meta("Max bounces", minimum=0))
    steps: int = field(default=8, metadata=_meta("Steps", minimum=0))
    blur: float = 0.0  # depth-of-field disk radius


@dataclass(frozen=True)
class MCMConfig:
    """RGB multiple-scattering config (WebGPUMCMComputeRenderer.js)."""

    extinction: float = field(default=1.0, metadata=_meta("Extinction", minimum=0))
    anisotropy: float = field(
        default=0.0, metadata=_meta("Anisotropy", minimum=-1, maximum=1, widget="slider")
    )
    bounces: int = field(default=8, metadata=_meta("Max bounces", minimum=0))
    steps: int = field(default=8, metadata=_meta("Steps", minimum=0))
    blur: float = 0.0


@dataclass(frozen=True)
class EAMConfig:
    """Emission-absorption config (WebGPUEAMRenderer.js / EAMRenderer.js)."""

    extinction: float = field(default=100.0, metadata=_meta("Extinction", minimum=0))
    slices: int = field(default=64, metadata=_meta("Slices", minimum=1))
    random_offset: bool = True


def to_json(cfg) -> str:
    def default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        raise TypeError(type(o))

    return json.dumps(dataclasses.asdict(cfg), default=default)
