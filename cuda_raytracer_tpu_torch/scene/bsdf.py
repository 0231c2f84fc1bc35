"""BSDF models.

Host-side BSDF classes mirroring the reference hierarchy
(src/bsdf.h:48-230) — Diffuse, Mirror, Refraction, Glass, Emission —
with the evaluation/sampling semantics the reference left as TODO stubs
(src/bsdf.cpp:41-123) implemented properly.  These run in numpy and are
used by the CPU oracle and by scene flattening; the device path uses the
flattened integer-tagged table (render/flatscene.py) evaluated inside
jitted shading ops (ops/shade.py).

Conventions follow the reference: all directions are in the local
shading frame with +z along the normal (src/bsdf.h:17-41); ``wo`` points
away from the surface toward the viewer, ``wi`` toward the light.
"""

from __future__ import annotations

import numpy as np

# Integer BSDF function tags used by the flattened device table.  The
# reference packs only {0: diffuse, 1: mirror} (CuBSDF.fn,
# src/cudaRenderer.h:135-140, populated at src/cudaRenderer.cu:1705-1720);
# we extend the table with the rest of the advertised surface.
BSDF_DIFFUSE = 0
BSDF_MIRROR = 1
BSDF_REFRACTION = 2
BSDF_GLASS = 3
BSDF_EMISSION = 4


def make_coord_space(n: np.ndarray) -> np.ndarray:
    """Orthonormal object-to-world basis with ``n`` as the z column
    (semantics of src/bsdf.cpp:14-33)."""
    z = n / np.linalg.norm(n)
    h = z.copy()
    if abs(z[0]) <= abs(z[1]) and abs(z[0]) <= abs(z[2]):
        h[0] = 1.0
    elif abs(z[1]) <= abs(z[0]) and abs(z[1]) <= abs(z[2]):
        h[1] = 1.0
    else:
        h[2] = 1.0
    y = np.cross(h, z)
    y /= np.linalg.norm(y)
    x = np.cross(z, y)
    x /= np.linalg.norm(x)
    return np.stack([x, y, z], axis=1)


def reflect(wo: np.ndarray) -> np.ndarray:
    """Mirror reflection about +z (src/bsdf.cpp:101-106 TODO, implemented)."""
    return np.array([-wo[0], -wo[1], wo[2]])


def refract(wo: np.ndarray, ior: float):
    """Snell refraction of ``wo`` about +z.  Returns (wi, ok); ok is False
    on total internal reflection (src/bsdf.cpp:108-123 TODO, implemented).

    When ``wo`` is in the upper hemisphere the ray enters the medium
    (eta = 1/ior), otherwise it exits (eta = ior).
    """
    entering = wo[2] > 0
    eta = (1.0 / ior) if entering else ior
    cos_o = abs(wo[2])
    sin2_t = eta * eta * max(0.0, 1.0 - cos_o * cos_o)
    if sin2_t >= 1.0:
        return np.array([0.0, 0.0, 0.0]), False
    cos_t = np.sqrt(1.0 - sin2_t)
    wi = np.array(
        [-eta * wo[0], -eta * wo[1], -cos_t if entering else cos_t]
    )
    return wi, True


def _fresnel_dielectric(cos_i: float, ior: float) -> float:
    """Unpolarized dielectric Fresnel reflectance."""
    cos_i = abs(cos_i)
    eta = ior
    sin2_t = (1.0 / (eta * eta)) * max(0.0, 1.0 - cos_i * cos_i)
    if sin2_t >= 1.0:
        return 1.0
    cos_t = np.sqrt(1.0 - sin2_t)
    r_par = (eta * cos_i - cos_t) / (eta * cos_i + cos_t)
    r_perp = (cos_i - eta * cos_t) / (cos_i + eta * cos_t)
    return 0.5 * (r_par * r_par + r_perp * r_perp)


class BSDF:
    """Abstract BSDF (src/bsdf.h:48-103)."""

    def f(self, wo: np.ndarray, wi: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def sample_f(self, wo: np.ndarray, rng: np.random.Generator):
        """Returns (f, wi, pdf)."""
        raise NotImplementedError

    def get_emission(self) -> np.ndarray:
        return np.zeros(3)

    def is_delta(self) -> bool:
        raise NotImplementedError


class DiffuseBSDF(BSDF):
    """Lambertian reflection (src/bsdf.h:108-124; f = albedo/pi as in
    src/bsdf.cpp:37-39)."""

    def __init__(self, albedo):
        self.albedo = np.asarray(albedo, dtype=np.float64)

    def f(self, wo, wi):
        return self.albedo / np.pi

    def sample_f(self, wo, rng):
        # Uniform-hemisphere sampling, pdf = 1/(2*pi) — matches the device
        # sampler (src/samplers.cu_inl:11-30 folded to +z at
        # src/cudaRenderer.cu:620-624).
        u1, u2 = rng.random(), rng.random()
        cos_t = abs(2.0 * u1 - 1.0)
        sin_t = np.sqrt(max(0.0, 1.0 - cos_t * cos_t))
        phi = 2.0 * np.pi * u2
        wi = np.array([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t])
        return self.f(wo, wi), wi, 1.0 / (2.0 * np.pi)

    def is_delta(self):
        return False


class MirrorBSDF(BSDF):
    """Perfect specular reflection (src/bsdf.h:127-146)."""

    def __init__(self, reflectance):
        self.reflectance = np.asarray(reflectance, dtype=np.float64)

    def f(self, wo, wi):
        return np.zeros(3)

    def sample_f(self, wo, rng):
        wi = reflect(wo)
        cos_t = max(abs(wi[2]), 1e-8)
        # delta BSDF: f/pdf convention gives throughput reflectance
        # (importance *= albedo, src/cudaRenderer.cu:652).
        return self.reflectance / cos_t, wi, 1.0

    def is_delta(self):
        return True


class RefractionBSDF(BSDF):
    """Pure refraction (src/bsdf.h:168-188)."""

    def __init__(self, transmittance, roughness, ior):
        self.transmittance = np.asarray(transmittance, dtype=np.float64)
        self.roughness = roughness
        self.ior = ior

    def f(self, wo, wi):
        return np.zeros(3)

    def sample_f(self, wo, rng):
        wi, ok = refract(wo, self.ior)
        if not ok:
            wi = reflect(wo)
        cos_t = max(abs(wi[2]), 1e-8)
        return self.transmittance / cos_t, wi, 1.0

    def is_delta(self):
        return True


class GlassBSDF(BSDF):
    """Fresnel-weighted reflection + refraction (src/bsdf.h:191-212)."""

    def __init__(self, transmittance, reflectance, roughness, ior):
        self.transmittance = np.asarray(transmittance, dtype=np.float64)
        self.reflectance = np.asarray(reflectance, dtype=np.float64)
        self.roughness = roughness
        self.ior = ior

    def f(self, wo, wi):
        return np.zeros(3)

    def sample_f(self, wo, rng):
        fr = _fresnel_dielectric(wo[2], self.ior)
        if rng.random() < fr:
            wi = reflect(wo)
            cos_t = max(abs(wi[2]), 1e-8)
            return fr * self.reflectance / cos_t, wi, fr
        wi, ok = refract(wo, self.ior)
        if not ok:  # total internal reflection
            wi = reflect(wo)
            cos_t = max(abs(wi[2]), 1e-8)
            return self.reflectance / cos_t, wi, 1.0
        cos_t = max(abs(wi[2]), 1e-8)
        # radiance scaling for refraction: eta^2 compression factor
        entering = wo[2] > 0
        eta = (1.0 / self.ior) if entering else self.ior
        return (1.0 - fr) * self.transmittance * (eta * eta) / cos_t, wi, 1.0 - fr

    def is_delta(self):
        return True


class EmissionBSDF(BSDF):
    """Emissive surface (src/bsdf.h:215-230)."""

    def __init__(self, radiance):
        self.radiance = np.asarray(radiance, dtype=np.float64)

    def f(self, wo, wi):
        return np.zeros(3)

    def sample_f(self, wo, rng):
        # Emitters scatter nothing in the reference pipeline.
        u1, u2 = rng.random(), rng.random()
        cos_t = abs(2.0 * u1 - 1.0)
        sin_t = np.sqrt(max(0.0, 1.0 - cos_t * cos_t))
        phi = 2.0 * np.pi * u2
        wi = np.array([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t])
        return np.zeros(3), wi, 1.0 / (2.0 * np.pi)

    def get_emission(self):
        return self.radiance

    def is_delta(self):
        return False
