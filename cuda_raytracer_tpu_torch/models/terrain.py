"""Procedural large scenes (dragon-class triangle counts, no .dae).

The reference benchmarks dragon/lucy/blob scenes at 200k-900k
primitives (media/pathtracer/reference_results/performance.txt:23-31);
none of those models ship in the media tree, so scale testing uses this
deterministic displaced-heightfield terrain instead: a (n x n) vertex
grid with layered sinusoidal displacement gives 2*(n-1)^2 triangles of
spatially-varied orientation — the same BVH shape class (fine surface
detail, deep tree) as a scanned model, at any requested size.
"""

from __future__ import annotations

import numpy as np

from ..scene import static_scene as st
from ..scene.bsdf import DiffuseBSDF


def terrain_scene(n: int = 500, seed: int = 7) -> st.Scene:
    """Displaced heightfield with 2*(n-1)^2 triangles, one area light.

    n=230 -> ~105k tris, n=500 -> ~498k tris, n=660 -> ~869k tris (the
    reference dragon's count).
    """
    rng = np.random.default_rng(seed)
    xs = np.linspace(-1.0, 1.0, n)
    zs = np.linspace(-1.0, 1.0, n)
    x, z = np.meshgrid(xs, zs, indexing="ij")
    y = np.zeros_like(x)
    # a few octaves of random-phase sinusoids: smooth but everywhere
    # curved, so triangle normals vary like a scanned surface
    for octave in range(5):
        f = 2.0 ** octave
        ax, az = rng.uniform(2.0, 4.0, 2) * f
        px, pz = rng.uniform(0, 2 * np.pi, 2)
        y += (0.25 / f) * np.sin(ax * x + px) * np.cos(az * z + pz)
    positions = np.stack([x, 0.3 * y, z], axis=-1).reshape(-1, 3)

    # analytic-ish vertex normals from central differences
    dy_dx = np.gradient(0.3 * y, xs, axis=0)
    dy_dz = np.gradient(0.3 * y, zs, axis=1)
    nrm = np.stack(
        [-dy_dx, np.ones_like(y), -dy_dz], axis=-1
    ).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)

    idx = np.arange(n * n).reshape(n, n)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[1:, 1:].ravel()
    d = idx[:-1, 1:].ravel()
    tris = np.concatenate(
        [np.stack([a, b, c], axis=1), np.stack([a, c, d], axis=1)]
    ).astype(np.int32)

    mesh = st.Mesh(positions, nrm, tris, DiffuseBSDF([0.7, 0.7, 0.7]))
    lights = [
        st.AreaLight(
            rad=np.array([8.0, 8.0, 8.0]),
            pos=np.array([0.0, 1.2, 0.0]),
            direction=np.array([0.0, -1.0, 0.0]),
            dim_x=np.array([0.5, 0.0, 0.0]),
            dim_y=np.array([0.0, 0.0, 0.4]),
        )
    ]
    return st.Scene([mesh], lights)
