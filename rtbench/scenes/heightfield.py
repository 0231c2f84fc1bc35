"""A displaced heightfield: an n x n vertex grid over [-1, 1]^2 whose
height is a sum of random-phase sinusoid octaves, 2 (n - 1)^2 triangles
of varied orientation (fine detail and a deep tree, as a scanned mesh
has), vertex normals from central differences.

``build(cfg)`` reads ``n``, ``seed`` (the octaves' frequencies and
phases), ``octaves``, ``amplitude``, ``height_scale``, ``frequency``
(the range of the first octave's two frequencies), ``material`` and
``lights``.
"""

from __future__ import annotations

import numpy as np


def build(cfg: dict) -> dict:
    n = int(cfg["n"])
    rng = np.random.default_rng(int(cfg["seed"]))
    xs = np.linspace(-1.0, 1.0, n)
    zs = np.linspace(-1.0, 1.0, n)
    x, z = np.meshgrid(xs, zs, indexing="ij")
    y = np.zeros_like(x)
    lo, hi = cfg["frequency"]
    for octave in range(int(cfg["octaves"])):
        f = 2.0 ** octave
        ax, az = rng.uniform(lo, hi, 2) * f
        px, pz = rng.uniform(0, 2 * np.pi, 2)
        y += (cfg["amplitude"] / f) * np.sin(ax * x + px) * np.cos(az * z + pz)
    hs = cfg["height_scale"]
    positions = np.stack([x, hs * y, z], axis=-1).reshape(-1, 3)
    dy_dx = np.gradient(hs * y, xs, axis=0)
    dy_dz = np.gradient(hs * y, zs, axis=1)
    nrm = np.stack([-dy_dx, np.ones_like(y), -dy_dz], axis=-1).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    idx = np.arange(n * n).reshape(n, n)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()
    tris = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)])
    mat = cfg["material"]
    return {"meshes": [{"positions": positions, "normals": nrm,
                        "indices": tris.astype(np.int64), "material": 0}],
            "spheres": [],
            "materials": [dict(mat, name="surface")],
            "lights": list(cfg["lights"])}
