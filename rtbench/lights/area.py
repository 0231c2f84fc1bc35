"""An area light: a one-sided rectangle at ``position`` spanned by
``dim_x`` and ``dim_y``, emitting ``radiance`` against ``direction``.

A light kind's file gives the port's class of it (``PORT_CLASS``, built
from the light's entries ``PORT_ARGS`` in that order), and the
reference's arithmetic: ``prepare(light, f)`` (its tables, ``f`` makes a
tensor of the reference's type), ``sample(tables, pt, u)`` (the sampled
radiance over its pdf, the direction to it and its distance, inf where
it has none) and, for a light that rays which miss every primitive see
(an environment), ``escaped(tables, d)``.  The reference imports torch
only here.
"""

import numpy as np
import torch

PORT_CLASS = "AreaLight"
PORT_ARGS = ("radiance", "position", "direction", "dim_x", "dim_y")


def prepare(light, f):
    dx = np.asarray(light["dim_x"], float)
    dy = np.asarray(light["dim_y"], float)
    return dict(rad=f(light["radiance"]), pos=f(light["position"]),
                dir=f(light["direction"]), dx=f(dx), dy=f(dy),
                area=float(np.linalg.norm(dx) * np.linalg.norm(dy)))


def sample(t, pt, u):
    lpt = t["pos"] + (u[:, 0:1] - 0.5) * t["dx"] + (u[:, 1:2] - 0.5) * t["dy"]
    dvec = lpt - pt
    cos_theta = (dvec * t["dir"]).sum(-1)
    sq = torch.clamp_min((dvec * dvec).sum(-1), 1e-12)
    dist = torch.sqrt(sq)
    wi = dvec / dist[:, None]
    pdf = sq / (t["area"] * torch.clamp_min(cos_theta.abs(), 1e-8))
    le = torch.where((cos_theta < 0)[:, None], t["rad"], 0.0)
    return le / pdf[:, None], wi, dist
