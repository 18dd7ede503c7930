"""A constant-coefficient stencil from the configuration's taps: each
``[offset per axis..., gather coefficient]`` placed in the port's dense
coefficient array."""
from __future__ import annotations


def build(config: dict):
    """The port's ``StencilSpec`` of the configuration."""
    import numpy as np
    from repro_torch import api
    r, nd = int(config["order"]), int(config["ndim"])
    c = np.zeros((2 * r + 1,) * nd)
    for *offset, coeff in config["taps"]:
        c[tuple(int(o) + r for o in offset)] = float(coeff)
    return api.from_gather_coeffs(c, config["shape"])
