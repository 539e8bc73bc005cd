"""Coefficient averaging schemes for variable-coefficient operators.

Analog of the reference's coefficient averaging for quadrature-free
variable-coefficient forms (reference:
src/hyteg/forms/CoefficientAveraging.hpp — ARITHMETIC / HARMONIC /
GEOMETRIC vertex averaging per element).  Each element's matrix is
scaled by the chosen mean of the coefficient values at its vertices.
"""

from __future__ import annotations

import jax.numpy as jnp

MODES = ("arithmetic", "harmonic", "geometric")


def coeff_average(reads, mode: str = "arithmetic"):
    """Mean of per-vertex coefficient reads (list of equal-shaped arrays).

    harmonic/geometric assume a positive coefficient (as the reference
    does); values are clamped away from zero for stability."""
    nv = len(reads)
    if mode == "arithmetic":
        s = reads[0]
        for r in reads[1:]:
            s = s + r
        return s / nv
    if mode == "harmonic":
        s = None
        for r in reads:
            t = 1.0 / jnp.maximum(r, 1e-30)
            s = t if s is None else s + t
        return nv / s
    if mode == "geometric":
        s = None
        for r in reads:
            t = jnp.log(jnp.maximum(r, 1e-30))
            s = t if s is None else s + t
        return jnp.exp(s / nv)
    raise ValueError(f"unknown averaging mode {mode!r} (use one of {MODES})")
