"""Real spherical harmonics for shell initial conditions and analysis.

Equivalent of the reference's TerraNeo spherical-harmonics
helpers (reference: src/terraneo/sphericalharmonics/ — used to seed the
initial temperature perturbation and to analyse radial shells). Fully
orthonormalized real harmonics

    Y_{l,0}   = N_{l,0} P_l^0(cos th)
    Y_{l,m}^c = sqrt(2) N_{l,m} P_l^m(cos th) cos(m ph)   m > 0
    Y_{l,m}^s = sqrt(2) N_{l,m} P_l^m(cos th) sin(m ph)   m > 0

evaluated with the stable three-term Legendre recurrence. The (l, m) loop
is static Python (unrolled at trace time) so evaluation jits into fused
elementwise XLA ops over arbitrary coordinate arrays."""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np


def num_coeffs(lmax: int) -> int:
    return (lmax + 1) ** 2


def sh_index(l: int, m: int) -> int:
    """Flat index of (l, m): m in [-l, l]; negative m = sine harmonics."""
    return l * l + l + m


@functools.lru_cache(maxsize=None)
def _norms(lmax: int) -> np.ndarray:
    """N_{l,m} = sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!) via log-gamma."""
    out = np.zeros((lmax + 1, lmax + 1))
    for l in range(lmax + 1):
        for m in range(l + 1):
            logn = 0.5 * (math.log(2 * l + 1) - math.log(4 * math.pi)
                          + math.lgamma(l - m + 1) - math.lgamma(l + m + 1))
            out[l, m] = math.exp(logn)
    return out


def sh_basis(lmax: int, xyz) -> jnp.ndarray:
    """(..., 3) unit-sphere directions -> (..., (lmax+1)^2) real harmonics.

    Input need not be normalized (it is projected to the unit sphere)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = jnp.sqrt(x * x + y * y + z * z)
    r = jnp.where(r == 0, 1.0, r)
    c = z / r                       # cos(theta)
    rho = jnp.sqrt(jnp.maximum(x * x + y * y, 0.0)) / r  # sin(theta)
    phi = jnp.arctan2(y, x)
    N = _norms(lmax)
    # P[m][l] built by recurrence
    out = [None] * num_coeffs(lmax)
    Pmm = jnp.ones_like(c)
    for m in range(lmax + 1):
        if m > 0:
            Pmm = Pmm * (-(2 * m - 1)) * rho
        Plm_prev, Plm = None, Pmm
        cmphi = jnp.cos(m * phi)
        smphi = jnp.sin(m * phi)
        for l in range(m, lmax + 1):
            if l > m:
                if l == m + 1:
                    Pnew = (2 * m + 1) * c * Pmm
                else:
                    Pnew = ((2 * l - 1) * c * Plm
                            - (l + m - 1) * Plm_prev) / (l - m)
                Plm_prev, Plm = Plm, Pnew
            base = N[l, m] * Plm
            if m == 0:
                out[sh_index(l, 0)] = base
            else:
                s2 = math.sqrt(2.0)
                out[sh_index(l, m)] = s2 * base * cmphi
                out[sh_index(l, -m)] = s2 * base * smphi
    return jnp.stack(out, axis=-1)


def sh_synthesis(coeffs, lmax: int, xyz) -> jnp.ndarray:
    """f(x) = sum_i coeffs_i Y_i(x)."""
    Y = sh_basis(lmax, xyz)
    return jnp.sum(Y * jnp.asarray(coeffs), axis=-1)


def sh_analysis_weighted(f, weights, lmax: int, xyz) -> jnp.ndarray:
    """Discrete forward transform: c_i ~ sum_k w_k f_k Y_i(x_k), with w a
    surface quadrature weight (sums to 4 pi on a full sphere). Used for the
    reference-style radial-shell analysis of a DoF field."""
    Y = sh_basis(lmax, xyz)
    return jnp.sum(weights[..., None] * f[..., None] * Y,
                   axis=tuple(range(f.ndim)))


def temperature_perturbation(lmax: int, coeffs, rmin: float, rmax: float,
                             amplitude: float = 0.1):
    """Reference-style initial condition: background conductive profile plus
    SH perturbation damped to zero at both shell boundaries
    (reference: TerraNeo initial temperature setup)."""
    coeffs = jnp.asarray(coeffs)

    def ic(x):
        r = jnp.sqrt(jnp.sum(x * x, axis=-1))
        r = jnp.clip(r, rmin, rmax)
        s = (r - rmin) / (rmax - rmin)
        background = 1.0 - s
        damp = jnp.sin(jnp.pi * s)
        pert = sh_synthesis(coeffs, lmax, x)
        return background + amplitude * damp * pert

    return ic
