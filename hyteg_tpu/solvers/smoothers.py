"""Point smoothers: weighted Jacobi and Chebyshev (+ spectral estimation).

Reference: src/hyteg/solvers/WeightedJacobiSmoother.hpp,
ChebyshevSmoother.hpp:558-717 and
src/hyteg/solvers/numerictools/SpectrumEstimation.hpp:56.

Sequential Gauss-Seidel/SOR do not map to data-parallel hardware; the
smoothing path is Chebyshev-accelerated Jacobi (same choice the reference recommends
at scale). Colored Gauss-Seidel can be added for parity via per-class masked
sweeps.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def jacobi_smooth(
    apply_fn: Callable,
    inv_diag: jnp.ndarray,
    b: jnp.ndarray,
    x: jnp.ndarray,
    omega: float = 2.0 / 3.0,
    num_sweeps: int = 1,
) -> jnp.ndarray:
    """x <- x + omega D^{-1} (b - A x), on the rows apply_fn acts on."""

    def body(_, x):
        return x + omega * inv_diag * (b - apply_fn(x))

    return jax.lax.fori_loop(0, num_sweeps, body, x)


def estimate_spectral_radius(
    apply_fn: Callable,
    inv_diag: jnp.ndarray,
    dot_fn: Callable,
    shape,
    num_iter: int = 20,
    seed: int = 42,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Largest eigenvalue of D^{-1} A by power iteration on random init
    (reference: estimateSpectralRadiusWithPowerIteration)."""
    key = jax.random.PRNGKey(seed)
    x = jax.random.uniform(key, shape, dtype=dtype, minval=-1.0, maxval=1.0)
    # restrict to the operator's row space
    x = inv_diag * apply_fn(x)

    def body(_, state):
        x, _ = state
        nrm = jnp.sqrt(dot_fn(x, x))
        x = x / jnp.where(nrm == 0, 1.0, nrm)
        y = inv_diag * apply_fn(x)
        lam = dot_fn(x, y)
        return y, lam

    _, lam = jax.lax.fori_loop(0, num_iter, body, (x, jnp.asarray(0.0, dtype)))
    return lam


def p1_stencil_eig_fourier(stencil, dim: int, samples: int = 64) -> float:
    """Host-side upper bound for lambda_max(D^-1 A) of a per-cell-constant
    P1 stencil operator: the max over cells of the interior stencil's
    periodic symbol  sum_d W_d cos(d.theta) / W_0  (eigenvector
    interlacing majorizes the Dirichlet spectrum per cell; interfaces
    average adjacent cells' symbols and stay below the max). Replaces a
    per-level on-device power iteration, which costs one compile per
    level of the GMG stack."""
    import numpy as np

    from ..indexing import micro

    W = np.asarray(stencil, dtype=np.float64).sum(-1)  # (C, n_s)
    dirs = np.asarray(micro.stencil_directions(dim), dtype=np.float64)
    center = int(np.where(~dirs.any(axis=1))[0][0])
    th = np.linspace(0.0, np.pi, samples)
    grids = np.meshgrid(*([th] * dim), indexing="ij")
    tg = np.stack(grids, axis=-1).reshape(-1, dim)  # (S, dim)
    cos = np.cos(tg @ dirs.T)  # (S, n_s)
    lam = cos @ W.T  # (S, C)
    w0 = W[:, center]
    good = w0 > 0
    return float((lam[:, good].max(axis=0) / w0[good]).max())


def chebyshev_smooth(
    apply_fn: Callable,
    inv_diag: jnp.ndarray,
    b: jnp.ndarray,
    x: jnp.ndarray,
    eig_max: jnp.ndarray | float,
    order: int = 3,
    lower_factor: float = 0.3,
    upper_factor: float = 1.1,
) -> jnp.ndarray:
    """Chebyshev polynomial smoother of given order on the D^{-1}A-spectrum
    interval [lower_factor, upper_factor] * eig_max."""
    lmin = lower_factor * eig_max
    lmax = upper_factor * eig_max
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    r = inv_diag * (b - apply_fn(x))
    d = r / theta
    x = x + d
    rho = 1.0 / sigma

    # scan the three-term recurrence (carrying the scalar rho) so the
    # XLA graph holds ONE apply instead of ``order`` — compile time of
    # every GMG stack scales with the number of inlined applies
    def body(carry, _):
        x, d, rho = carry
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = inv_diag * (b - apply_fn(x))
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        return (x + d, d, rho_new), None

    (x, _, _), _ = jax.lax.scan(
        body, (x, d, jnp.asarray(rho, x.dtype)), None, length=order - 1)
    return x
