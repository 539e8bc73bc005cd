"""Element-matrix forms for affine simplices.

Analog of the reference's form layer (reference: src/hyteg/forms/P1Form.hpp:
28-46 and the HOG-generated form files): a form maps physical element-vertex
coordinates to the local element matrix. Here forms are plain vectorized JAX
functions evaluated *inside* the operator setup (constant/affine path) or
apply (variable path) — replacing generated C++ with jnp einsums that XLA
fuses.

All forms take ``verts`` of shape (..., nv, dim) (nv = dim + 1 vertices,
physical coordinates) and return (..., nv, nv).
"""

from __future__ import annotations

import jax.numpy as jnp


def _jacobian(verts: jnp.ndarray) -> jnp.ndarray:
    """(..., dim, dim): columns are edge vectors v_i - v_0."""
    return jnp.swapaxes(verts[..., 1:, :] - verts[..., :1, :], -1, -2)


def det_small(J: jnp.ndarray) -> jnp.ndarray:
    """Closed-form determinant of batched 2x2 / 3x3 matrices.

    jnp.linalg.det/inv lower to a batched LU, a poor fit for ~1e6 tiny
    matrices; the adjugate formulas are plain elementwise arithmetic that
    fuses with its neighbours."""
    d = J.shape[-1]
    if d == 2:
        return (J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0])
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    p, q, r = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    u, v, w = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    return (a * (q * w - r * v) - b * (p * w - r * u)
            + c * (p * v - q * u))


def inv_small(J: jnp.ndarray) -> jnp.ndarray:
    """Closed-form (adjugate) inverse of batched 2x2 / 3x3 matrices."""
    d = J.shape[-1]
    det = det_small(J)
    idet = 1.0 / det
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, dd = J[..., 1, 0], J[..., 1, 1]
        rows = [[dd, -b], [-c, a]]
    else:
        a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
        p, q, r = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
        u, v, w = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
        rows = [
            [q * w - r * v, c * v - b * w, b * r - c * q],
            [r * u - p * w, a * w - c * u, c * p - a * r],
            [p * v - q * u, b * u - a * v, a * q - b * p],
        ]
    adj = jnp.stack([jnp.stack(rw, axis=-1) for rw in rows], axis=-2)
    return adj * idet[..., None, None]


def simplex_volume(verts: jnp.ndarray) -> jnp.ndarray:
    """Unsigned volume (area in 2D) of the simplices."""
    J = _jacobian(verts)
    dim = verts.shape[-1]
    factor = 6.0 if dim == 3 else 2.0
    return jnp.abs(det_small(J)) / factor


def p1_gradients(verts: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Physical gradients of the P1 basis: (..., nv, dim), and volumes.

    Reference gradients: hat_0 = -1 vector, hat_i = e_i; physical
    g = J^{-T} ghat.
    """
    J = _jacobian(verts)
    dim = verts.shape[-1]
    ghat = jnp.concatenate(
        [-jnp.ones((1, dim)), jnp.eye(dim)], axis=0
    )  # (nv, dim)
    Jinv = inv_small(J)
    g = jnp.einsum("ad,...de->...ae", ghat, Jinv)  # ghat @ J^{-1}
    vol = simplex_volume(verts)
    return g, vol


def laplace_form(verts: jnp.ndarray) -> jnp.ndarray:
    """Stiffness matrix of -div(grad u): vol * g g^T
    (reference form family: p1_diffusion)."""
    g, vol = p1_gradients(verts)
    return vol[..., None, None] * jnp.einsum("...ad,...bd->...ab", g, g)


def mass_form(verts: jnp.ndarray) -> jnp.ndarray:
    """Consistent P1 mass matrix: vol (1 + I) / 20 (3D) or / 12 (2D)
    (reference form family: p1_mass)."""
    dim = verts.shape[-1]
    nv = dim + 1
    denom = 20.0 if dim == 3 else 12.0
    base = (jnp.ones((nv, nv)) + jnp.eye(nv)) / denom
    vol = simplex_volume(verts)
    return vol[..., None, None] * base


def diffusion_plus_mass_form(kappa: float = 1.0, sigma: float = 1.0):
    """-kappa * Laplace + sigma * mass — the implicit-diffusion operator of
    reference UnsteadyDiffusion (src/hyteg/composites/UnsteadyDiffusion.hpp)."""

    def form(verts):
        return kappa * laplace_form(verts) + sigma * mass_form(verts)

    return form


def div_k_grad_form_factory():
    """Element matrix of -div(k grad u) with element-averaged coefficient:
    since P1 gradients are constant per element, elMat = (mean k) * laplace.
    The averaging happens in the variable-coefficient operator; this factory
    returns the geometric part."""
    return laplace_form
