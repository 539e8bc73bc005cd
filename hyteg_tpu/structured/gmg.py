"""Geometric multigrid on the structured box fast path.

The box analog of the reference's GeometricMultigridSolver
(reference: src/hyteg/solvers/GeometricMultigridSolver.hpp:141-204 —
pre-smooth, restrict, recurse, prolongate-add, post-smooth) with
Chebyshev smoothing (reference: src/hyteg/solvers/ChebyshevSmoother.hpp)
and a fixed-iteration CG coarse solve.  Everything jits whole: the
recursion unrolls over the static level list.

Dirichlet boundary: the eliminated form — boundary rows act as identity
(operator.apply_dirichlet), corrections are masked to the interior on
every level, so the homogeneous boundary of the error equation is exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..operators import forms
from . import transfer
from .box import BoxDomain
from .operator import BoxStencilOperator


def _dot(a, b):
    """f32 dot as an elementwise multiply and a reduction.  It never
    lowers to a dot_general, whose DEFAULT precision may round f32
    operands (TF32 on the GPU); CG step sizes computed from rounded dot
    products turn the coarse solve into an error amplifier."""
    return jnp.sum(a * b)


def _norm(a):
    return jnp.sqrt(_dot(a, a))


def eig_max_fourier(op: BoxStencilOperator, samples: int = 96) -> float:
    """Upper bound for lambda_max(D^-1 A) from the interior stencil symbol.

    The interior operator is a constant 15-point stencil; its periodic
    symbol  lam(theta) = sum_d w_d cos(d . theta) / w_0  majorizes the
    Dirichlet spectrum (eigenvector interlacing on the rectangular grid).
    Evaluated on a theta grid in microseconds, where a per-level
    on-device power iteration costs one compile per level.
    """
    import numpy as np

    from . import kuhn

    dirs = np.asarray(kuhn.stencil_dirs())
    # interior lane weight: any interior lane of the interior row class
    Y, Z = op.domain.dims[1], op.domain.dims[2]
    lane = (Y // 2) * Z + Z // 2
    w = np.asarray(op.w_vecs[0, :, lane], dtype=np.float64)  # (n_s,)
    center = [i for i, d in enumerate(dirs) if not d.any()]
    w0 = w[center[0]]
    th = np.linspace(0.0, np.pi, samples)
    tg = np.stack(np.meshgrid(th, th, th, indexing="ij"), axis=-1)
    lam = np.zeros(tg.shape[:-1])
    for i, d in enumerate(dirs):
        lam += w[i] * np.cos(tg @ d.astype(np.float64))
    return float(lam.max() / w0)


def estimate_eig_max(op: BoxStencilOperator, iters: int = 50) -> float:
    """Power iteration for lambda_max(D^-1 A) on the interior (concrete),
    as an eager host loop over a jitted body."""
    dom = op.domain
    inner = jnp.asarray(dom.interior_mask, dtype=dom.dtype)
    dinv = op.inverse_diagonal

    @jax.jit
    def body(x):
        y = inner * (dinv * op.apply_raw(inner * x))
        return y / _norm(y)

    @jax.jit
    def rayleigh(x):
        y = inner * (dinv * op.apply_raw(inner * x))
        return _dot(x, y)

    x = jnp.ones(dom.block_shape, dtype=dom.dtype)
    x = x / _norm(x)
    for _ in range(iters):
        x = body(x)
    return float(rayleigh(x))


@dataclass
class BoxLevel:
    domain: BoxDomain
    op: BoxStencilOperator
    eig_max: float

    @property
    def inner(self) -> jnp.ndarray:
        # built in-trace: an eager (X, L) mask would be captured as a
        # constant of the whole grid's size in every jit that uses it
        return self.domain.interior_mask_traced()


def build_hierarchy(domain: BoxDomain, form=forms.laplace_form,
                    min_level: int = 1) -> list[BoxLevel]:
    """Fine-to-coarse list of levels with operators + spectral bounds.

    lambda_max(D^-1 A) is estimated per level (the tet path does the
    same, solvers/templates.py) — it converges to its h->0 limit from
    below as the level grows, so a coarse probe plus a fixed margin is
    avoidable guesswork for one power iteration per level.

    A divergence once blamed on this estimate came from reduced-precision
    dot products in the coarse CG (see _dot)."""
    levels = []
    d = domain
    while True:
        op = BoxStencilOperator(d, form)
        levels.append(BoxLevel(d, op, eig_max_fourier(op)))
        if d.level <= min_level:
            break
        d = d.coarse()
    return levels


def _cheby(lvl: BoxLevel, x, b, degree: int):
    """Standard three-term Chebyshev recurrence (textbook form)."""
    # 1.1 margin covers the downward bias of the 50-step power iteration
    # (amplification above lmax is fatal; slack below is mild); the
    # smoothing interval bottom at 0.15*lmax leaves modes below it to the
    # coarse-grid correction (reference: ChebyshevSmoother.hpp:558-717).
    # Measured V(2,2)/V(3,3) asymptotic rates on the level-5 box: 0.27 /
    # 0.21 at 0.15 vs 0.34 / 0.27 at the old 0.3 bottom.
    lmax = lvl.eig_max * 1.1
    lmin = lvl.eig_max * 0.15
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    dinv = lvl.op.inverse_diagonal_traced()
    inner = lvl.inner

    def resid(x):
        return inner * (dinv * (b - lvl.op.apply_raw(x)))

    d = resid(x) / theta
    x = x + d
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * resid(x)
        x = x + d
        rho = rho_new
    return x


def coarse_cg(lvl: BoxLevel, b, iters: int = 40):
    """Fixed-iteration CG on the interior (jits as a scan)."""
    inner = lvl.inner

    def A(v):
        return inner * lvl.op.apply_raw(inner * v)

    x = jnp.zeros_like(b)
    r = inner * b
    p = r
    rs = _dot(r, r)

    def body(carry, _):
        x, r, p, rs = carry
        Ap = A(p)
        denom = _dot(p, Ap)
        alpha = jnp.where(denom > 0, rs / jnp.maximum(denom, 1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = _dot(r, r)
        beta = jnp.where(rs > 0, rs_new / jnp.maximum(rs, 1e-30), 0.0)
        p = r + beta * p
        return (x, r, p, rs_new), None

    (x, *_), _ = jax.lax.scan(body, (x, r, p, rs), None, length=iters)
    return x


def vcycle(levels: list[BoxLevel], x, b, pre: int = 2, post: int = 2,
           coarse_iters: int = 40, _k: int = 0):
    """One V-cycle on levels[_k:] (unrolled recursion, jittable)."""
    lvl = levels[_k]
    if _k == len(levels) - 1:
        return coarse_cg(lvl, b, coarse_iters)
    x = _cheby(lvl, x, b, pre)
    r = lvl.inner * lvl.op.residual(x, b)
    r_c = transfer.restrict(r, lvl.domain, levels[_k + 1].domain)
    r_c = levels[_k + 1].inner * r_c
    e_c = vcycle(levels, jnp.zeros_like(r_c), r_c, pre, post,
                 coarse_iters, _k + 1)
    e = transfer.prolongate(levels[_k + 1].inner * e_c,
                            levels[_k + 1].domain, lvl.domain)
    x = x + lvl.inner * e
    return _cheby(lvl, x, b, post)


def solve_poisson(levels: list[BoxLevel], f, g=None, cycles: int = 8,
                  pre: int = 2, post: int = 2):
    """Dirichlet Poisson solve: A u = f interior, u = g on the boundary.

    Returns (u, per-cycle residual norms)."""
    lvl = levels[0]
    dom = lvl.domain
    bnd = jnp.asarray(dom.boundary_mask, dtype=dom.dtype)
    g = jnp.zeros_like(f) if g is None else g
    x = bnd * g
    # move the inhomogeneous boundary into the rhs
    b = lvl.inner * (f - lvl.op.apply_raw(bnd * g))

    def body(x, _):
        x = vcycle(levels, x, b, pre, post)
        rn = _norm(lvl.inner * lvl.op.residual(x, b))
        return x, rn

    x_in, rns = jax.lax.scan(body, lvl.inner * x, None, length=cycles)
    return x_in + bnd * g, rns
