"""Matrix-free stencil operators on BoxDomain grids.

The role of the reference's P1ConstantOperator + generated kernels
(reference: src/hyteg/p1functionspace/P1ConstantOperator.cpp,
src/constant_stencil_operator/P1generatedKernels/apply_3D_macrocell_
vertexdof_to_vertexdof_replace.cpp:14-60) on the aggregated box grid:
a single translation-invariant 15-point stencil with pointwise-exact
per-lane weight vectors (kuhn.lane_weights) — boundary faces need no
separate loops and shifted reads need no masks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..operators import forms
from . import kuhn
from .box import BoxDomain


def shift_read(u: jnp.ndarray, d, Z: int) -> jnp.ndarray:
    """out[x, l] = u[x + dx, l + dy*Z + dz]; rows zero-filled, lanes wrap
    (wrapped lane targets always carry exactly-zero stencil weights)."""
    dx, dy, dz = (int(v) for v in d)
    ls = dy * Z + dz
    if ls:
        u = jnp.roll(u, -ls, axis=1)
    if dx == 0:
        return u
    z = jnp.zeros((abs(dx), u.shape[1]), dtype=u.dtype)
    if dx > 0:
        return jnp.concatenate([u[dx:], z], axis=0)
    return jnp.concatenate([z, u[:dx]], axis=0)


class BoxStencilOperator:
    """A: u -> A u for a constant-coefficient form on a BoxDomain.

    ``form``: callable (..., 4, 3) physical tet vertices -> (..., 4, 4)
    element matrices (same quadrature engine as the tet path)."""

    def __init__(self, domain: BoxDomain, form=forms.laplace_form):
        self.domain = domain
        self.form = form
        verts = kuhn.micro_vertices(domain.h)  # (6, 4, 3)
        self.elmats = jnp.asarray(form(jnp.asarray(verts)),
                                  dtype=domain.dtype)
        X, Y, Z = domain.dims
        self.w_vecs = kuhn.lane_weights(self.elmats, X, Y, Z)  # (3, n_s, L)
        self.diagonal = self._compute_diagonal()
        d = self.diagonal
        self.inverse_diagonal = jnp.where(
            d != 0, 1.0 / jnp.where(d == 0, 1.0, d), 0.0)

    # -- apply ----------------------------------------------------------------

    def apply_raw(self, u: jnp.ndarray) -> jnp.ndarray:
        """Exact A u on every node (including boundary rows).

        Arrays placed on a CUDA device take the Triton kernel
        (kernels/box_stencil.py); every other platform takes the XLA
        formulation.  The choice is made when the computation is lowered
        for its platform."""
        from ..kernels.box_stencil import box_apply_triton

        return jax.lax.platform_dependent(
            u,
            cuda=lambda v: box_apply_triton(v, self.w_vecs,
                                            self.domain.dims),
            default=self._apply_xla)

    def _apply_xla(self, u: jnp.ndarray) -> jnp.ndarray:
        """Plain XLA apply, the reference for the kernel.  Storage may be
        bfloat16; the sums are taken in float32 either way."""
        X, Y, Z = self.domain.dims
        dirs = kuhn.stencil_dirs()
        w = self.w_vecs.astype(jnp.float32)
        uf = u.astype(jnp.float32)
        bulk = None
        row0 = None
        rowl = None
        for s in range(dirs.shape[0]):
            r = shift_read(uf, dirs[s], Z)
            t = w[0, s][None, :] * r
            bulk = t if bulk is None else bulk + t
            t0 = w[1, s] * r[0]
            row0 = t0 if row0 is None else row0 + t0
            tl = w[2, s] * r[X - 1]
            rowl = tl if rowl is None else rowl + tl
        return jnp.concatenate(
            [row0[None], bulk[1 : X - 1], rowl[None]], axis=0
        ).astype(u.dtype)

    def gemv(self, u, y, alpha=1.0, beta=1.0) -> jnp.ndarray:
        """alpha * A u + beta * y (fused epilogue under jit)."""
        return alpha * self.apply_raw(u) + beta * y

    def residual(self, u, b) -> jnp.ndarray:
        return self.gemv(u, b, alpha=-1.0, beta=1.0)

    # -- Dirichlet form: boundary rows act as identity ------------------------

    def apply_dirichlet(self, u: jnp.ndarray) -> jnp.ndarray:
        """Inner rows of A u; boundary rows pass u through (identity),
        the standard eliminated-Dirichlet operator."""
        d = self.domain
        inner = jnp.asarray(d.interior_mask, dtype=d.dtype)
        bnd = jnp.asarray(d.boundary_mask, dtype=d.dtype)
        return inner * self.apply_raw(u) + bnd * u

    # -- diagonal (eager: lazy caching under jit would leak tracers) ----------

    def inverse_diagonal_traced(self) -> jnp.ndarray:
        """1/diag built in-trace (the eager attribute is a full (X, L)
        concrete array — a 4.3 GB captured constant at 1e9 DoFs)."""
        d = self._compute_diagonal()
        return jnp.where(d != 0, 1.0 / jnp.where(d == 0, 1.0, d), 0.0)

    def _compute_diagonal(self) -> jnp.ndarray:
        X, _, _ = self.domain.dims
        dirs = kuhn.stencil_dirs()
        s0 = int(np.where((dirs == 0).all(axis=1))[0][0])
        w = self.w_vecs
        return jnp.concatenate(
            [
                w[1, s0][None],
                jnp.broadcast_to(w[0, s0][None], (X - 2, w.shape[2])),
                w[2, s0][None],
            ],
            axis=0,
        ).astype(self.domain.dtype)
