"""P2 vector epsilon / full-viscous operators (variable viscosity).

Analog of the reference's epsilon and full-Stokes operator
families (reference: src/hyteg/forms/form_hyteg_manual/ and the generated
epsilon/full_stokes operators listed under src/hyteg_operators/;
src/hyteg/elementwiseoperators/P2ElementwiseBlendingEpsilonOperator et al).

The viscous block of variable-viscosity Stokes:

    K[d A, e B] = int 2 mu eps(phi_B e_e) : eps(phi_A e_d)
                = int mu (d_e phi_A d_d phi_B + delta_de grad phi_A . grad phi_B)

with optionally the full-viscous compressible part - (2/3) int mu
(d_d phi_A)(d_e phi_B) (reference: full_stokes family).

The viscosity enters by element-mean averaging of a nodal field (the
reference's CoefficientQuadratureAveraging arithmetic mode,
src/hyteg/forms/CoefficientQuadratureAveraging.hpp): elMat per element is
the unit-viscosity matrix scaled by the mean of mu at the element's
vertices.  Applies are strided shifted multiply-adds on the dense
level-(L+1) node grid, sharing the per-class reads across all dim^2
component blocks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import DoFType, FLAG_INNER
from ..functions.p2 import P2Space
from ..indexing import micro
from . import quadrature as q
from .p2_elementwise import (_base_masks, _read_strided, _scatter_strided_add,
                             p2_node_offsets)


def compute_p2_epsilon_elmats(space: P2Space, cell_vertices=None,
                              full: bool = False) -> jnp.ndarray:
    """(C, T, dim, dim, nn, nn) unit-viscosity epsilon element matrices.

    K[c,t,d,e,A,B] = int d_e phi_A d_d phi_B + delta_de grad phi_A.grad phi_B
    (+ full: - 2/3 d_d phi_A d_e phi_B), exact for affine micro-elements.
    """
    dim = space.dim
    cv = (jnp.asarray(space.cell_vertices(0)) if cell_vertices is None
          else cell_vertices)
    verts = cv[..., :dim] if dim == 2 else cv
    v0 = verts[:, :1, :]
    J = verts[:, 1:, :] - v0
    offs = jnp.asarray(micro.offsets(dim), dtype=verts.dtype) / space.n
    mv = v0[:, None] + jnp.einsum("tvd,cde->ctve", offs, J)  # (C,T,nv,dim)

    pts, w = q.simplex_rule(dim, 2)
    grads = jnp.asarray(q.p2_grads_at(dim, pts))  # (nA, Q, dim)

    Je = jnp.swapaxes(mv[..., 1:, :] - mv[..., :1, :], -1, -2)
    Jinv = jnp.linalg.inv(Je)
    detJ = jnp.abs(jnp.linalg.det(Je))
    g = jnp.einsum("aqd,ctde->ctaqe", grads, Jinv)  # physical grads

    wq = jnp.asarray(w)
    # cross term: d_e phi_A * d_d phi_B
    cross = jnp.einsum("q,ctaqe,ctbqd->ctdeab", wq, g, g)
    # laplacian term on the diagonal d == e
    lap = jnp.einsum("q,ctaqk,ctbqk->ctab", wq, g, g)
    K = cross + jnp.eye(dim)[None, None, :, :, None, None] * \
        lap[:, :, None, None, :, :]
    if full:
        K = K - (2.0 / 3.0) * jnp.einsum("q,ctaqd,ctbqe->ctdeab", wq, g, g)
    return (detJ[..., None, None, None, None] * K).astype(space.dtype)


def p2_vector_apply_local(xs, elmats, level: int, dim: int,
                          pitch: int | None = None, coeff=None):
    """Per-cell partial vector apply: ys[d] = sum_e K[d,e] xs[e].

    xs: tuple of dim node-grid blocks; elmats: (C, T, dim, dim, nn, nn);
    coeff: optional nodal viscosity (node grid) — element-mean scaling.
    Per-class reads of every component are shared across the dim^2 blocks.
    """
    n = 1 << level
    pitch = (2 * n + 1) if (pitch is None or dim == 2) else pitch
    node_offs = p2_node_offsets(dim)
    T, nn = node_offs.shape[0], node_offs.shape[1]
    masks = _base_masks(level, dim, pitch)
    voffs = micro.offsets(dim)
    ys = [jnp.zeros_like(xs[0]) for _ in range(dim)]
    for t in range(T):
        mask = jnp.asarray(masks[t], dtype=xs[0].dtype)
        if coeff is not None:
            sc = None
            for vtx in range(voffs.shape[1]):
                o = tuple(int(2 * v) for v in voffs[t, vtx])
                r = _read_strided(coeff, o, n, pitch, dim)
                sc = r if sc is None else sc + r
            mask = mask * (sc / voffs.shape[1])
        distinct = {tuple(int(v) for v in node_offs[t, B]) for B in range(nn)}
        reads = {
            (e, o): _read_strided(xs[e], o, n, pitch, dim)
            for e in range(dim) for o in distinct
        }
        for d in range(dim):
            for A in range(nn):
                acc = None
                for e in range(dim):
                    for B in range(nn):
                        wAB = elmats[:, t, d, e, A, B].reshape(-1, 1, 1)
                        o = tuple(int(v) for v in node_offs[t, B])
                        term = wAB * reads[(e, o)]
                        acc = term if acc is None else acc + term
                ys[d] = _scatter_strided_add(
                    ys[d], acc * mask, tuple(int(v) for v in node_offs[t, A]),
                    n, pitch, dim)
    return tuple(ys)


def p2_vector_diagonal_local(elmats, level: int, dim: int, block_shape,
                             pitch: int | None = None, coeff=None):
    """Per-cell partial diagonals (one block per component d)."""
    n = 1 << level
    pitch = (2 * n + 1) if (pitch is None or dim == 2) else pitch
    node_offs = p2_node_offsets(dim)
    T, nn = node_offs.shape[0], node_offs.shape[1]
    masks = _base_masks(level, dim, pitch)
    voffs = micro.offsets(dim)
    ds = [jnp.zeros(block_shape, dtype=elmats.dtype) for _ in range(dim)]
    BL = n * pitch if dim == 3 else n
    base_shape = (elmats.shape[0], n, BL)
    for t in range(T):
        mask = jnp.asarray(masks[t], dtype=elmats.dtype)
        if coeff is not None:
            sc = None
            for vtx in range(voffs.shape[1]):
                o = tuple(int(2 * v) for v in voffs[t, vtx])
                r = _read_strided(coeff, o, n, pitch, dim)
                sc = r if sc is None else sc + r
            mask = mask * (sc / voffs.shape[1])
        for d in range(dim):
            for A in range(nn):
                w = elmats[:, t, d, d, A, A]
                v = jnp.broadcast_to(w.reshape(-1, 1, 1), base_shape) * mask
                ds[d] = _scatter_strided_add(
                    ds[d], v, tuple(int(x) for x in node_offs[t, A]), n,
                    pitch, dim)
    return tuple(ds)


class P2VectorEpsilonOperator:
    """Vector P2 -> vector P2 viscous block with nodal viscosity.

    ``mu`` may be None (unit viscosity), a scalar, or a nodal field on the
    node grid (applied by element-mean averaging at every apply, so a
    time-dependent eta(T) can be passed per call via ``coeff``)."""

    def __init__(self, space: P2Space, shard: int = 0, full: bool = False,
                 elmats=None, cell_vertices=None):
        self.space = space
        self.shard = shard
        self.full = full
        if elmats is None:
            elmats = compute_p2_epsilon_elmats(space, cell_vertices, full)
        self.elmats = elmats

    def apply_raw(self, xs, coeff=None, sd=None, axis_name=None):
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        ys = p2_vector_apply_local(xs, self.elmats, sp.level, sp.dim,
                                   sp.pitch, coeff)
        return tuple(sp.exchange_add(y, sd, axis_name) for y in ys)

    def apply_inner(self, xs, sd_or_bc=None, flag: DoFType = FLAG_INNER,
                    coeff=None, axis_name=None):
        sd = self.space.resolve_sd(sd_or_bc, self.shard)
        ys = self.apply_raw(xs, coeff, sd, axis_name)
        return tuple(
            self.space.restore_rows(y, jnp.zeros_like(y), flag, sd)
            for y in ys
        )

    def diagonal_raw(self, coeff=None, sd=None, axis_name=None):
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        ds = p2_vector_diagonal_local(self.elmats, sp.level, sp.dim,
                                      sp.block_shape, sp.pitch, coeff)
        return tuple(sp.exchange_add(d, sd, axis_name) for d in ds)

    def inverse_diagonal(self, coeff=None, sd=None, axis_name=None):
        ds = self.diagonal_raw(coeff, sd, axis_name)
        mask = jnp.asarray(self.space.vertex_mask[None], dtype=bool)
        return tuple(
            jnp.where(mask & (d != 0), 1.0 / jnp.where(d == 0, 1.0, d), 0.0)
            for d in ds
        )
