"""Matrix-free P2 elementwise operators on the dense node grid.

Redesign of the reference's P2 operator stack
(reference: src/hyteg/elementwiseoperators/P2ElementwiseOperator.cpp and the
1243 generated P2 stencil kernel files under src/constant_stencil_operator/
P2generatedKernels/). On the level-(L+1) node grid, micro-element class t
with base b (element grid) owns the 10 nodes at ``2 b + O_t(g)`` where
O_t(g) in {0,1,2}^3; the apply is

    dst[2b + O_t(g_A)] += elMat[c, t, A, B] * src[2b + O_t(g_B)]

— strided (stride-2) shifted dense multiply-adds, masked to the class's base
region. One formulation covers constant, variable-coefficient and per-cell
geometry, like the P1 path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import BoundaryCondition, DoFType, FLAG_INNER, UpdateType
from ..functions.p1 import P1ShardData
from ..functions.p2 import P2Function, P2Space
from ..indexing import micro
from . import quadrature as q


@functools.lru_cache(maxsize=None)
def p2_node_offsets(dim: int) -> np.ndarray:
    """(T, n_nodes, dim) node-grid offsets of each class's P2 nodes, in the
    canonical p2_offsets order: O_t(g) = (2 - sum g) off_0 + sum_i g_i off_i+1."""
    offs = micro.offsets(dim)  # (T, nv, dim)
    gs = q.p2_offsets(dim)  # (n_nodes, dim)
    T = offs.shape[0]
    out = np.zeros((T, gs.shape[0], dim), dtype=np.int64)
    for t in range(T):
        for A, g in enumerate(gs):
            w0 = 2 - int(g.sum())
            out[t, A] = w0 * offs[t, 0] + sum(
                int(g[i]) * offs[t, 1 + i] for i in range(dim)
            )
    assert out.min() >= 0 and out.max() <= 2
    return out


@functools.lru_cache(maxsize=None)
def _base_masks(level: int, dim: int, pitch: int):
    """Class base masks on the flat element grid (n, n*pitch) [3D] /
    (n, n) [2D], cropped to [0, n)^dim before flattening."""
    from ..indexing import flat

    n = 1 << level
    out = []
    for t in range(micro.num_classes(dim)):
        m = micro.elem_base_mask(level, t, dim)
        m = np.ascontiguousarray(m[(slice(0, n),) * dim], dtype=np.float32)
        if dim == 3:
            m = flat.flatten_field(m, pitch)
        out.append(m)
    return tuple(out)


def _lane_parts(off, pitch: int, dim: int):
    """(sublane offset, lane shift) of a node-grid offset."""
    if dim == 2:
        return int(off[0]), int(off[1])
    return int(off[0]), int(off[1]) * pitch + int(off[2])


def _read_strided(u, off, n, pitch, dim):
    """R[b] = u[2b + off] on flat node blocks, b over the (n, n*pitch)
    flat base grid (invalid padding lanes read garbage/zero — masked)."""
    ox, ls = _lane_parts(off, pitch, dim)
    BL = n * pitch if dim == 3 else n
    L = u.shape[-1]
    nl = min(BL, (L - 1 - ls) // 2 + 1)
    r = u[:, ox : ox + 2 * n : 2, ls : ls + 2 * nl : 2]
    if nl < BL:
        r = jnp.pad(r, [(0, 0), (0, 0), (0, BL - nl)])
    return r


def _scatter_strided_add(dst, v, off, n, pitch, dim):
    """dst[2b + off] += v[b] (v masked to valid bases by the caller)."""
    ox, ls = _lane_parts(off, pitch, dim)
    BL = n * pitch if dim == 3 else n
    L = dst.shape[-1]
    nl = min(BL, (L - 1 - ls) // 2 + 1)
    return dst.at[:, ox : ox + 2 * n : 2, ls : ls + 2 * nl : 2].add(v[:, :, :nl])


def compute_p2_elmats(space: P2Space, kind: str = "laplace",
                      cell_vertices=None, degree: int | None = None,
                      form=None) -> jnp.ndarray:
    """(C, T, 10, 10) P2 element matrices per micro-element class.

    kind: 'laplace' | 'mass', or pass ``form(verts)->(...,10,10)`` directly.
    """
    dim = space.dim
    cv = (jnp.asarray(space.cell_vertices(0)) if cell_vertices is None
          else cell_vertices)
    # node_space cell vertices == storage cell vertices (same macro cells)
    verts = cv[..., :dim] if dim == 2 else cv
    v0 = verts[:, :1, :]
    J = verts[:, 1:, :] - v0
    offs = jnp.asarray(micro.offsets(dim), dtype=verts.dtype) / space.n
    micro_verts = v0[:, None] + jnp.einsum("tvd,cde->ctve", offs, J)  # (C,T,nv,dim)

    if form is not None:
        return jnp.asarray(form(micro_verts), dtype=space.dtype)
    if kind == "laplace":
        pts, w = q.simplex_rule(dim, 2 if degree is None else degree)
        grads = q.p2_grads_at(dim, pts)
        return jnp.asarray(q.stiffness_elmat(micro_verts, grads, w),
                           dtype=space.dtype)
    if kind == "mass":
        pts, w = q.simplex_rule(dim, 4 if degree is None else degree)
        vals = q.p2_basis_at(dim, pts)
        return jnp.asarray(q.mass_elmat(micro_verts, vals, w), dtype=space.dtype)
    raise ValueError(f"unknown kind {kind}")


def p2_apply_local(src, elmats, level: int, dim: int, pitch: int | None = None,
                   coeff=None) -> jnp.ndarray:
    """Per-cell partial P2 apply on the flat node grid.

    src: (C, M, M*pitch) [3D] / (C, M, M) [2D]; elmats: (C, T, nn, nn);
    coeff: optional nodal field on the node grid — each element scaled by
    the mean of its vertex values (element level), like the P1 variable path.
    """
    n = 1 << level
    pitch = (2 * n + 1) if (pitch is None or dim == 2) else pitch
    node_offs = p2_node_offsets(dim)  # (T, nn, dim)
    T, nn = node_offs.shape[0], node_offs.shape[1]
    masks = _base_masks(level, dim, pitch)
    voffs = micro.offsets(dim)
    dst = jnp.zeros_like(src)
    for t in range(T):
        distinct = {tuple(int(x) for x in node_offs[t, B]) for B in range(nn)}
        reads = {o: _read_strided(src, o, n, pitch, dim) for o in distinct}
        mask = jnp.asarray(masks[t], dtype=src.dtype)
        if coeff is not None:
            # element-mean of coeff at the element's vertices (2*off on grid)
            sc = None
            for vtx in range(voffs.shape[1]):
                o = tuple(int(2 * x) for x in voffs[t, vtx])
                r = _read_strided(coeff, o, n, pitch, dim)
                sc = r if sc is None else sc + r
            mask = mask * (sc / voffs.shape[1])
        for A in range(nn):
            acc = None
            for B in range(nn):
                term = elmats[:, t, A, B].reshape(-1, 1, 1)
                term = term * reads[tuple(int(x) for x in node_offs[t, B])]
                acc = term if acc is None else acc + term
            acc = acc * mask
            dst = _scatter_strided_add(
                dst, acc, tuple(int(x) for x in node_offs[t, A]), n, pitch, dim
            )
    return dst


def p2_diagonal_local(elmats, level: int, dim: int, block_shape,
                      pitch: int | None = None, coeff=None):
    n = 1 << level
    pitch = (2 * n + 1) if (pitch is None or dim == 2) else pitch
    node_offs = p2_node_offsets(dim)
    T, nn = node_offs.shape[0], node_offs.shape[1]
    masks = _base_masks(level, dim, pitch)
    voffs = micro.offsets(dim)
    dst = jnp.zeros(block_shape, dtype=elmats.dtype)
    BL = n * pitch if dim == 3 else n
    base_shape = (elmats.shape[0], n, BL)
    for t in range(T):
        mask = jnp.asarray(masks[t], dtype=elmats.dtype)
        if coeff is not None:
            sc = None
            for vtx in range(voffs.shape[1]):
                o = tuple(int(2 * x) for x in voffs[t, vtx])
                r = _read_strided(coeff, o, n, pitch, dim)
                sc = r if sc is None else sc + r
            mask = mask * (sc / voffs.shape[1])
        for A in range(nn):
            w = elmats[:, t, A, A]
            v = jnp.broadcast_to(w.reshape(-1, 1, 1), base_shape) * mask
            dst = _scatter_strided_add(
                dst, v, tuple(int(x) for x in node_offs[t, A]), n, pitch, dim
            )
    return dst


class P2ElementwiseOperator:
    """P2 -> P2 operator (reference: P2ElementwiseOperator).

    Every apply takes the general strided path ``p2_apply_local``.  The
    parity-resolved stencil (kernels/p2_const_stencil.py) computes the same
    constant-coefficient apply but is slower on an H100 at 2.1M DoFs, so
    nothing routes to it."""

    def __init__(self, space: P2Space, kind: str = "laplace", shard: int = 0,
                 elmats=None, form=None):
        self.space = space
        self.shard = shard
        if elmats is None:
            elmats = compute_p2_elmats(space, kind, form=form)
        self.elmats = elmats

    @classmethod
    def from_shard_data(cls, space: P2Space, kind: str, sd: P1ShardData):
        elm = compute_p2_elmats(space, kind, cell_vertices=sd.cell_vertices)
        return cls(space, kind, elmats=elm)

    def _apply_local(self, x, coeff):
        sp = self.space
        return p2_apply_local(x, self.elmats, sp.level, sp.dim, sp.pitch,
                              coeff)

    def apply_raw(self, x, coeff=None, sd=None, axis_name=None):
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        y = self._apply_local(x, coeff)
        return sp.exchange_add(y, sd, axis_name)

    def gemv(self, x, y, alpha=1.0, beta=1.0, coeff=None, sd=None,
             axis_name=None):
        """alpha * A x + beta * y (reference: P2ElementwiseOperator gemv)."""
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        z = sp.exchange_add(self._apply_local(x, coeff), sd, axis_name)
        return alpha * z + beta * y

    def residual(self, x, b, coeff=None, sd=None, axis_name=None):
        return self.gemv(x, b, alpha=-1.0, beta=1.0, coeff=coeff, sd=sd,
                         axis_name=axis_name)

    def apply_inner(self, x, sd_or_bc=None, flag: DoFType = FLAG_INNER,
                    coeff=None, axis_name=None):
        sd = self.space.resolve_sd(sd_or_bc, self.shard)
        y = self.apply_raw(x, coeff, sd, axis_name)
        return self.space.restore_rows(y, jnp.zeros_like(y), flag, sd)

    def diagonal_raw(self, coeff=None, sd=None, axis_name=None):
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        d = p2_diagonal_local(self.elmats, sp.level, sp.dim, sp.block_shape,
                              sp.pitch, coeff)
        return sp.exchange_add(d, sd, axis_name)

    def inverse_diagonal(self, coeff=None, sd=None, axis_name=None):
        d = self.diagonal_raw(coeff, sd, axis_name)
        mask = jnp.asarray(self.space.vertex_mask[None], dtype=bool)
        return jnp.where(mask & (d != 0), 1.0 / jnp.where(d == 0, 1.0, d), 0.0)

    def apply(self, src: P2Function, dst: P2Function,
              flag: DoFType = FLAG_INNER,
              update: UpdateType = UpdateType.REPLACE) -> P2Function:
        sd = self.space.shard_data(self.shard, dst.bc)
        y = self.apply_raw(src.cells, sd=sd)
        if update == UpdateType.ADD:
            y = y + dst.cells
        out = self.space.restore_rows(y, dst.cells, flag, sd)
        return P2Function(out, dst.space, dst.bc)
