"""Matrix-free N1E1 curl-curl / mass operators on the dense node grid.

Redesign of the reference's N1E1 operator stack
(reference: src/hyteg/elementwiseoperators/N1E1ElementwiseOperator.hpp and
the curl-curl forms under src/hyteg/forms/form_hyteg_generated/n1e1/).
Whitney basis on an affine micro-tet with vertices (x_0..x_3), edge (a, b)
oriented a -> b:

    w_ab   = lambda_a grad(lambda_b) - lambda_b grad(lambda_a)
    curl w = 2 grad(lambda_a) x grad(lambda_b)          (constant)

so the curl-curl element matrix is exact in closed form and the mass matrix
uses the exact P1 moment integral lambda_i lambda_j = |K| (1 + delta_ij)/20.
Canonical-orientation signs (see functions/n1e1.py) are folded into the
per-cell element matrices, after which the apply is the same strided
stride-2 shifted multiply-add pattern as the P2 elementwise operator.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import BoundaryCondition, DoFType, FLAG_INNER, UpdateType
from ..functions.n1e1 import N1E1Function, N1E1Space, edge_tables, _local_edges
from ..indexing import micro
from .p2_elementwise import _base_masks, _read_strided, _scatter_strided_add


def _micro_grads_vols(space: N1E1Space, cell_vertices=None):
    """Per (cell, class): P1 barycentric gradients (C,T,4,3) and volumes
    (C,T). All micro-tets of a class within a macro-cell are congruent."""
    from . import forms

    cv = (jnp.asarray(space.storage.cell_vertices[
        : space.storage.cells_per_shard], dtype=space.dtype)
        if cell_vertices is None else cell_vertices)
    v0 = cv[:, :1, :]
    J = cv[:, 1:, :] - v0  # (C, 3, 3) rows are edge vectors
    offs = jnp.asarray(micro.offsets(3), dtype=space.dtype) / space.n
    # micro vertices (C, T, 4, 3)
    mv = v0[:, None] + jnp.einsum("tvd,cde->ctve", offs, J)
    g, vol = forms.p1_gradients(mv)
    return g, vol


def n1e1_elmats(space: N1E1Space, alpha: float = 1.0, beta: float = 0.0,
                cell_vertices=None, signed: bool = True) -> jnp.ndarray:
    """(C, T, 6, 6) element matrices alpha * curlcurl + beta * mass in the
    canonical orientation (signs folded in when ``signed``)."""
    g, vol = _micro_grads_vols(space, cell_vertices)  # (C,T,4,3), (C,T)
    edges = _local_edges(3)
    E = len(edges)
    a_idx = np.array([e[0] for e in edges])
    b_idx = np.array([e[1] for e in edges])
    ga, gb = g[:, :, a_idx], g[:, :, b_idx]  # (C,T,E,3)
    K = jnp.zeros(g.shape[:2] + (E, E), dtype=space.dtype)
    if alpha != 0.0:
        c = 2.0 * jnp.cross(ga, gb)  # curl w_e, (C,T,E,3)
        K = K + alpha * vol[..., None, None] * jnp.einsum(
            "ctei,ctfi->ctef", c, c)
    if beta != 0.0:
        G = jnp.einsum("ctai,ctbi->ctab", g, g)  # (C,T,4,4)
        nv = 4
        I = (jnp.ones((nv, nv)) + jnp.eye(nv)) / 20.0  # / |K|
        II = vol[..., None, None] * I

        def pick(M, rows, cols):
            return M[:, :, rows][:, :, :, cols]

        M_e = (pick(G, b_idx, b_idx) * pick(II, a_idx, a_idx)
               - pick(G, b_idx, a_idx) * pick(II, a_idx, b_idx)
               - pick(G, a_idx, b_idx) * pick(II, b_idx, a_idx)
               + pick(G, a_idx, a_idx) * pick(II, b_idx, b_idx))
        K = K + beta * M_e
    if signed:
        s = jnp.asarray(space.edge_signs(0), dtype=space.dtype)  # (C,T,E)
        K = K * s[..., :, None] * s[..., None, :]
    return K


def n1e1_apply_local(src, elmats, level: int, pitch: int) -> jnp.ndarray:
    """Per-cell partial apply: dst[2b + o_A] += elMat[c,t,A,B] src[2b + o_B]
    over the 6 edge midpoints o of every micro-tet class."""
    n = 1 << level
    node_offs, _, _ = edge_tables(3)  # (T, E, 3)
    T, E = node_offs.shape[0], node_offs.shape[1]
    masks = _base_masks(level, 3, pitch)
    dst = jnp.zeros_like(src)
    for t in range(T):
        distinct = {tuple(int(x) for x in node_offs[t, B]) for B in range(E)}
        reads = {o: _read_strided(src, o, n, pitch, 3) for o in distinct}
        mask = jnp.asarray(masks[t], dtype=src.dtype)
        for A in range(E):
            acc = None
            for B in range(E):
                term = elmats[:, t, A, B].reshape(-1, 1, 1) * reads[
                    tuple(int(x) for x in node_offs[t, B])]
                acc = term if acc is None else acc + term
            acc = acc * mask
            dst = _scatter_strided_add(
                dst, acc, tuple(int(x) for x in node_offs[t, A]), n, pitch, 3)
    return dst


def n1e1_diagonal_local(elmats, level: int, block_shape, pitch: int) -> jnp.ndarray:
    n = 1 << level
    node_offs, _, _ = edge_tables(3)
    T, E = node_offs.shape[0], node_offs.shape[1]
    masks = _base_masks(level, 3, pitch)
    dst = jnp.zeros(block_shape, dtype=elmats.dtype)
    base_shape = (elmats.shape[0], n, n * pitch)
    for t in range(T):
        mask = jnp.asarray(masks[t], dtype=elmats.dtype)
        for A in range(E):
            v = jnp.broadcast_to(
                elmats[:, t, A, A].reshape(-1, 1, 1), base_shape) * mask
            dst = _scatter_strided_add(
                dst, v, tuple(int(x) for x in node_offs[t, A]), n, pitch, 3)
    return dst


def potential_diagonal_local(space: N1E1Space, elmats_unsigned,
                             block_shape) -> jnp.ndarray:
    """Diagonal of G^T A G on the vertex (even) nodes, assembled from the
    local 4x4 potential matrices P = Gloc^T elMat Gloc (canonical signs
    cancel). Feeds the vertex half of the Hiptmair smoother."""
    edges = _local_edges(3)
    E, nv = len(edges), 4
    Gloc = np.zeros((E, nv))
    for e, (a, b) in enumerate(edges):
        Gloc[e, b], Gloc[e, a] = 1.0, -1.0
    Gl = jnp.asarray(Gloc, dtype=elmats_unsigned.dtype)
    P = jnp.einsum("ea,ctef,fb->ctab", Gl, elmats_unsigned, Gl)
    n = space.n
    pitch = space.node_space.pitch
    offs = micro.offsets(3)
    masks = _base_masks(space.level, 3, pitch)
    dst = jnp.zeros(block_shape, dtype=elmats_unsigned.dtype)
    base_shape = (P.shape[0], n, n * pitch)
    for t in range(P.shape[1]):
        mask = jnp.asarray(masks[t], dtype=P.dtype)
        for A in range(nv):
            v = jnp.broadcast_to(
                P[:, t, A, A].reshape(-1, 1, 1), base_shape) * mask
            o = tuple(int(2 * x) for x in offs[t, A])
            dst = _scatter_strided_add(dst, v, o, n, pitch, 3)
    return dst


class N1E1ElementwiseOperator:
    """alpha * curl-curl + beta * mass on N1E1
    (reference: N1E1ElementwiseLinearCombinationOperator)."""

    def __init__(self, space: N1E1Space, alpha: float = 1.0,
                 beta: float = 0.0, shard: int = 0, cell_vertices=None):
        self.space = space
        self.shard = shard
        self.alpha, self.beta = alpha, beta
        self.elmats = n1e1_elmats(space, alpha, beta, cell_vertices)
        self._elmats_unsigned = n1e1_elmats(
            space, alpha, beta, cell_vertices, signed=False)

    def apply_raw(self, x, sd=None, axis_name=None):
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        y = n1e1_apply_local(x, self.elmats, sp.level,
                             sp.node_space.pitch)
        return sp.exchange_add(y, sd, axis_name)

    def diagonal_raw(self, sd=None, axis_name=None):
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        d = n1e1_diagonal_local(self.elmats, sp.level, sp.block_shape,
                                sp.node_space.pitch)
        return sp.exchange_add(d, sd, axis_name)

    def inverse_diagonal(self, sd=None, axis_name=None):
        d = self.diagonal_raw(sd, axis_name)
        mask = jnp.asarray(self.space.edge_mask[None], dtype=bool)
        return jnp.where(mask & (d != 0), 1.0 / jnp.where(d == 0, 1.0, d), 0.0)

    def potential_inverse_diagonal(self, sd=None, axis_name=None):
        """Inverse diagonal of G^T A G (vertex nodes) for Hiptmair."""
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        d = potential_diagonal_local(sp, self._elmats_unsigned, sp.block_shape)
        d = sp.exchange_add(d, sd, axis_name)
        mask = jnp.asarray(sp.vertexnode_mask[None], dtype=bool)
        return jnp.where(mask & (d != 0), 1.0 / jnp.where(d == 0, 1.0, d), 0.0)

    def apply(self, src: N1E1Function, dst: N1E1Function,
              flag: DoFType = FLAG_INNER,
              update: UpdateType = UpdateType.REPLACE) -> N1E1Function:
        sd = self.space.shard_data(self.shard, dst.bc)
        y = self.apply_raw(src.cells, sd=sd)
        if update == UpdateType.ADD:
            y = y + dst.cells
        out = self.space.restore_rows(y, dst.cells, flag, sd)
        return N1E1Function(out, dst.space, dst.bc)
