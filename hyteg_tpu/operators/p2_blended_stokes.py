"""Blended-geometry P2 epsilon / div / grad operators (on-the-fly quadrature).

The P2 x blending x epsilon operator family the reference generates per
(form, map) pair (reference: the epsilon/full_stokes x IcosahedralShellMap
operators listed under src/hyteg_operators/, and
P2P1ElementwiseBlendingStokesOperator, src/hyteg/elementwiseoperators/) —
here ONE matrix-free formulation covers every geometry map:

  * geometry is isoparametric-P1: every micro-vertex is snapped onto the
    curved domain (geometry/maps.py), each micro-element is the straight
    tet over its blended vertices — its Jacobian field is read from the
    blended node-coordinate field with stride-2 offsets,
  * element matrices are never materialized: the apply evaluates the
    quadrature loop per class over ALL element positions at once, with
    physical gradients g_A(q) = J^{-T} ghat_A(q) built from closed-form
    3x3 inverses (operators/forms.py) — the analog of the
    reference's per-element quadrature kernels,
  * the viscosity field enters by element-vertex-mean averaging
    (reference: CoefficientQuadratureAveraging arithmetic mode).

Exactness: for the identity map this reproduces the affine epsilon/div
operators to roundoff (tests/test_p2_blended.py); P2 basis gradients are
affine in the reference point, so the degree-2 rule integrates the
epsilon integrand exactly on straight elements.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import DoFType, FLAG_INNER
from ..functions.p1 import P1Space
from ..functions.p2 import P2Space
from ..geometry.maps import GeometryMap
from ..indexing import micro
from . import quadrature as q
from .forms import det_small, inv_small
from .p2_elementwise import (_base_masks, _read_strided,
                             _scatter_strided_add, p2_node_offsets)


def node_coords_blended(vel_space: P2Space, gmap: GeometryMap,
                        shard: int = 0):
    """(C, M, lanes, 3) blended coordinates of every node-grid point,
    computed in-trace (a materialized constant would bloat every jit)."""
    ns = vel_space.node_space
    affine = ns.coords(shard)
    ref = jnp.asarray(ns._ref_coords, dtype=ns.dtype)
    verts = jnp.asarray(ns.cell_vertices(shard), dtype=ns.dtype)
    return gmap.apply(affine, ref, verts)


def _class_geometry(coords3, t, n, pitch, dim, mask):
    """Per-element Jacobian data of class ``t`` from the blended node
    coordinates (tuple of 3 scalar fields).

    Returns (Jinv (..., dim, dim), absdet (...,)) on the flat base grid.
    Elements outside the class base mask (padding lanes / foreign bases)
    read garbage coordinates; their Jacobians are replaced by the
    identity BEFORE inversion so no inf/NaN can leak through the exact
    zero of ``mask`` (0 * inf = NaN)."""
    voffs = micro.offsets(dim)
    reads = [
        jnp.stack([_read_strided(coords3[k], tuple(2 * int(v) for v in
                                                   voffs[t, i]),
                                 n, pitch, dim) for k in range(dim)],
                  axis=-1)
        for i in range(dim + 1)
    ]  # nv arrays (..., dim)
    # J columns are edge vectors v_i - v_0
    J = jnp.stack([reads[i + 1] - reads[0] for i in range(dim)], axis=-1)
    ok = (mask > 0)[..., None, None]
    J = jnp.where(ok, J, jnp.eye(dim, dtype=J.dtype))
    det = det_small(J)
    safe = jnp.where(jnp.abs(det) > 1e-30, det, 1.0)
    Jinv = inv_small(jnp.where(jnp.abs(det)[..., None, None] > 1e-30, J,
                               jnp.eye(dim, dtype=J.dtype)))
    return Jinv, jnp.abs(safe) * (jnp.abs(det) > 1e-30)


def _mu_element(mu, t, n, pitch, dim):
    """Element-vertex-mean of a nodal viscosity field (or None)."""
    if mu is None:
        return None
    voffs = micro.offsets(dim)
    sc = None
    for i in range(dim + 1):
        r = _read_strided(mu, tuple(2 * int(v) for v in voffs[t, i]),
                          n, pitch, dim)
        sc = r if sc is None else sc + r
    return sc / (dim + 1)


@functools.lru_cache(maxsize=None)
def _rule(dim: int, degree: int = 2):
    pts, w = q.simplex_rule(dim, degree)
    grads = q.p2_grads_at(dim, pts)  # (nn, Q, dim)
    return np.asarray(pts), np.asarray(w), np.asarray(grads)


def p2_eps_vargeom_apply(xs, coords3, level: int, dim: int, pitch: int,
                         mu=None, full: bool = False):
    """ys[d] = sum_e K_eps[d,e] xs[e] with per-element blended geometry.

    The quadrature loop is a lax.scan over the Q points with einsum
    bodies (small trailing dims) — the fully unrolled scalar form made
    every jit embedding this apply take minutes to compile."""
    n = 1 << level
    node_offs = p2_node_offsets(dim)
    T, nn = node_offs.shape[0], node_offs.shape[1]
    masks = _base_masks(level, dim, pitch)
    _, w, ghat = _rule(dim)
    ghat_q = jnp.asarray(np.transpose(ghat, (1, 0, 2)))  # (Q, nn, dim)
    wq = jnp.asarray(w)
    ys = [jnp.zeros_like(xs[0]) for _ in range(dim)]
    eye = jnp.eye(dim, dtype=xs[0].dtype)
    for t in range(T):
        mask = jnp.asarray(masks[t], dtype=xs[0].dtype)
        Jinv, det = _class_geometry(coords3, t, n, pitch, dim, mask)
        me = _mu_element(mu, t, n, pitch, dim)
        scale = det * mask if me is None else det * mask * me
        X = jnp.stack(
            [jnp.stack([_read_strided(xs[e],
                                      tuple(int(v) for v in node_offs[t, B]),
                                      n, pitch, dim) for B in range(nn)],
                       axis=-1)
             for e in range(dim)], axis=-2)  # (..., e, B)

        def body(acc, args):
            gq, wq1 = args  # (nn, dim), ()
            gu = jnp.einsum("...eB,Bk->...ek", X, gq)
            H = jnp.einsum("...ek,...kj->...ej", gu, Jinv)
            tau = H + jnp.swapaxes(H, -1, -2)
            if full:
                tr = jnp.trace(H, axis1=-2, axis2=-1)
                tau = tau - (2.0 / 3.0) * tr[..., None, None] * eye
            rho = jnp.einsum("...dj,...kj->...dk", tau, Jinv)
            contrib = wq1 * jnp.einsum("...dk,Ak->...dA", rho, gq)
            return acc + contrib, None

        acc0 = jnp.zeros(X.shape[:-2] + (dim, nn), dtype=xs[0].dtype)
        acc, _ = jax.lax.scan(body, acc0, (ghat_q, wq))
        for A in range(nn):
            sA = acc[..., :, A] * scale[..., None]
            for d2 in range(dim):
                ys[d2] = _scatter_strided_add(
                    ys[d2], sA[..., d2],
                    tuple(int(v) for v in node_offs[t, A]), n, pitch, dim)
    return tuple(ys)


def p2_eps_vargeom_diagonal(coords3, level: int, dim: int, pitch: int,
                            block_shape, mu=None, full: bool = False,
                            dtype=jnp.float32):
    """Per-component diagonals of the blended epsilon operator."""
    n = 1 << level
    node_offs = p2_node_offsets(dim)
    T, nn = node_offs.shape[0], node_offs.shape[1]
    masks = _base_masks(level, dim, pitch)
    _, w, ghat = _rule(dim)
    Q = w.shape[0]
    ghat_q = jnp.asarray(np.transpose(ghat, (1, 0, 2)))  # (Q, nn, dim)
    wq = jnp.asarray(w)
    ds = [jnp.zeros(block_shape, dtype=dtype) for _ in range(dim)]
    for t in range(T):
        mask = jnp.asarray(masks[t], dtype=dtype)
        Jinv, det = _class_geometry(coords3, t, n, pitch, dim, mask)
        me = _mu_element(mu, t, n, pitch, dim)
        scale = det * mask if me is None else det * mask * me

        def body(acc, args):
            gq, wq1 = args
            G = jnp.einsum("Ak,...kj->...Aj", gq, Jinv)
            g2 = jnp.sum(G * G, axis=-1)  # (..., A)
            fac = 1.0 - (2.0 / 3.0 if full else 0.0)
            # 2 eps(phi e_d):eps(phi e_d) = g_d^2 + |g|^2 (- 2/3 g_d^2)
            v = fac * G * G + g2[..., None]
            return acc + wq1 * v, None

        base = _read_strided(jnp.zeros_like(ds[0]), (0,) * dim, n, pitch,
                             dim)
        acc0 = jnp.zeros(base.shape + (nn, dim), dtype=dtype)
        acc, _ = jax.lax.scan(body, acc0, (ghat_q, wq))
        for A in range(nn):
            vA = acc[..., A, :] * scale[..., None]
            for d2 in range(dim):
                ds[d2] = _scatter_strided_add(
                    ds[d2], vA[..., d2],
                    tuple(int(v) for v in node_offs[t, A]), n, pitch, dim)
    return tuple(ds)


def p2p1_div_vargeom_apply(vels, coords3, level: int, dim: int, pitch: int,
                           p1_block_shape):
    """Pressure residual: y_q(i) = -int psi_i div(u) over blended elements
    (sign convention matches operators/mixed.py compute_divergence_elmats;
    the pressure lives on the element-level vertex grid)."""
    from .mixed import _shift_write_p1_add

    n = 1 << level
    voffs = micro.offsets(dim)
    node_offs = p2_node_offsets(dim)
    T, nn = node_offs.shape[0], node_offs.shape[1]
    masks = _base_masks(level, dim, pitch)
    pts, w, ghat = _rule(dim)
    Q = w.shape[0]
    lam_q = np.concatenate([1 - pts.sum(-1, keepdims=True), pts], -1)
    lam_q = jnp.asarray(lam_q)               # (Q, nv)
    ghat_q = jnp.asarray(np.transpose(ghat, (1, 0, 2)))  # (Q, nn, dim)
    wq = jnp.asarray(w)
    y = jnp.zeros(p1_block_shape, dtype=vels[0].dtype)
    for t in range(T):
        mask = jnp.asarray(masks[t], dtype=vels[0].dtype)
        Jinv, det = _class_geometry(coords3, t, n, pitch, dim, mask)
        scale = det * mask
        X = jnp.stack(
            [jnp.stack([_read_strided(vels[e],
                                      tuple(int(v) for v in node_offs[t, B]),
                                      n, pitch, dim) for B in range(nn)],
                       axis=-1)
             for e in range(dim)], axis=-2)  # (..., e, B)

        def body(acc, args):
            gq, wq1, lam = args
            gu = jnp.einsum("...eB,Bk->...ek", X, gq)
            divu = jnp.einsum("...ek,...ke->...", gu, Jinv)
            return acc - wq1 * divu[..., None] * lam, None

        acc0 = jnp.zeros(X.shape[:-2] + (dim + 1,), dtype=vels[0].dtype)
        acc, _ = jax.lax.scan(body, acc0, (ghat_q, wq, lam_q))
        for i in range(dim + 1):
            y = _shift_write_p1_add(
                y, acc[..., i] * scale,
                tuple(int(v) for v in voffs[t, i]), n, pitch, dim)
    return y


def p2p1_grad_vargeom_apply(p, coords3, level: int, dim: int, pitch: int,
                            d: int, p2_block_shape):
    """Velocity-component residual of the gradient block:
    y_v[d](B) = -int p * d_d(phi_B) (the transpose of the div block)."""
    from .mixed import _shift_read_p1

    n = 1 << level
    voffs = micro.offsets(dim)
    node_offs = p2_node_offsets(dim)
    T, nn = node_offs.shape[0], node_offs.shape[1]
    masks = _base_masks(level, dim, pitch)
    pts, w, ghat = _rule(dim)
    Q = w.shape[0]
    lam_q = np.concatenate([1 - pts.sum(-1, keepdims=True), pts], -1)
    lam_q = jnp.asarray(lam_q)               # (Q, nv)
    ghat_q = jnp.asarray(np.transpose(ghat, (1, 0, 2)))  # (Q, nn, dim)
    wq = jnp.asarray(w)
    y = jnp.zeros(p2_block_shape, dtype=p.dtype)
    for t in range(T):
        mask = jnp.asarray(masks[t], dtype=p.dtype)
        Jinv, det = _class_geometry(coords3, t, n, pitch, dim, mask)
        scale = det * mask
        P = jnp.stack(
            [_shift_read_p1(p, tuple(int(v) for v in voffs[t, i]),
                            n, pitch, dim) for i in range(dim + 1)],
            axis=-1)  # (..., nv)

        def body(acc, args):
            gq, wq1, lam = args
            pq = jnp.einsum("...i,i->...", P, lam)
            # d_d phi_B(q) = sum_k Jinv[k, d] ghat_B^k(q)
            dphi = jnp.einsum("...k,Bk->...B", Jinv[..., :, d], gq)
            return acc - wq1 * dphi * pq[..., None], None

        acc0 = jnp.zeros(P.shape[:-1] + (nn,), dtype=p.dtype)
        acc, _ = jax.lax.scan(body, acc0, (ghat_q, wq, lam_q))
        for B in range(nn):
            y = _scatter_strided_add(
                y, acc[..., B] * scale,
                tuple(int(v) for v in node_offs[t, B]), n, pitch, dim)
    return y


class P2BlendedEpsilonOperator:
    """Vector P2 viscous block on blended geometry (drop-in for
    P2VectorEpsilonOperator; reference: the epsilon x ShellMap generated
    operator family)."""

    def __init__(self, space: P2Space, gmap: GeometryMap, shard: int = 0,
                 full: bool = False):
        self.space = space
        self.gmap = gmap
        self.shard = shard
        self.full = full

    def _coords3(self):
        co = node_coords_blended(self.space, self.gmap, self.shard)
        return tuple(co[..., k] for k in range(self.space.dim))

    def apply_raw(self, xs, coeff=None, sd=None, axis_name=None):
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        ys = p2_eps_vargeom_apply(xs, self._coords3(), sp.level, sp.dim,
                                  sp.pitch, mu=coeff, full=self.full)
        return tuple(sp.exchange_add(y, sd, axis_name) for y in ys)

    def diagonal_raw(self, coeff=None, sd=None, axis_name=None):
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        ds = p2_eps_vargeom_diagonal(self._coords3(), sp.level, sp.dim,
                                     sp.pitch, sp.block_shape, mu=coeff,
                                     full=self.full, dtype=sp.dtype)
        return tuple(sp.exchange_add(d, sd, axis_name) for d in ds)

    def inverse_diagonal(self, coeff=None, sd=None, axis_name=None):
        ds = self.diagonal_raw(coeff, sd, axis_name)
        mask = jnp.asarray(self.space.vertex_mask[None], dtype=bool)
        return tuple(
            jnp.where(mask & (d != 0), 1.0 / jnp.where(d == 0, 1.0, d), 0.0)
            for d in ds
        )


class P2P1BlendedDivOperator:
    """Blended div/grad Stokes blocks (drop-in for P2ToP1DivOperator)."""

    def __init__(self, p2: P2Space, p1: P1Space, gmap: GeometryMap,
                 shard: int = 0):
        self.p2 = p2
        self.p1 = p1
        self.gmap = gmap
        self.shard = shard

    def _coords3(self):
        co = node_coords_blended(self.p2, self.gmap, self.shard)
        return tuple(co[..., k] for k in range(self.p2.dim))

    def apply_div_local(self, vel_components):
        sp = self.p2
        return p2p1_div_vargeom_apply(vel_components, self._coords3(),
                                      sp.level, sp.dim, sp.pitch,
                                      self.p1.block_shape)

    def apply_gradient_component_local(self, p, d: int):
        sp = self.p2
        return p2p1_grad_vargeom_apply(p, self._coords3(), sp.level, sp.dim,
                                       sp.pitch, d, sp.block_shape)
