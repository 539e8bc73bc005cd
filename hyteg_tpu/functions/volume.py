"""VolumeDoF / P0 / DG function spaces: per-micro-element DoFs.

Redesign of the reference's VolumeDoFFunction
(reference: src/hyteg/volumedofspace/VolumeDoFFunction.hpp,
CellDoFIndexing.hpp:38-55 WHITE_UP..GREEN_DOWN micro-cell types, SoA/AoS
layouts VolumeDoFIndexing.hpp:44-48) and P0Function
(src/hyteg/p0functionspace/P0Function.hpp). Data layout is SoA:

    (C, T, n, ..., n [, ndofs])   n = 2^level, T = element classes (6/2)

masked by the per-class base masks (the dense-cube analog of the
triangular/pyramidal index space). Volume DoFs are uniquely owned by their
macro-cell — no interface replication, no halo exchange (the reference's
ghost layers exist only for DG facet coupling, which the facet operators
compute from the neighbouring P1/P2 node grids instead).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..indexing import micro
from ..primitives.storage import CellStorage


class VolumeDoFSpace:
    """Per-micro-element DoF space with ``ndofs`` scalars per element."""

    def __init__(self, storage: CellStorage, level: int, ndofs: int = 1,
                 dtype=jnp.float32):
        self.storage = storage
        self.level = level
        self.dim = storage.dim
        self.n = 1 << level
        self.T = micro.num_classes(self.dim)
        self.ndofs = ndofs
        self.dtype = dtype
        self.C_loc = storage.cells_per_shard * storage.num_shards

    # -- static masks / geometry ------------------------------------------------

    @functools.cached_property
    def base_mask(self) -> np.ndarray:
        """(T, n...) bool — valid element base positions per class."""
        full = []
        for t in range(self.T):
            m = micro.elem_base_mask(self.level, t, self.dim)
            # base masks are defined on the (n+1)-vertex grid; crop to n
            crop = tuple(slice(0, self.n) for _ in range(self.dim))
            full.append(m[crop])
        return np.stack(full)

    @property
    def block_shape(self):
        s = (self.C_loc, self.T) + (self.n,) * self.dim
        return s + ((self.ndofs,) if self.ndofs > 1 else ())

    def zeros(self) -> jnp.ndarray:
        return jnp.zeros(self.block_shape, dtype=self.dtype)

    @functools.cached_property
    def _valid_weight(self) -> np.ndarray:
        """(C, T, n...) float: 1 on valid elements of valid cells."""
        cv = np.asarray(self.storage.cell_valid, dtype=np.float64)
        w = cv.reshape((-1, 1) + (1,) * self.dim) * self.base_mask[None]
        return w

    def num_global_dofs(self) -> int:
        return int(self._valid_weight.sum()) * self.ndofs

    def elem_vertices(self, cell_vertices=None) -> jnp.ndarray:
        """(C, T, n..., nv, dim) physical vertex coords of every element."""
        cv = (jnp.asarray(self.storage.cell_vertices, dtype=self.dtype)
              if cell_vertices is None else cell_vertices)
        verts = cv[..., : self.dim]
        v0 = verts[:, :1, :]
        J = verts[:, 1:, :] - v0  # (C, dim, dim)
        offs = jnp.asarray(micro.offsets(self.dim), dtype=self.dtype)  # (T,nv,dim)
        axes = [jnp.arange(self.n, dtype=self.dtype)] * self.dim
        grids = jnp.stack(jnp.meshgrid(*axes, indexing="ij"), -1)  # (n...,dim)
        ref = (grids[None, ..., None, :] + offs.reshape(
            (self.T,) + (1,) * self.dim + offs.shape[1:])) / self.n
        # (T, n..., nv, dim) reference coords -> physical per cell
        phys = v0.reshape((-1,) + (1,) * (self.dim + 2) + (self.dim,)) + \
            jnp.einsum("t...vd,cde->ct...ve", ref, J)
        return phys

    def elem_centroids(self) -> jnp.ndarray:
        return self.elem_vertices().mean(axis=-2)

    @functools.cached_property
    def elem_volumes(self) -> jnp.ndarray:
        """(C, T, n...) element measures (areas/volumes)."""
        cv = jnp.asarray(self.storage.cell_vertices, dtype=self.dtype)
        verts = cv[..., : self.dim]
        J = verts[:, 1:, :] - verts[:, :1, :]
        det = jnp.abs(jnp.linalg.det(J))
        fact = 2.0 if self.dim == 2 else 6.0
        vol = det / fact / (self.n ** self.dim)  # all classes equal measure
        w = jnp.asarray(self._valid_weight, dtype=self.dtype)
        return vol.reshape((-1, 1) + (1,) * self.dim) * w

    # -- vector-space ops ---------------------------------------------------------

    def interpolate(self, expr) -> jnp.ndarray:
        """Evaluate ``expr`` (constant or callable of centroid coords
        (..., dim)) per element (reference: P0 interpolate semantics)."""
        if callable(expr):
            vals = jnp.asarray(expr(self.elem_centroids()), dtype=self.dtype)
        else:
            vals = jnp.full((self.C_loc, self.T) + (self.n,) * self.dim,
                            expr, dtype=self.dtype)
        w = jnp.asarray(self._valid_weight, dtype=self.dtype)
        if self.ndofs > 1:
            w = w[..., None]
            if vals.ndim == w.ndim - 1:
                vals = vals[..., None]
            vals = jnp.broadcast_to(vals, self.block_shape)
        return vals * w

    def dot(self, u, v) -> jnp.ndarray:
        w = jnp.asarray(self._valid_weight, dtype=self.dtype)
        if self.ndofs > 1:
            w = w[..., None]
        return jnp.sum(u * v * w)

    def dof_sum(self, u):
        return self.dot(u, jnp.ones_like(u))

    def dof_max(self, u):
        w = self._valid_weight > 0
        w = jnp.asarray(w if self.ndofs == 1 else w[..., None])
        return jnp.max(jnp.where(w, u, -jnp.inf))

    def integral(self, u) -> jnp.ndarray:
        """Domain integral of the piecewise-constant field (ndofs=1)."""
        return jnp.sum(u * self.elem_volumes)

    # -- P0 mass operator (diagonal) ----------------------------------------------

    def mass_apply(self, u) -> jnp.ndarray:
        """P0 mass matrix is diagonal: M u = |K| u."""
        return u * self.elem_volumes

    def inverse_mass_apply(self, u) -> jnp.ndarray:
        v = self.elem_volumes
        return jnp.where(v > 0, u / jnp.where(v > 0, v, 1.0), 0.0)


class P0Function:
    """Piecewise-constant function handle (reference: P0Function)."""

    def __init__(self, space: VolumeDoFSpace, values=None):
        assert space.ndofs == 1
        self.space = space
        self.values = space.zeros() if values is None else values

    def interpolate(self, expr) -> "P0Function":
        return P0Function(self.space, self.space.interpolate(expr))

    def assign(self, scalars, functions) -> "P0Function":
        vals = sum(s * f.values for s, f in zip(scalars, functions))
        return P0Function(self.space, vals)

    def dot_global(self, other: "P0Function"):
        return self.space.dot(self.values, other.values)

    def integral(self):
        return self.space.integral(self.values)


# -- conversions P1 <-> P0 (reference: gridtransferoperators P1toP0/P0toP1) ----


def p1_to_p0(p1_space, u_p1, vol_space: VolumeDoFSpace) -> jnp.ndarray:
    """Element value = mean of the element's vertex values."""
    assert vol_space.level == p1_space.level
    dim, n = vol_space.dim, vol_space.n
    if dim == 3:  # grid view of the flat P1 block (cold conversion path)
        from ..indexing import flat

        u_p1 = flat.to_grid(u_p1, p1_space.N, p1_space.pitch)[..., : p1_space.N]
    offs = micro.offsets(dim)
    parts = []
    for t in range(vol_space.T):
        acc = None
        for v in range(offs.shape[1]):
            o = offs[t, v]
            sl = (slice(None),) + tuple(slice(int(o[d]), int(o[d]) + n)
                                        for d in range(dim))
            r = u_p1[sl]
            acc = r if acc is None else acc + r
        parts.append(acc / offs.shape[1])
    out = jnp.stack(parts, axis=1)
    w = jnp.asarray(vol_space._valid_weight, dtype=u_p1.dtype)
    return out * w


def p0_to_p1(vol_space: VolumeDoFSpace, u_p0, p1_space, sd=None) -> jnp.ndarray:
    """Volume-weighted average of adjacent element values at each vertex."""
    dim, n = vol_space.dim, vol_space.n
    offs = micro.offsets(dim)
    vols = vol_space.elem_volumes
    N = p1_space.N
    gshape = ((vol_space.C_loc,) + (N,) * dim)
    num = jnp.zeros(gshape, dtype=u_p0.dtype)
    den = jnp.zeros(gshape, dtype=u_p0.dtype)
    for t in range(vol_space.T):
        contrib = u_p0[:, t] * vols[:, t]
        wgt = vols[:, t]
        for v in range(offs.shape[1]):
            o = offs[t, v]
            sl = (slice(None),) + tuple(slice(int(o[d]), int(o[d]) + n)
                                        for d in range(dim))
            num = num.at[sl].add(contrib)
            den = den.at[sl].add(wgt)
    if dim == 3:  # grid -> flat (cold conversion path)
        P = p1_space.pitch
        num = jnp.pad(num, [(0, 0), (0, 0), (0, 0), (0, P - N)]).reshape(
            num.shape[0], N, N * P)
        den = jnp.pad(den, [(0, 0), (0, 0), (0, 0), (0, P - N)]).reshape(
            den.shape[0], N, N * P)
    sd = p1_space.resolve_sd(sd)
    num = p1_space.exchange_add(num, sd)
    den = p1_space.exchange_add(den, sd)
    return jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)
