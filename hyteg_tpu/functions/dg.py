"""DG1 (discontinuous piecewise-linear) function space.

Equivalent of the reference's DGFunction/DG1Function
(reference: src/hyteg/dgfunctionspace/DGFunction.hpp,
src/hyteg/dg1functionspace/DG1Function.hpp). A DG1 function stores
``nv = dim+1`` nodal values (at the element's vertices) per micro-element in
a VolumeDoF block (C, T, n..., nv) — no inter-element continuity, no
interface replication; facet coupling is done by the DG operators
(operators/dg_ops.py) via class-neighbor shifts."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..indexing import micro
from ..primitives.storage import CellStorage
from .volume import VolumeDoFSpace


class DG1Space(VolumeDoFSpace):
    """VolumeDoF space with one DoF per element vertex."""

    def __init__(self, storage: CellStorage, level: int, dtype=jnp.float32):
        super().__init__(storage, level, ndofs=storage.dim + 1, dtype=dtype)

    def interpolate(self, expr) -> jnp.ndarray:
        """Nodal interpolation: evaluate at every element vertex."""
        if not callable(expr):
            return super().interpolate(expr)
        verts = self.elem_vertices()  # (C, T, n..., nv, dim)
        vals = jnp.asarray(expr(verts), dtype=self.dtype)
        w = jnp.asarray(self._valid_weight, dtype=self.dtype)[..., None]
        return vals * w

    def integral(self, u) -> jnp.ndarray:
        """Exact integral of the piecewise-linear field: |K| * mean(nodal)."""
        return jnp.sum(self.elem_volumes[..., None] * u) / self.ndofs

    @functools.cached_property
    def mass_elmats(self) -> jnp.ndarray:
        """(C, T, nv, nv) block-diagonal DG1 mass matrices (exact)."""
        nv = self.ndofs
        denom = 20.0 if self.dim == 3 else 12.0
        base = (np.ones((nv, nv)) + np.eye(nv)) / denom
        vols = self.elem_volumes  # (C, T, n...)
        # volumes are constant per (cell, class); take the base element
        v0 = vols[(slice(None), slice(None)) + (0,) * self.dim]
        return v0[..., None, None] * jnp.asarray(base, dtype=self.dtype)

    def mass_apply(self, u) -> jnp.ndarray:
        m = self.mass_elmats  # (C, T, nv, nv)
        shape = u.shape
        ue = u.reshape(shape[: 2] + (-1, self.ndofs))
        me = jnp.einsum("ctab,ctkb->ctka", m, ue)
        return me.reshape(shape)

    def inverse_mass_apply(self, u) -> jnp.ndarray:
        m = np.asarray(self.mass_elmats)
        sel = np.abs(np.linalg.det(m)) > 1e-300
        minv = np.zeros_like(m)
        minv[sel] = np.linalg.inv(m[sel])
        mi = jnp.asarray(minv, dtype=self.dtype)
        shape = u.shape
        ue = u.reshape(shape[: 2] + (-1, self.ndofs))
        me = jnp.einsum("ctab,ctkb->ctka", mi, ue)
        return me.reshape(shape)


def p1_to_dg1(p1_space, u_p1, dg: DG1Space) -> jnp.ndarray:
    """Exact embedding P1 -> DG1 (reference: P1toDG conversion): element
    vertex value = P1 value at that micro-vertex."""
    assert dg.level == p1_space.level
    dim, n = dg.dim, dg.n
    if dim == 3:  # grid view of the flat P1 block (cold conversion path)
        from ..indexing import flat

        u_p1 = flat.to_grid(u_p1, p1_space.N, p1_space.pitch)[..., : p1_space.N]
    offs = micro.offsets(dim)
    parts = []
    for t in range(dg.T):
        vals = []
        for v in range(offs.shape[1]):
            o = offs[t, v]
            sl = (slice(None),) + tuple(
                slice(int(o[d]), int(o[d]) + n) for d in range(dim))
            vals.append(u_p1[sl])
        parts.append(jnp.stack(vals, axis=-1))
    out = jnp.stack(parts, axis=1)
    w = jnp.asarray(dg._valid_weight, dtype=u_p1.dtype)[..., None]
    return out * w


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DG1Function:
    """User-facing DG1 handle (reference: DG1Function)."""

    values: jnp.ndarray
    space: DG1Space = dataclasses.field(metadata=dict(static=True))

    def tree_flatten(self):
        return (self.values,), (self.space,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])

    def interpolate(self, expr) -> "DG1Function":
        return DG1Function(self.space.interpolate(expr), self.space)

    def assign(self, scalars, functions) -> "DG1Function":
        return DG1Function(
            sum(s * f.values for s, f in zip(scalars, functions)), self.space)

    def dot_global(self, other: "DG1Function"):
        return self.space.dot(self.values, other.values)

    def integral(self):
        return self.space.integral(self.values)
