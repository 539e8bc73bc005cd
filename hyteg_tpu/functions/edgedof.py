"""Standalone EdgeDoF function space (one scalar DoF per micro-edge).

Equivalent of the reference's EdgeDoFFunction
(reference: src/hyteg/edgedofspace/EdgeDoFFunction.hpp, orientations
src/hyteg/edgedofspace/EdgeDoFOrientation.hpp:29-39 — X, Y, Z, XY, XZ, YZ,
XYZ). As with P2 (see functions/p2.py) and N1E1 (functions/n1e1.py), edge
midpoints are the odd-parity nodes of the level-(L+1) node grid, so an
EdgeDoF function is one (C, M...) block masked to odd nodes, with the parity
class playing the role of the reference's orientation enum, and all
communication reusing the P1 level-(L+1) interface machinery.

Unlike N1E1 the DoFs are plain scalars (no orientation sign)."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import BoundaryCondition, DoFType
from ..primitives.storage import CellStorage
from .n1e1 import parities
from .p1 import P1ShardData, P1Space


class EdgeDoFSpace:
    """Binds (storage, element level L); DoFs on odd nodes of the L+1 grid."""

    def __init__(self, storage: CellStorage, level: int, dtype=jnp.float32):
        self.storage = storage
        self.level = level
        self.node_space = P1Space(storage, level + 1, dtype)
        self.dtype = dtype
        self.dim = storage.dim
        self.n = 1 << level
        self.M = self.node_space.N

    @property
    def block_shape(self):
        return self.node_space.block_shape

    def zeros(self):
        return self.node_space.zeros()

    def shard_data(self, shard: int, bc: BoundaryCondition) -> P1ShardData:
        return self.node_space.shard_data(shard, bc)

    def resolve_sd(self, sd_or_bc=None, shard: int = 0) -> P1ShardData:
        return self.node_space.resolve_sd(sd_or_bc, shard)

    def exchange_add(self, u, sd=None, axis_name=None):
        return self.node_space.exchange_add(u, sd, axis_name)

    def exchange_rep(self, u, sd=None, axis_name=None):
        return self.node_space.exchange_rep(u, sd, axis_name)

    def restore_rows(self, new, old, flag, sd=None):
        return self.node_space.restore_rows(new, old, flag, sd)

    # -- orientation masks ----------------------------------------------------

    @functools.cached_property
    def orientation_masks(self) -> np.ndarray:
        """(P, M, lanes) bool — one mask per edge orientation (parity class)."""
        pars = parities(self.dim)
        grids = np.meshgrid(*([np.arange(self.M)] * self.dim), indexing="ij")
        vm = self.node_space.vertex_mask
        out = []
        for p in pars:
            m = np.ones_like(grids[0], dtype=bool)
            for g, pi in zip(grids, p):
                m &= g % 2 == int(pi)
            if self.dim == 3:
                from ..indexing import flat

                m = flat.flatten_field(m, self.node_space.pitch)
            out.append(m & vm)
        return np.stack(out)

    @functools.cached_property
    def edge_mask(self) -> np.ndarray:
        return self.orientation_masks.any(axis=0)

    def num_global_dofs(self) -> int:
        coarse = P1Space(self.storage, self.level, self.dtype)
        return self.node_space.num_global_dofs() - coarse.num_global_dofs()

    # -- ops (masked to edge DoFs) ---------------------------------------------

    def _edge_weight(self, dtype) -> jnp.ndarray:
        return jnp.asarray(self.edge_mask[None], dtype=dtype)

    def interpolate(self, expr, sd=None, shard: int = 0) -> jnp.ndarray:
        """Evaluate ``expr`` at every edge midpoint (reference EdgeDoF
        interpolate semantics: value at the micro-edge center)."""
        sd = self.resolve_sd(sd, shard)
        if callable(expr):
            vals = jnp.asarray(
                expr(self.node_space.coords_from(sd.cell_vertices)),
                dtype=self.dtype)
        else:
            vals = jnp.full(self.block_shape, expr, dtype=self.dtype)
        return vals * self._edge_weight(self.dtype)

    def dot(self, u, v, flag=DoFType.ALL, sd=None, axis_name=None):
        """Global dot counting every edge DoF once (zero even nodes make the
        node-grid dot exact on edge-masked inputs)."""
        w = self._edge_weight(u.dtype)
        return self.node_space.dot(u * w, v * w, flag, sd, axis_name)

    def dof_sum(self, u, flag=DoFType.ALL, sd=None, axis_name=None):
        return self.dot(u, jnp.ones_like(u), flag, sd, axis_name)

    def function(self, bc: BoundaryCondition | None = None) -> "EdgeDoFFunction":
        return EdgeDoFFunction(self.zeros(), self,
                               bc or BoundaryCondition.all_dirichlet())


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class EdgeDoFFunction:
    """User-facing EdgeDoF handle (reference: EdgeDoFFunction)."""

    cells: jnp.ndarray
    space: EdgeDoFSpace = dataclasses.field(metadata=dict(static=True))
    bc: BoundaryCondition = dataclasses.field(metadata=dict(static=True))

    def tree_flatten(self):
        return (self.cells,), (self.space, self.bc)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    def _sd(self):
        return self.space.shard_data(0, self.bc)

    def interpolate(self, expr) -> "EdgeDoFFunction":
        return EdgeDoFFunction(
            self.space.interpolate(expr, self._sd()), self.space, self.bc)

    def assign(self, scalars, functions) -> "EdgeDoFFunction":
        vals = sum(s * f.cells for s, f in zip(scalars, functions))
        return EdgeDoFFunction(vals, self.space, self.bc)

    def dot_global(self, other: "EdgeDoFFunction", flag=DoFType.ALL):
        return self.space.dot(self.cells, other.cells, flag, self._sd())

    def sum_global(self, flag=DoFType.ALL):
        return self.space.dof_sum(self.cells, flag, self._sd())
