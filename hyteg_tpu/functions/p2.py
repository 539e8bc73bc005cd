"""P2 (quadratic Lagrange) function space on dense node grids.

Redesign of the reference's P2Function = VertexDoF + EdgeDoF
composition (reference: src/hyteg/p2functionspace/P2Function.hpp:38-77,
src/hyteg/edgedofspace/EdgeDoFFunction.hpp). Key observation: the micro-edge
midpoints of refinement level L are exactly the micro-vertices of level
L+1, so ALL P2 DoFs (vertex + 7 edge orientations) live on the dense
level-(L+1) node grid:

    even-parity nodes  <-> vertex DoFs
    odd-parity nodes   <-> edge DoFs (parity class == edge orientation:
                           (1,0,0)=X ... (1,1,1)=XYZ)

A P2 function is therefore *one* (C, M, M, M) block with M = 2^(L+1)+1 and
reuses the entire P1 level-(L+1) infrastructure — interface maps, additive/
replicating exchanges, boundary flags, dots, interpolation (P2 nodal
interpolation evaluates u at every node, exactly P1-style) — with zero new
communication code. The reference's separate EdgeDoF orientation tables and
PackInfos (src/hyteg/edgedofspace/EdgeDoFOrientation.hpp:29-39) collapse
into parity masks.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import BoundaryCondition, DoFType
from ..primitives.storage import CellStorage
from .p1 import P1Function, P1ShardData, P1Space


class P2Space:
    """Binds (storage, element level L); DoFs live on the L+1 node grid."""

    def __init__(self, storage: CellStorage, level: int, dtype=jnp.float32,
                 pitch: int | None = None):
        self.storage = storage
        self.level = level              # element refinement level
        self.node_space = P1Space(storage, level + 1, dtype, pitch=pitch)
        self.dtype = dtype
        self.dim = storage.dim
        self.n = 1 << level             # elements per macro-edge
        self.M = self.node_space.N      # node-grid points per macro-edge
        self.pitch = self.node_space.pitch

    # -- delegation to the node grid ----------------------------------------

    @property
    def block_shape(self):
        return self.node_space.block_shape

    def zeros(self):
        return self.node_space.zeros()

    def num_global_dofs(self) -> int:
        return self.node_space.num_global_dofs()

    def shard_data(self, shard: int, bc: BoundaryCondition) -> P1ShardData:
        return self.node_space.shard_data(shard, bc)

    def resolve_sd(self, sd_or_bc=None, shard: int = 0) -> P1ShardData:
        return self.node_space.resolve_sd(sd_or_bc, shard)

    def stacked_shard_data(self, bc: BoundaryCondition):
        return self.node_space.stacked_shard_data(bc)

    def exchange_add(self, u, sd=None, axis_name=None):
        return self.node_space.exchange_add(u, sd, axis_name)

    def exchange_rep(self, u, sd=None, axis_name=None):
        return self.node_space.exchange_rep(u, sd, axis_name)

    def dot(self, u, v, flag=DoFType.ALL, sd=None, axis_name=None):
        return self.node_space.dot(u, v, flag, sd, axis_name)

    def dof_sum(self, u, flag=DoFType.ALL, sd=None, axis_name=None):
        return self.node_space.dof_sum(u, flag, sd, axis_name)

    def dof_max(self, u, flag=DoFType.ALL, sd=None, axis_name=None):
        return self.node_space.dof_max(u, flag, sd, axis_name)

    def restore_rows(self, new, old, flag, sd=None):
        return self.node_space.restore_rows(new, old, flag, sd)

    def interpolate(self, expr, old, flag, sd=None, axis_name=None):
        """P2 nodal interpolation: evaluate at every node (vertices + edge
        midpoints) — identical to P1 interpolation on the node grid."""
        return self.node_space.interpolate(expr, old, flag, sd, axis_name)

    def coords(self, shard: int = 0):
        return self.node_space.coords(shard)

    def cell_vertices(self, shard: int = 0):
        return self.node_space.cell_vertices(shard)

    def global_ids(self, shard: int = 0):
        return self.node_space.global_ids(shard)

    def global_ids_grid(self, shard: int = 0):
        return self.node_space.global_ids_grid(shard)

    @functools.cached_property
    def vertex_mask(self) -> np.ndarray:
        return self.node_space.vertex_mask

    @functools.cached_property
    def interior_mask(self) -> np.ndarray:
        return self.node_space.interior_mask

    # -- parity views (VertexDoF / EdgeDoF decomposition) --------------------

    def _flat3(self, m: np.ndarray) -> np.ndarray:
        if self.dim == 3:
            from ..indexing import flat

            return flat.flatten_field(m, self.pitch)
        return m

    @functools.cached_property
    def vertexdof_mask(self) -> np.ndarray:
        """(M, lanes) bool — even-parity nodes (the P1 sub-function)."""
        grids = np.meshgrid(*([np.arange(self.M)] * self.dim), indexing="ij")
        even = np.ones_like(grids[0], dtype=bool)
        for g in grids:
            even &= g % 2 == 0
        return self._flat3(even) & self.vertex_mask

    @functools.cached_property
    def edgedof_mask(self) -> np.ndarray:
        return self.vertex_mask & ~self.vertexdof_mask

    def edgedof_orientation_mask(self, parity: tuple[int, ...]) -> np.ndarray:
        """Mask of one edge orientation (reference EdgeDoFOrientation):
        parity (1,0,0) = X edges, ..., (1,1,1) = XYZ diagonal edges."""
        grids = np.meshgrid(*([np.arange(self.M)] * self.dim), indexing="ij")
        m = np.ones_like(grids[0], dtype=bool)
        for g, p in zip(grids, parity):
            m &= g % 2 == p
        return self._flat3(m) & self.vertex_mask

    def p1_subspace(self) -> P1Space:
        """The level-L P1 space on the same lane pitch (vertex DoFs)."""
        return P1Space(self.storage, self.level, self.dtype, pitch=self.pitch)

    def vertexdof_view(self, u) -> jnp.ndarray:
        """(C, N_L, lanes_L) P1-level-L function (same pitch): the vertex
        DoFs of u. Masked to valid coarse positions (stride-2 lane slicing
        aliases padding lanes onto odd nodes; see operators/transfer.py)."""
        Nc = (1 << self.level) + 1
        if self.dim == 2:
            return u[:, ::2, ::2]
        from ..indexing import micro

        P = self.pitch
        Lc, Lu = Nc * P, (Nc - 1) * P + Nc
        v = u[:, : 2 * Nc - 1 : 2, : 2 * Lu - 1 : 2]
        if Lu < Lc:
            v = jnp.pad(v, [(0, 0), (0, 0), (0, Lc - Lu)])
        cvm = micro.vertex_mask_flat(self.level, 3, P)
        return v * jnp.asarray(cvm[None], dtype=v.dtype)

    def embed_p1(self, u_p1_levelL) -> jnp.ndarray:
        """Embed a P1 level-L function into P2 (exact: linear functions are
        quadratic; edge values = endpoint averages) — the reference's
        P1 -> P2 conversion (gridtransferoperators/P1toP2Conversion)."""
        from ..operators.transfer import P1Transfer

        tr = P1Transfer(self.p1_subspace(), self.node_space)
        return tr.prolongate_local(u_p1_levelL)

    def function(self, bc: BoundaryCondition | None = None) -> "P2Function":
        return P2Function(self.zeros(), self,
                          bc or BoundaryCondition.all_dirichlet())


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class P2Function:
    """User-facing P2 handle (same surface as P1Function)."""

    cells: jnp.ndarray
    space: P2Space = dataclasses.field(metadata=dict(static=True))
    bc: BoundaryCondition = dataclasses.field(metadata=dict(static=True))

    def tree_flatten(self):
        return (self.cells,), (self.space, self.bc)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    def _like(self, cells):
        return P2Function(cells, self.space, self.bc)

    def _sd(self):
        return self.space.shard_data(0, self.bc)

    def assign(self, scalars, functions, flag: DoFType = DoFType.ALL):
        new = sum(s * f.cells for s, f in zip(scalars, functions))
        if flag == DoFType.ALL:
            return self._like(new)
        return self._like(self.space.restore_rows(new, self.cells, flag, self._sd()))

    def interpolate(self, expr, flag: DoFType = DoFType.ALL):
        return self._like(self.space.interpolate(expr, self.cells, flag, self._sd()))

    def dot_global(self, other, flag: DoFType = DoFType.ALL):
        return self.space.dot(self.cells, other.cells, flag, self._sd())

    def sum_global(self, flag: DoFType = DoFType.ALL):
        return self.space.dof_sum(self.cells, flag, self._sd())

    def max_global(self, flag: DoFType = DoFType.ALL):
        return self.space.dof_max(self.cells, flag, self._sd())

    def norm(self, flag: DoFType = DoFType.ALL):
        return jnp.sqrt(self.dot_global(self, flag))
