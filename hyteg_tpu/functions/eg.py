"""EG (enriched Galerkin) function space: [P1]^dim + P0 enrichment.

Redesign of the reference's EG space
(reference: src/hyteg/egfunctionspace/EGFunction.hpp and the generated
Nitsche forms under egfunctionspace/): a vector-valued function

    u = u_CG + c_T psi_T,     psi_T(x) = x - m_T   (per element T)

with continuous [P1]^dim part (P1 node grids, one block per component)
and a discontinuous scalar enrichment coefficient per micro-element
(VolumeDoF/P0 layout).  The enrichment restores local mass conservation
for Stokes at P0 pressure; its DG coupling lives in
operators/eg_ops.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import BoundaryCondition, DoFType
from ..primitives.storage import CellStorage
from .p1 import P1Space
from .volume import VolumeDoFSpace


class EGSpace:
    """Bundle of the vector P1 space and the P0 enrichment space."""

    def __init__(self, storage: CellStorage, level: int, dtype=jnp.float32):
        self.storage = storage
        self.level = level
        self.dim = storage.dim
        self.p1 = P1Space(storage, level, dtype)
        self.p0 = VolumeDoFSpace(storage, level, ndofs=1, dtype=dtype)
        self.dtype = dtype

    def zeros(self) -> "EGFunction":
        return EGFunction(
            tuple(self.p1.zeros() for _ in range(self.dim)),
            self.p0.zeros(), self)

    def interpolate(self, fns, bc: BoundaryCondition | None = None,
                    flag: DoFType = DoFType.ALL) -> "EGFunction":
        """Nodal interpolation of the CG part (enrichment set to 0 — the
        canonical interpolant of the reference's EGFunction)."""
        bc = bc or BoundaryCondition.all_dirichlet()
        sd = self.p1.resolve_sd(bc)
        vel = tuple(
            self.p1.interpolate(lambda p, d=d: fns[d](p), self.p1.zeros(),
                                flag, sd)
            for d in range(self.dim))
        return EGFunction(vel, self.p0.zeros(), self)

    def dot(self, a: "EGFunction", b: "EGFunction",
            flag: DoFType = DoFType.ALL) -> jnp.ndarray:
        acc = jnp.asarray(0.0, self.dtype)
        sd = self.p1.resolve_sd(None)
        for d in range(self.dim):
            acc = acc + self.p1.dot(a.vel[d], b.vel[d], flag, sd)
        return acc + self.p0.dot(a.enr, b.enr)

    def norm(self, a: "EGFunction", flag: DoFType = DoFType.ALL):
        return jnp.sqrt(self.dot(a, a, flag))

    def num_global_dofs(self) -> int:
        return (self.dim * self.p1.num_global_dofs()
                + self.p0.num_global_dofs())


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class EGFunction:
    """vel: tuple of dim P1 blocks; enr: (C, T, n, ...) P0 block."""

    vel: tuple
    enr: jnp.ndarray
    space: EGSpace = dataclasses.field(metadata=dict(static=True))

    def tree_flatten(self):
        return (self.vel, self.enr), (self.space,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])

    def __add__(self, o):
        return EGFunction(tuple(a + b for a, b in zip(self.vel, o.vel)),
                          self.enr + o.enr, self.space)

    def __sub__(self, o):
        return EGFunction(tuple(a - b for a, b in zip(self.vel, o.vel)),
                          self.enr - o.enr, self.space)

    def __mul__(self, s):
        return EGFunction(tuple(s * a for a in self.vel), s * self.enr,
                          self.space)

    __rmul__ = __mul__
