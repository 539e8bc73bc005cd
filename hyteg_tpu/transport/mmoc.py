"""Semi-Lagrangian (MMOC) advection — the reference's Eulerian–Lagrangian
transport, redesigned without particles.

Reference: src/coupling_hyteg_convection_particles/MMOCTransport.hpp:1321-1390
seeds one particle per DoF, integrates it backwards through the velocity
field with RK schemes (migrating particles between MPI ranks as they cross
macro-cell boundaries), then interpolates the old field at the departure
points. Here the same math needs no particles and no migration: departure
points for *all* DoF nodes are integrated in one batched computation, and
the old field is evaluated at all of them with the batched point locator
(functions/evaluate.py) — crossing macro-cell boundaries is just a different
argmax in the locator. Everything is jit-compatible static-shape code.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from ..core.types import BoundaryCondition, DoFType
from ..functions.evaluate import FieldEvaluator
from ..primitives.storage import CellStorage

# Butcher tableaus (explicit): reference MMOCTransport TimeSteppingScheme
_RK = {
    1: ([], [1.0]),                                          # explicit Euler
    2: ([[0.5]], [0.0, 1.0]),                                # midpoint
    3: ([[0.5], [-1.0, 2.0]], [1 / 6, 2 / 3, 1 / 6]),        # Kutta RK3
    4: ([[0.5], [0.0, 0.5], [0.0, 0.0, 1.0]],
        [1 / 6, 1 / 3, 1 / 3, 1 / 6]),                       # classic RK4
}


class MMOCTransport:
    """Semi-Lagrangian advection of a scalar P1/P2 field.

    ``degree``: polynomial degree of the transported field c.
    ``vel_degree``: degree of the velocity components (P2 for Taylor-Hood).
    """

    def __init__(self, storage: CellStorage, level: int, degree: int = 2,
                 vel_degree: int = 2, dtype=jnp.float32):
        self.storage = storage
        self.level = level
        self.dim = storage.dim
        self.degree = degree
        self.eval_c = FieldEvaluator(storage, level, degree, dtype)
        self.eval_v = (self.eval_c if vel_degree == degree
                       else FieldEvaluator(storage, level, vel_degree, dtype))
        # node coordinates of the transported field's grid
        if degree == 2:
            from ..functions.p2 import P2Space

            self.space = P2Space(storage, level, dtype)
            self._node_space = self.space.node_space
        else:
            from ..functions.p1 import P1Space

            self.space = P1Space(storage, level, dtype)
            self._node_space = self.space
        self.dtype = dtype

    @functools.cached_property
    def _node_coords_flat(self) -> jnp.ndarray:
        """(Q, dim) physical coordinates of every node slot (Q = C * N^dim)."""
        xyz = self._node_space.coords()  # (C, N..., 3)
        return xyz.reshape(-1, 3)[:, : self.dim]

    def _vel_at(self, vel_blocks, pts) -> jnp.ndarray:
        """vel_blocks: (dim, C, Nv...) stacked components -> (Q, dim)."""
        return self.eval_v.evaluate(vel_blocks, pts).T

    def departure_points(self, vel_blocks, dt, rk: int = 4,
                         substeps: int = 1) -> jnp.ndarray:
        """Backtrack every node through the (frozen) velocity field."""
        a_rows, b = _RK[rk]
        h = dt / substeps
        x = self._node_coords_flat

        def one_substep(x, _):
            ks = []
            for i in range(len(b)):
                xi = x
                if i > 0:
                    for j, a in enumerate(a_rows[i - 1]):
                        if a != 0.0:
                            xi = xi - h * a * ks[j]
                ks.append(self._vel_at(vel_blocks, xi))
            xn = x
            for bi, ki in zip(b, ks):
                if bi != 0.0:
                    xn = xn - h * bi * ki
            return xn, None

        x, _ = jax.lax.scan(one_substep, x, None, length=substeps)
        return x

    def step(self, c, vel: Sequence, dt, rk: int = 4, substeps: int = 1,
             bc: BoundaryCondition | None = None,
             dirichlet_from=None) -> jnp.ndarray:
        """One MMOC step: c(x, t+dt) = c(x_departure, t).

        ``vel``: sequence of dim velocity component blocks (vel_degree grid).
        ``dirichlet_from``: block providing values on Dirichlet rows
        (defaults to the pre-step c — inflow keeps its boundary value).
        """
        sp = self.space
        vel_blocks = jnp.stack(list(vel), axis=0)
        xd = self.departure_points(vel_blocks, dt, rk, substeps)
        new = self.eval_c.evaluate(c, xd).reshape(c.shape)
        # zero the padding outside each macro simplex, sync interface replicas
        mask = jnp.asarray(self._node_space.vertex_mask[None], dtype=c.dtype)
        new = new * mask
        sd = sp.resolve_sd(bc)
        if self.storage.num_shards == 1:
            new = sp.exchange_rep(new, sd)
        old = c if dirichlet_from is None else dirichlet_from
        return sp.restore_rows(
            new, old, DoFType.INNER | DoFType.NEUMANN | DoFType.FREESLIP, sd
        )

    def mass_fix(self, c_new, c_old, mass_dot: Callable) -> jnp.ndarray:
        """Global multiplicative mass-conservation fixup (the reference's
        local volume-fraction fixups collapse to a single global correction
        factor; reference: MMOCTransport mass-conservation modes)."""
        ones = jnp.ones_like(c_new)
        m_new = mass_dot(c_new, ones)
        m_old = mass_dot(c_old, ones)
        scale = jnp.where(m_new == 0, 1.0, m_old / jnp.where(m_new == 0, 1.0, m_new))
        return c_new * scale
