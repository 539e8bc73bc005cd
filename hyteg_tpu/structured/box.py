"""BoxDomain: a box-structured Kuhn-tet macro aggregated into one grid.

The analog of the reference's structured cuboid meshes
(reference: src/hyteg/mesh/MeshInfo.hpp meshCuboid + SetupPrimitiveStorage):
instead of 6*mx*my*mz macro-tets with padded per-tet blocks and interface
exchange, the whole domain is ONE dense node grid

    block shape (X, Y*Z),  X = mx*2^l + 1, lane = y*Z + z

with every global DoF stored exactly once: no interface duplication, no
halo exchange on a single chip, no multiplicity bookkeeping in dots.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class BoxDomain:
    """Structured grid of mx*my*mz unit cubes at refinement ``level``,
    physically spanning [0, ax] x [0, ay] x [0, az]."""

    m: tuple[int, int, int]
    level: int
    extent: tuple[float, float, float] = (1.0, 1.0, 1.0)
    dtype: str = "float32"

    @property
    def dims(self) -> tuple[int, int, int]:
        s = 1 << self.level
        return tuple(mi * s + 1 for mi in self.m)

    @property
    def h(self) -> tuple[float, float, float]:
        s = 1 << self.level
        return tuple(a / (mi * s) for a, mi in zip(self.extent, self.m))

    @property
    def X(self) -> int:
        return self.dims[0]

    @property
    def L(self) -> int:
        _, Y, Z = self.dims
        return Y * Z

    @property
    def block_shape(self) -> tuple[int, int]:
        return (self.X, self.L)

    def num_dofs(self) -> int:
        X, Y, Z = self.dims
        return X * Y * Z

    def coarse(self) -> "BoxDomain":
        assert self.level > 0
        return BoxDomain(self.m, self.level - 1, self.extent, self.dtype)

    # -- coordinates / fields -------------------------------------------------

    @functools.cached_property
    def lane_yz(self) -> tuple[np.ndarray, np.ndarray]:
        """Static per-lane (y, z) index maps, each (L,) int32."""
        _, Y, Z = self.dims
        return (np.repeat(np.arange(Y, dtype=np.int32), Z),
                np.tile(np.arange(Z, dtype=np.int32), Y))

    @functools.cached_property
    def coords(self) -> np.ndarray:
        """(3, X, L) float32 physical node coordinates."""
        X, Y, Z = self.dims
        hx, hy, hz = self.h
        y, z = self.lane_yz
        cx = np.broadcast_to((np.arange(X) * hx)[:, None], (X, self.L))
        cy = np.broadcast_to((y * hy)[None, :], (X, self.L))
        cz = np.broadcast_to((z * hz)[None, :], (X, self.L))
        return np.stack([cx, cy, cz]).astype(np.float32)

    def interpolate(self, fn) -> jnp.ndarray:
        """Nodal interpolation of fn(x, y, z)."""
        c = self.coords
        return jnp.asarray(fn(c[0], c[1], c[2]), dtype=self.dtype)

    # -- masks ---------------------------------------------------------------

    @functools.cached_property
    def boundary_mask(self) -> np.ndarray:
        """(X, L) float32: 1 on the 6 domain boundary faces."""
        X, Y, Z = self.dims
        y, z = self.lane_yz
        lane_bnd = (y == 0) | (y == Y - 1) | (z == 0) | (z == Z - 1)
        m = np.broadcast_to(lane_bnd[None, :], (X, self.L)).copy()
        m[0, :] = True
        m[X - 1, :] = True
        return m.astype(np.float32)

    @functools.cached_property
    def interior_mask(self) -> np.ndarray:
        return (1.0 - self.boundary_mask).astype(np.float32)

    def interior_mask_traced(self) -> jnp.ndarray:
        """Interior mask built in-trace from an iota plus an (L,)-sized
        lane constant — at 1e9 DoFs the materialized (X, L) mask is a
        4.3 GB captured constant in every jit using it; this form costs
        one fused broadcast."""
        X, Y, Z = self.dims
        y, z = self.lane_yz
        lane_in = jnp.asarray(
            (y > 0) & (y < Y - 1) & (z > 0) & (z < Z - 1))
        xs = jnp.arange(X)
        inner = ((xs > 0) & (xs < X - 1))[:, None] & lane_in[None, :]
        return inner.astype(self.dtype)

    def zeros(self) -> jnp.ndarray:
        return jnp.zeros(self.block_shape, dtype=self.dtype)

    # -- reductions (every DoF stored exactly once) ---------------------------

    def dot(self, u, v, interior_only: bool = False):
        if interior_only:
            w = jnp.asarray(self.interior_mask, dtype=u.dtype)
            return jnp.sum(u * v * w)
        return jnp.sum(u * v)

    def norm(self, u, interior_only: bool = False):
        return jnp.sqrt(self.dot(u, u, interior_only))
