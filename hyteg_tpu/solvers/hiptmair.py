"""Hiptmair hybrid smoother for H(curl) (N1E1) problems.

Redesign of the reference's HybridSmoother
(reference: src/mixed_operator/HybridSmoother.hpp): point smoothing in the
edge space is blind to the large gradient kernel of the curl-curl operator,
so each sweep adds a correction in the potential space,

    x <- x + omega_e D_A^{-1} (b - A x)                 (edge relaxation)
    r <- b - A x
    q <- omega_v D_{G^T A G}^{-1} (G^T r)               (potential relaxation)
    x <- x + G q

with G the discrete gradient P1 -> N1E1. The reference plugs arbitrary
sub-smoothers into both halves; here both are weighted Jacobi (the
data-parallel choice; Chebyshev acceleration composes on top).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..core.types import DoFType, FLAG_INNER
from ..functions.n1e1 import N1E1Space
from ..operators.n1e1_ops import N1E1ElementwiseOperator


def _varying_seed(shape) -> jnp.ndarray:
    """Deterministic oscillating field for power iterations (no RNG
    inside setup jits; must not be orthogonal to the dominant mode)."""
    c = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    r = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    l = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    return jnp.sin(0.7 * c.astype(jnp.float32)
                   + 1.3 * r.astype(jnp.float32)
                   + 2.1 * l.astype(jnp.float32)) + 0.01


class HiptmairSmoother:
    """Multiplicative two-space smoother bound to an N1E1 operator."""

    def __init__(self, op: N1E1ElementwiseOperator, sd=None,
                 omega_edge: float | None = None,
                 omega_vertex: float | None = None,
                 flag: DoFType = FLAG_INNER, power_iters: int = 15):
        self.op = op
        self.space: N1E1Space = op.space
        self.sd = self.space.resolve_sd(sd)
        self.flag = flag
        self.inv_diag_e = op.inverse_diagonal(self.sd)
        self.inv_diag_v = op.potential_inverse_diagonal(self.sd)
        # fixed omega = 2/3 diverges once lambda_max(D^-1 A) > 3 (observed
        # at level >= 2 for curl-curl); damp each half against its own
        # power-iterated spectral bound: omega = 4 / (3 lambda_max)
        if omega_edge is None:
            lam_e = self._power_edge(power_iters)
            omega_edge = 4.0 / (3.0 * max(lam_e, 1e-6))
        if omega_vertex is None:
            lam_v = self._power_vertex(power_iters)
            omega_vertex = 4.0 / (3.0 * max(lam_v, 1e-6))
        self.omega_e = omega_edge
        self.omega_v = omega_vertex

    def _power_edge(self, iters: int) -> float:
        sp, op, sd = self.space, self.op, self.sd

        @jax.jit
        def run():
            x = _varying_seed(sp.block_shape) * jnp.asarray(
                sp.edge_mask[None], dtype=jnp.float32)

            def body(_, x):
                y = self._masked(self.inv_diag_e * op.apply_raw(x, sd))
                return y / jnp.maximum(jnp.sqrt(sp.dot(y, y)), 1e-30)

            x = jax.lax.fori_loop(0, iters, body, x)
            y = self._masked(self.inv_diag_e * op.apply_raw(x, sd))
            return sp.dot(x, y) / jnp.maximum(sp.dot(x, x), 1e-30)

        return float(run())

    def _power_vertex(self, iters: int) -> float:
        sp, op, sd = self.space, self.op, self.sd

        def AtGA(q):
            r = op.apply_raw(sp.gradient_apply(q), sd)
            return self._masked(
                self.inv_diag_v
                * sp.exchange_add(sp.gradient_transpose_apply(r, sd), sd))

        @jax.jit
        def run():
            # varying seed: the constant potential is in the null space of
            # G^T A G — a flat seed collapses the iteration to zero
            x = _varying_seed(sp.block_shape) * jnp.asarray(
                sp.vertexnode_mask[None], dtype=jnp.float32)

            def body(_, x):
                y = AtGA(x)
                return y / jnp.maximum(jnp.sqrt(sp.dot(y, y)), 1e-30)

            x = jax.lax.fori_loop(0, iters, body, x)
            y = AtGA(x)
            return sp.dot(x, y) / jnp.maximum(sp.dot(x, x), 1e-30)

        return float(run())

    def _masked(self, upd):
        z = jnp.zeros_like(upd)
        return self.space.restore_rows(upd, z, self.flag, self.sd)

    def smooth(self, x, b, num_sweeps: int = 1):
        """Symmetric multiplicative sweep: edge -> potential -> edge."""
        sp, op, sd = self.space, self.op, self.sd

        def edge(x):
            r = b - op.apply_raw(x, sd)
            return x + self._masked(self.omega_e * self.inv_diag_e * r)

        def body(_, x):
            x = edge(x)
            r = b - op.apply_raw(x, sd)
            rv = sp.exchange_add(sp.gradient_transpose_apply(r, sd), sd)
            q = self._masked(self.omega_v * self.inv_diag_v * rv)
            return edge(x + sp.gradient_apply(q))

        return jax.lax.fori_loop(0, num_sweeps, body, x)

    def as_preconditioner(self) -> Callable:
        """Symmetric (additive) Hiptmair preconditioner for CG/MinRes:
        M^{-1} = D_A^{-1} + G D_{G^T A G}^{-1} G^T (SPD by construction)."""
        sp, sd = self.space, self.sd

        def prec(r):
            xe = self._masked(self.inv_diag_e * r)
            rv = sp.exchange_add(sp.gradient_transpose_apply(r, sd), sd)
            q = self._masked(self.inv_diag_v * rv)
            return xe + sp.gradient_apply(q)

        return prec
