"""Plate-velocity surface boundary conditions for mantle convection.

Equivalent of the reference's plate module
(reference: src/terraneo/plates/PlateVelocityProvider.hpp — plate
reconstruction surface BCs with rotations and boundary smoothing). The
reference reads GPlates reconstruction files; here the same API is served
by an analytic plate model: the sphere surface is partitioned into plates
by nearest seed direction (a spherical Voronoi diagram), each plate moves
as a rigid rotation v = omega x x about its Euler pole, and velocities are
blended across plate boundaries with a smooth distance weight (the
reference smooths reconstructed velocities near plate boundaries the same
way). Stages (time keys) give piecewise-constant-in-time plate stages like
the reference's reconstruction ages."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class PlateStage:
    """One reconstruction stage: seed directions (P, 3) on the unit sphere
    and Euler rotation vectors (P, 3) (rad / time unit)."""

    seeds: np.ndarray
    omegas: np.ndarray
    age: float = 0.0


def synthetic_stage(num_plates: int = 6, seed: int = 0,
                    max_rate: float = 1.0, age: float = 0.0) -> PlateStage:
    """Random plate layout (deterministic in ``seed``)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(num_plates, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    om = rng.normal(size=(num_plates, 3))
    om *= max_rate / np.maximum(np.linalg.norm(om, axis=-1, keepdims=True),
                                1e-12)
    return PlateStage(seeds=v, omegas=om, age=age)


class PlateVelocityProvider:
    """Surface velocity provider (reference: plates::PlateVelocityProvider).

    ``smoothing``: angular half-width (radians) of the soft-min blend across
    plate boundaries; 0 gives hard (discontinuous) plate edges."""

    def __init__(self, stages: list[PlateStage], smoothing: float = 0.05):
        assert stages, "need at least one plate stage"
        self.stages = sorted(stages, key=lambda s: s.age)
        self.smoothing = float(smoothing)

    def _stage_at(self, age: float) -> PlateStage:
        """Piecewise-constant stage lookup (latest stage with s.age <= age)."""
        best = self.stages[0]
        for s in self.stages:
            if s.age <= age:
                best = s
        return best

    def velocity(self, x, age: float = 0.0) -> jnp.ndarray:
        """(..., 3) positions -> (..., 3) plate velocities (tangential).

        Velocities scale linearly with |x| (rigid rotation), so the same
        provider serves any sphere radius."""
        st = self._stage_at(age)
        seeds = jnp.asarray(st.seeds, dtype=x.dtype)      # (P, 3)
        omegas = jnp.asarray(st.omegas, dtype=x.dtype)    # (P, 3)
        r = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
        xhat = x / jnp.where(r == 0, 1.0, r)
        # angular distance to each plate seed
        cosd = jnp.clip(jnp.einsum("...d,pd->...p", xhat, seeds), -1.0, 1.0)
        ang = jnp.arccos(cosd)                            # (..., P)
        if self.smoothing > 0:
            w = jax_softmin(ang, self.smoothing)
        else:
            w = (ang == jnp.min(ang, axis=-1, keepdims=True)).astype(x.dtype)
            w = w / jnp.sum(w, axis=-1, keepdims=True)
        v_each = jnp.cross(
            jnp.broadcast_to(omegas, x.shape[:-1] + omegas.shape),
            x[..., None, :])                              # (..., P, 3)
        return jnp.sum(w[..., None] * v_each, axis=-2)

    def rms_velocity(self, x, age: float = 0.0) -> jnp.ndarray:
        v = self.velocity(x, age)
        return jnp.sqrt(jnp.mean(jnp.sum(v * v, axis=-1)))


def jax_softmin(ang, width):
    """Distance-softmin weights: exp(-(d - d_min)/width), normalized."""
    dmin = jnp.min(ang, axis=-1, keepdims=True)
    w = jnp.exp(-(ang - dmin) / width)
    return w / jnp.sum(w, axis=-1, keepdims=True)
