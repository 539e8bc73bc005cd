"""Inexact Uzawa smoother + Stokes GMG assembly.

Reference: src/hyteg/solvers/UzawaSmoother.hpp:99-481 and the
stokesSphere/scaling-workshop solver stack (apps/2020-scaling-workshop/
Helpers.cpp:103-173): GMG V-cycles on the P2-P1 block system with an
inexact Uzawa smoother (velocity sub-smoother on the viscous block, lumped
pressure-mass update) and a MINRES coarse solve. The sequential
Gauss-Seidel velocity sweeps of the reference become Chebyshev/Jacobi
sweeps (data-parallel)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..composites.stokes import P2P1TaylorHoodStokes, TaylorHoodVec
from ..core.types import BoundaryCondition, DoFType, FLAG_INNER
from ..operators import forms
from ..operators.p1_elementwise import P1ElementwiseOperator
from ..operators.p2_transfer import P2Transfer
from ..operators.transfer import P1Transfer
from .gmg import GeometricMultigridSolver, GMGLevel
from .krylov import minres_solve
from .smoothers import chebyshev_smooth, estimate_spectral_radius


class UzawaSmoother:
    """One inexact-Uzawa sweep on the Stokes system.

    Fully traceable (no host concretization): ``eig_max`` stays a traced
    scalar, so the smoother can be constructed inside jit / shard_map
    (reference: UzawaSmoother.hpp:99; the damping estimation is the
    spectral-radius power iteration of ChebyshevSmoother.hpp:558-717).
    The velocity half-step smooths the full (possibly component-coupled
    epsilon) viscous block with Chebyshev over the stacked components.
    """

    def __init__(self, stokes: P2P1TaylorHoodStokes, flag: DoFType = FLAG_INNER,
                 vel_smooth_order: int = 3, omega_p: float = 0.3,
                 eig_max=None, axis_name=None):
        self.st = stokes
        self.flag = flag
        self.order = vel_smooth_order
        self.omega_p = omega_p
        self.axis_name = axis_name
        st = stokes
        self.k_invdiag = jnp.stack(
            st.K_inverse_diagonal(axis_name=axis_name))
        pmass = P1ElementwiseOperator.from_shard_data(
            st.pre_space, forms.mass_form, st._pre_sd)
        self.pmass_inv = pmass.lumped_inverse_diagonal(sd=st._pre_sd,
                                                       axis_name=axis_name)
        if eig_max is None:
            dot_v = lambda u, v: sum(
                st.vel_space.dot(u[d], v[d], flag, st._vel_sd, axis_name)
                for d in range(st.dim)
            )
            eig_max = estimate_spectral_radius(
                self._apply_k_stacked, self.k_invdiag, dot_v,
                (st.dim,) + st.vel_space.block_shape, num_iter=20)
        self.eig_max = eig_max

    def _apply_k_stacked(self, v):
        """K on stacked (dim, C, ...) velocity, rows restricted to flag."""
        st = self.st
        ys = st.apply_K(tuple(v[d] for d in range(st.dim)),
                        axis_name=self.axis_name)
        return jnp.stack([
            st.vel_space.restore_rows(y, jnp.zeros_like(y), self.flag,
                                      st._vel_sd)
            for y in ys
        ])

    def __call__(self, x: TaylorHoodVec, b: TaylorHoodVec) -> TaylorHoodVec:
        st, flag = self.st, self.flag

        # velocity half-step: smooth K u = f - Bt p (coupled components)
        rhs = []
        for d in range(st.dim):
            btp = st.B.apply_gradient_component_local(x.pre, d)
            btp = st.vel_space.exchange_add(btp, st._vel_sd, self.axis_name)
            btp = st.vel_space.restore_rows(btp, jnp.zeros_like(btp), flag,
                                            st._vel_sd)
            rhs.append(b.vel[d] - btp)
        u = chebyshev_smooth(self._apply_k_stacked, self.k_invdiag,
                             jnp.stack(rhs), jnp.stack(x.vel),
                             self.eig_max, order=self.order)
        new_vel = [
            st.vel_space.restore_rows(u[d], x.vel[d], flag, st._vel_sd)
            for d in range(st.dim)
        ]

        # pressure update: p <- p + omega * Minv (B u - g)
        div = st.B.apply_div_local(tuple(new_vel))
        div = st.pre_space.exchange_add(div, st._pre_sd, self.axis_name)
        mask = jnp.asarray(st.pre_space.vertex_mask[None], x.pre.dtype)
        p = x.pre + self.omega_p * self.pmass_inv * (div - b.pre) * mask
        return TaylorHoodVec(tuple(new_vel), p)


def make_stokes_gmg(
    storage,
    min_level: int,
    max_level: int,
    bc: BoundaryCondition | None = None,
    viscosity: float = 1.0,
    pre_smooth: int = 2,
    post_smooth: int = 2,
    omega_p: float = 0.3,
    coarse_iters: int = 80,
    flag: DoFType = FLAG_INNER,
    axis_name=None,
    mu=None,
    epsilon: bool = False,
    full_viscous: bool = False,
    eigs: dict | None = None,
    sd_per_level: dict | None = None,
    gmap=None,
):
    """GMG solver over the Stokes composite with Uzawa smoothing.

    ``mu``: callable of coords (or None) — variable-viscosity epsilon
    operator on every level. ``eigs``: optional per-level eig_max overrides
    (skips the power iteration, e.g. inside shard_map traces).
    ``sd_per_level``: {level: (vel_sd, pre_sd)} traced shard data — build
    the whole stack from device-local maps inside shard_map.
    ``gmap``: geometry (blending) map — every level's operators evaluate
    on the blended micro-geometry (operators/p2_blended_stokes.py)."""
    lrange = range(min_level, max_level + 1)
    pitch = (1 << (max_level + 1)) + 1  # one lane pitch across all levels
    sds = sd_per_level or {}
    stokes = {l: P2P1TaylorHoodStokes(storage, l, bc, viscosity, pitch=pitch,
                                      mu_field=mu, epsilon=epsilon,
                                      full_viscous=full_viscous,
                                      vel_sd=sds.get(l, (None, None))[0],
                                      pre_sd=sds.get(l, (None, None))[1],
                                      gmap=gmap)
              for l in lrange}
    smoothers = {l: UzawaSmoother(stokes[l], flag, omega_p=omega_p,
                                  eig_max=(eigs or {}).get(l),
                                  axis_name=axis_name) for l in lrange}
    vel_tr = {l: P2Transfer(stokes[l - 1].vel_space, stokes[l].vel_space)
              for l in range(min_level + 1, max_level + 1)}
    pre_tr = {l: P1Transfer(stokes[l - 1].pre_space, stokes[l].pre_space)
              for l in range(min_level + 1, max_level + 1)}

    def make_apply(l):
        return lambda x: stokes[l].apply_inner(x, flag, axis_name)

    def make_restrict(l):
        st_f, st_c = stokes[l], stokes[l - 1]

        def restrict(r: TaylorHoodVec):
            vel = []
            for rv in r.vel:
                rvc = vel_tr[l].restrict(rv, st_f._vel_sd, st_c._vel_sd,
                                         axis_name)
                rvc = st_c.vel_space.restore_rows(
                    rvc, jnp.zeros_like(rvc), flag, st_c._vel_sd)
                vel.append(rvc)
            vel = tuple(vel)
            pre = pre_tr[l].restrict(r.pre, st_f._pre_sd, st_c._pre_sd, axis_name)
            pre = pre * jnp.asarray(st_c.pre_space.vertex_mask[None], pre.dtype)
            return TaylorHoodVec(vel, pre)

        return restrict

    def make_prolongate_add(l):
        st_f = stokes[l]

        def padd(xc: TaylorHoodVec, xf: TaylorHoodVec):
            vel = []
            for d in range(st_f.dim):
                v = vel_tr[l].prolongate_and_add(xc.vel[d], xf.vel[d])
                v = st_f.vel_space.restore_rows(v, xf.vel[d], flag, st_f._vel_sd)
                vel.append(v)
            p = xf.pre + pre_tr[l].prolongate(xc.pre)
            p = p * jnp.asarray(st_f.pre_space.vertex_mask[None], p.dtype)
            return TaylorHoodVec(tuple(vel), p)

        return padd

    levels = {}
    for l in lrange:
        levels[l] = GMGLevel(
            apply=make_apply(l),
            smooth=(lambda x, b, l=l: smoothers[l](x, b)),
            dot=(lambda u, v, l=l: stokes[l].dot(u, v, flag, axis_name)),
            zeros=(lambda l=l: stokes[l].zeros()),
            restrict=make_restrict(l) if l > min_level else None,
            prolongate_add=make_prolongate_add(l) if l > min_level else None,
        )

    st_c = stokes[min_level]
    prec = st_c.block_diag_preconditioner(axis_name=axis_name)

    def coarse_solve(bc_vec, x0):
        x, _, _ = minres_solve(
            lambda v: st_c.apply_inner(v, flag, axis_name),
            lambda u, v: st_c.dot(u, v, flag, axis_name),
            bc_vec, x0, coarse_iters, rtol=1e-8, prec_fn=prec,
        )
        return x

    gmg = GeometricMultigridSolver(levels, coarse_solve, min_level, max_level,
                                   pre_smooth, post_smooth)
    return stokes, gmg
