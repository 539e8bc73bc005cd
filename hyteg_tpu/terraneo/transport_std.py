"""Eulerian energy-transport operator with SUPG, shear and adiabatic
heating on P1 temperature fields.

Analog of the reference's TransportOperatorStd
(reference: src/terraneo/operators/TransportOperatorStd.hpp:69-360 —
term dictionary {DIFFUSION, ADVECTION, ADIABATIC_HEATING, SHEAR_HEATING,
INTERNAL_HEATING, SUPG_STABILISATION}).  Where the reference's SUPG
branch aborts ("SUPG not yet tested and supported",
TransportOperatorStd.hpp:222), this module implements it: the advection
element matrices with per-element-mean velocity v̄,

    A_adv[a,b]  = (v̄·∇φ_b) |e| / nv          (Galerkin term)
                 + τ_e (v̄·∇φ_a)(v̄·∇φ_b) |e|   (SUPG streamline term)
    τ_e = h_e / (2 |v̄|)  (clamped)

are formed per micro-element from the constant P1 basis gradients and
contracted in the same masked shifted-read pattern as the elementwise
operators.  Shear heating is the viscous dissipation Φ = 2 η ε(u):ε(u)
of the per-element-constant strain rate, lumped-projected to nodes;
the adiabatic term is a coefficient mass contribution inside the
implicit solve.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import BoundaryCondition, DoFType, FLAG_INNER
from ..functions.p1 import P1Space
from ..indexing import micro
from ..operators import forms
from ..operators.p1_elementwise import (P1ElementwiseOperator, _class_masks,
                                        _shift_read, _shift_write)
from ..solvers.krylov import cg_solve


def element_basis_gradients(space: P1Space, cell_vertices) -> jnp.ndarray:
    """(C, T, nv, dim) constant gradients of the P1 basis on each
    micro-element congruence class (affine cells)."""
    dim = space.dim
    verts = cell_vertices[..., :dim] if dim == 2 else cell_vertices
    v0 = verts[:, :1, :]
    J = verts[:, 1:, :] - v0  # (C, dim, dim), rows = macro edge vectors
    offs = jnp.asarray(micro.offsets(dim), dtype=verts.dtype) / space.n
    # micro element edge matrices E[t] = (p_a - p_0): (C, T, dim, dim)
    E = jnp.einsum("tvd,cde->ctve", offs[:, 1:] - offs[:, :1], J)
    Einv = jnp.linalg.inv(E)  # (C, T, dim, dim)
    # grad lambda_a (a >= 1) are the rows of E^-T; grad lambda_0 = -sum
    g = jnp.swapaxes(Einv, -1, -2)  # (C, T, dim, dim) rows a-1
    g = jnp.concatenate([-g.sum(-2, keepdims=True), g], axis=-2)
    return g  # (C, T, nv, dim)


def element_volumes(space: P1Space, cell_vertices) -> jnp.ndarray:
    """(C, T) micro-element volumes (areas in 2D)."""
    dim = space.dim
    verts = cell_vertices[..., :dim] if dim == 2 else cell_vertices
    v0 = verts[:, :1, :]
    J = verts[:, 1:, :] - v0
    offs = jnp.asarray(micro.offsets(dim), dtype=verts.dtype) / space.n
    E = jnp.einsum("tvd,cde->ctve", offs[:, 1:] - offs[:, :1], J)
    fact = 2.0 if dim == 2 else 6.0
    return jnp.abs(jnp.linalg.det(E)) / fact


class SUPGAdvectionOperator:
    """T -> advection (+ optional SUPG) applied to T, per-element-mean
    velocity read from nodal P1 velocity component fields."""

    def __init__(self, space: P1Space, supg: bool = True, shard: int = 0,
                 kappa: float = 0.0, cell_vertices=None):
        self.space = space
        self.supg = supg
        #: diffusivity for the Peclet-limited tau (0 = pure advective tau)
        self.kappa = float(kappa)
        cv = (jnp.asarray(space.cell_vertices(shard))
              if cell_vertices is None else cell_vertices)
        self.grads = element_basis_gradients(space, cv)   # (C,T,nv,dim)
        self.vols = element_volumes(space, cv)            # (C,T)
        # characteristic element size for tau: h = vol^(1/dim)
        self.h_e = self.vols ** (1.0 / space.dim)

    def apply_raw(self, T, vel, sd=None, axis_name=None) -> jnp.ndarray:
        """vel: tuple of dim nodal component fields (same block shape)."""
        sp = self.space
        sd = sp.resolve_sd(sd)
        y = self._apply_local(T, vel)
        return sp.exchange_add(y, sd, axis_name)

    def _apply_local(self, T, vel):
        sp = self.space
        dim, level, pitch = sp.dim, sp.level, sp.pitch
        offs = micro.offsets(dim)
        Tn, nv = offs.shape[0], offs.shape[1]
        masks = _class_masks(level, dim, pitch, str(T.dtype))
        dst = jnp.zeros_like(T)
        for t in range(Tn):
            reads = [_shift_read(T, offs[t, b], pitch, dim)
                     for b in range(nv)]
            vreads = [[_shift_read(v, offs[t, b], pitch, dim)
                       for b in range(nv)] for v in vel]
            vbar = [sum(vr) / nv for vr in vreads]  # (dim) arrays
            # w_b = vbar . grad phi_b  -> (C,1,1) grads broadcast
            w = []
            for b in range(nv):
                acc = None
                for i in range(dim):
                    term = self.grads[:, t, b, i].reshape(-1, 1, 1) * vbar[i]
                    acc = term if acc is None else acc + term
                w.append(acc)
            vT = sum(w[b] * reads[b] for b in range(nv))  # vbar . grad T
            vol = self.vols[:, t].reshape(-1, 1, 1)
            base_mask = jnp.asarray(masks[t])
            gal = (vol / nv) * vT * base_mask
            if self.supg:
                vmag = jnp.sqrt(sum(v * v for v in vbar))
                h = self.h_e[:, t].reshape(-1, 1, 1)
                tau = h / jnp.maximum(2.0 * vmag, 1e-12)
                if self.kappa > 0.0:
                    # Peclet limit (doubly-asymptotic xi ~ min(1, Pe/3)):
                    # diffusion-dominated elements get tau -> h^2/(12 k)
                    # instead of spurious O(h) streamline diffusion
                    # (reference: the SUPG delta of the generated
                    # supg_* operator family)
                    pe = vmag * h / (2.0 * self.kappa)
                    tau = tau * jnp.minimum(1.0, pe / 3.0)
                su = tau * vol * vT * base_mask
            for a in range(nv):
                contrib = gal
                if self.supg:
                    contrib = contrib + w[a] * su
                dst = dst + _shift_write(contrib, offs[t, a], pitch, dim)
        return dst


def shear_heating_source(space: P1Space, vel, eta, sd=None, axis_name=None,
                         shard: int = 0) -> jnp.ndarray:
    """Nodal viscous dissipation Q = 2 eta eps(u):eps(u), lumped-projected
    (reference: the shearHeatingOperator_ + coefficient product,
    TransportOperatorStd.hpp:264-266)."""
    sp = space
    dim, level, pitch = sp.dim, sp.level, sp.pitch
    cv = jnp.asarray(sp.cell_vertices(shard))
    grads = element_basis_gradients(sp, cv)
    vols = element_volumes(sp, cv)
    offs = micro.offsets(dim)
    Tn, nv = offs.shape[0], offs.shape[1]
    masks = _class_masks(level, dim, pitch, str(vel[0].dtype))
    num = jnp.zeros_like(vel[0])
    den = jnp.zeros_like(vel[0])
    for t in range(Tn):
        vreads = [[_shift_read(v, offs[t, b], pitch, dim)
                   for b in range(nv)] for v in vel]
        ereads = [_shift_read(eta, offs[t, b], pitch, dim)
                  for b in range(nv)]
        eta_e = sum(ereads) / nv
        # du_j/dx_i per element: sum_b g[b,i] * u_j[b]
        phi = None
        for i in range(dim):
            for j in range(dim):
                gi = None
                for b in range(nv):
                    term = grads[:, t, b, i].reshape(-1, 1, 1) * vreads[j][b]
                    gi = term if gi is None else gi + term
                gj = None
                for b in range(nv):
                    term = grads[:, t, b, j].reshape(-1, 1, 1) * vreads[i][b]
                    gj = term if gj is None else gj + term
                eij = 0.5 * (gi + gj)
                phi = eij * eij if phi is None else phi + eij * eij
        Q_e = 2.0 * eta_e * phi  # per-element dissipation density
        vol = vols[:, t].reshape(-1, 1, 1)
        base_mask = jnp.asarray(masks[t])
        wgt = (vol / nv) * base_mask
        for a in range(nv):
            num = num + _shift_write(wgt * Q_e, offs[t, a], pitch, dim)
            den = den + _shift_write(wgt, offs[t, a], pitch, dim)
    sd = sp.resolve_sd(sd)
    num = sp.exchange_add(num, sd, axis_name)
    den = sp.exchange_add(den, sd, axis_name)
    return jnp.where(den > 0, num / jnp.maximum(den, 1e-30), 0.0)


class TransportOperatorStd:
    """Implicit BDF1 energy step with the reference's term dictionary.

        (M + dt kappa A + dt M[C_adiabatic]) T^{n+1}
            (+ dt A_supg-advection if Eulerian advection is on)
          = M T_* + dt (Q_shear + H_int) mass-weighted

    T_* is the MMOC-advected field when advection is handled
    semi-Lagrangially (the reference's only working mode), or T^n with
    the Eulerian SUPG advection folded into the lhs."""

    def __init__(self, space: P1Space, bc: BoundaryCondition | None = None,
                 kappa: float = 1.0, terms: dict | None = None,
                 cg_iters: int = 200, cg_rtol: float = 1e-7):
        self.space = space
        self.bc = bc or BoundaryCondition.all_dirichlet()
        self.kappa = kappa
        self.terms = {
            "DIFFUSION": True,
            "ADVECTION_EULERIAN": False,
            "ADIABATIC_HEATING": False,
            "SHEAR_HEATING": False,
            "INTERNAL_HEATING": False,
            "SUPG_STABILISATION": True,
            **(terms or {}),
        }
        self.A = P1ElementwiseOperator(space, forms.laplace_form)
        self.M = P1ElementwiseOperator(space, forms.mass_form)
        self.adv = SUPGAdvectionOperator(
            space, supg=self.terms["SUPG_STABILISATION"], kappa=kappa)
        self.cg_iters = cg_iters
        self.cg_rtol = cg_rtol
        self._sd = space.resolve_sd(self.bc)
        self.adiabatic_coeff = None   # nodal field C_adiabatic
        self.internal_heating = 0.0   # scalar H

    def _lhs(self, x, dt, vel):
        sd = self._sd
        y = self.M.apply_raw(x, sd=sd)
        if self.terms["DIFFUSION"]:
            y = y + dt * self.kappa * self.A.apply_raw(x, sd=sd)
        if self.terms["ADIABATIC_HEATING"] and self.adiabatic_coeff is not None:
            y = y + dt * self.M.apply_raw(x, coeff=self.adiabatic_coeff,
                                          sd=sd)
        if self.terms["ADVECTION_EULERIAN"] and vel is not None:
            y = y + dt * self.adv.apply_raw(x, vel, sd=sd)
        return y

    def step(self, T, dt, vel=None, eta=None):
        """One implicit step; T keeps its Dirichlet rows."""
        sp = self.space
        sd = self._sd
        b = self.M.apply_raw(T, sd=sd)
        if self.terms["SHEAR_HEATING"] and vel is not None and eta is not None:
            Q = shear_heating_source(sp, vel, eta)
            b = b + dt * self.M.apply_raw(Q, sd=sd)
        if self.terms["INTERNAL_HEATING"]:
            H = jnp.full_like(T, self.internal_heating)
            b = b + dt * self.M.apply_raw(H, sd=sd)

        inner = self._inner_mask(T.dtype)
        # eliminate Dirichlet rows: correction equation on the interior
        b_in = inner * (b - self._lhs(T, dt, vel))

        def apply_fn(x):
            return inner * self._lhs(inner * x, dt, vel)

        def dot_fn(a, bb):
            return sp.dot(a, bb, DoFType.ALL, sd)

        res = cg_solve(apply_fn, dot_fn, b_in, jnp.zeros_like(b_in),
                       max_iter=self.cg_iters, rtol=self.cg_rtol)
        return T + inner * res.x

    def _inner_mask(self, dtype):
        sp = self.space
        z = jnp.zeros(sp.block_shape, dtype=dtype)
        ones = jnp.ones(sp.block_shape, dtype=dtype)
        m = sp.restore_rows(ones, z, FLAG_INNER, self._sd)
        return m * jnp.asarray(sp.vertex_mask[None], dtype=dtype)
