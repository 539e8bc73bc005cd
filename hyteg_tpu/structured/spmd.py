"""SPMD execution of the box fast path over a device mesh.

Domain decomposition by x-row slabs over a 1-D ``rows`` mesh axis.  The
halo exchange is NEIGHBOR-WISE: each device ppermutes exactly one grid
row to each adjacent device per apply — O(local interface) traffic, the
Analog of the reference's nearest-neighbor PackInfo exchange
(reference: src/hyteg/communication/PackInfo.hpp:43-183,
BufferedCommunication.hpp:92-119) instead of any global collective.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

shard_map = jax.shard_map

from . import kuhn
from .box import BoxDomain
from .operator import BoxStencilOperator, shift_read

AXIS = "rows"


def device_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def padded_rows(X: int, D: int) -> int:
    return -(-X // D) * D


def shard_field(u, domain: BoxDomain, mesh: Mesh):
    """(X, L) -> (Xp, L) zero-padded and row-sharded over the mesh."""
    Xp = padded_rows(domain.X, mesh.devices.size)
    up = jnp.pad(u, ((0, Xp - domain.X), (0, 0)))
    return jax.device_put(up, NamedSharding(mesh, P(AXIS, None)))


def unshard_field(up, domain: BoxDomain):
    return up[: domain.X]


class SpmdBoxOperator:
    """Row-slab-sharded stencil apply (shard_map over ``rows``).

    The local block is extended by one ppermuted halo row per side; the
    bulk stencil uses the interior weight vector, and the two global
    boundary rows are re-evaluated with their own weight vectors under
    global-row-id masks (data-driven — every shard runs the same
    program)."""

    def __init__(self, op: BoxStencilOperator, mesh: Mesh):
        self.op = op
        self.mesh = mesh
        self.D = mesh.devices.size
        self.domain = op.domain
        X = self.domain.X
        self.Xp = padded_rows(X, self.D)
        self.XL = self.Xp // self.D

    def _sweep(self, ext, w, rows):
        """Stencil over an extended slab; returns (bulk, fix0, fixl) on
        the ``rows`` output rows (input must cover rows-1 .. rows+1)."""
        Z = self.domain.dims[2]
        dirs = kuhn.stencil_dirs()
        bulk = fix0 = fixl = None
        for s in range(dirs.shape[0]):
            r = shift_read(ext, dirs[s], Z)[1:1 + rows]
            t = w[0, s][None, :] * r
            bulk = t if bulk is None else bulk + t
            t0 = w[1, s][None, :] * r
            fix0 = t0 if fix0 is None else fix0 + t0
            tl = w[2, s][None, :] * r
            fixl = tl if fixl is None else fixl + tl
        return bulk, fix0, fixl

    def _local_apply(self, u_loc, w):
        """u_loc: (XL, L) local slab; w: (3, n_s, L) weight vectors.

        Compute/communication overlap (reference:
        BufferedCommunication.hpp:92-100 start/endCommunication): the two
        halo-row ppermutes are issued FIRST, the interior rows (which
        need no halo) are computed from the unextended slab, and only the
        two edge output rows consume the received halos — XLA's
        latency-hiding scheduler can run the collectives concurrently
        with the interior sweep because there is no data dependence."""
        dom = self.domain
        X = dom.X
        D, XL = self.D, self.XL

        i = jax.lax.axis_index(AXIS)
        # issue the collectives first
        lo = jax.lax.ppermute(u_loc[-1:], AXIS,
                              [(j, j + 1) for j in range(D - 1)])
        hi = jax.lax.ppermute(u_loc[:1], AXIS,
                              [(j + 1, j) for j in range(D - 1)])

        # interior rows 1 .. XL-2: shifts stay inside the local slab
        zrow = jnp.zeros_like(u_loc[:1])
        ext_int = jnp.concatenate([zrow, u_loc, zrow], axis=0)
        bulk_i, fix0_i, fixl_i = self._sweep(ext_int, w, XL)

        # both edge output rows from ONE sweep over the stacked 6-row
        # strip [lo, u0, u1, u_{XL-2}, u_{XL-1}, hi]: its output rows 1
        # and 4 are the first/last slab rows with correct halo reads
        # (rows 2/3 are don't-care)
        ext_e = jnp.concatenate([lo, u_loc[:2], u_loc[-2:], hi], axis=0)
        be, fe0, fel = self._sweep(ext_e, w, 4)

        bulk = jnp.concatenate([be[0:1], bulk_i[1:XL - 1], be[3:4]], axis=0)
        fix0 = jnp.concatenate([fe0[0:1], fix0_i[1:XL - 1], fe0[3:4]],
                               axis=0)
        fixl = jnp.concatenate([fel[0:1], fixl_i[1:XL - 1], fel[3:4]],
                               axis=0)

        gids = (jax.lax.broadcasted_iota(jnp.int32, (XL, 1), 0)
                + i * XL)
        out = jnp.where(gids == 0, fix0, bulk)
        out = jnp.where(gids == X - 1, fixl, out)
        return jnp.where(gids < X, out, 0.0)

    @functools.cached_property
    def _apply_fn(self):
        # built once: a fresh shard_map wrapper per call would retrace
        # (and, called eagerly, recompile) on every apply
        return shard_map(
            self._local_apply, mesh=self.mesh,
            in_specs=(P(AXIS, None), P(None, None, None)),
            out_specs=P(AXIS, None),
        )

    def apply_raw(self, up: jnp.ndarray) -> jnp.ndarray:
        """up: (Xp, L) row-sharded (see shard_field)."""
        return self._apply_fn(up, self.op.w_vecs)

    def jacobi_step(self, up, bp, omega=0.8):
        """One damped-Jacobi sweep on the padded sharded block (interior
        rows; Dirichlet boundary rows left untouched)."""
        dom = self.domain
        inner = jnp.pad(jnp.asarray(dom.interior_mask, dtype=up.dtype),
                        ((0, self.Xp - dom.X), (0, 0)))
        dinv = jnp.pad(self.op.inverse_diagonal,
                       ((0, self.Xp - dom.X), (0, 0)))
        r = bp - self.apply_raw(up)
        return up + omega * inner * dinv * r


# ---------------------------------------------------------------------------
# sharded geometric multigrid (the 1e9-DoF path)
# ---------------------------------------------------------------------------
#
# Strategy: the stencil apply runs as the shard_map/ppermute sweep above
# on padded row-slabs; everything else (Chebyshev algebra, grid
# transfers, dot products) is written as global-view jnp ops with
# NamedSharding constraints — GSPMD partitions the stride-2 slices and
# shifts of structured/transfer.py and inserts the neighbor collectives
# and psums itself.  This mirrors the reference's distributed GMG
# (reference: apps/2020-scaling-workshop/Helpers.cpp:103-173 — same
# partition on all levels, collectives only at halos and reductions).

from dataclasses import dataclass as _dataclass, field as _field

from ..operators import forms as _forms
from . import transfer as _transfer
from . import gmg as _gmg


@_dataclass
class SpmdBoxLevel:
    domain: BoxDomain
    op: "SpmdBoxOperator"
    eig_max: float

    @property
    def inner(self):
        # built in-trace: an eager (X, L) mask is a multi-GB captured
        # constant at 1e9 DoFs (see BoxDomain.interior_mask_traced)
        return self.domain.interior_mask_traced()

    @property
    def dinv(self):
        return self.op.op.inverse_diagonal_traced()

    def apply_global(self, x):
        """A x on the exact-shape global array (pad -> shard_map -> slice)."""
        dom, mesh = self.domain, self.op.mesh
        Xp = padded_rows(dom.X, mesh.devices.size)
        xp = jnp.pad(x, ((0, Xp - dom.X), (0, 0)))
        xp = jax.lax.with_sharding_constraint(
            xp, NamedSharding(mesh, P(AXIS, None)))
        return self.op.apply_raw(xp)[: dom.X]


def _dot(a, b):
    return jnp.sum(a * b)  # GSPMD inserts the psum


def _norm(a):
    return jnp.sqrt(_dot(a, a))


def build_spmd_hierarchy(domain: BoxDomain, mesh: Mesh,
                         form=None, min_level: int = 2,
                         eig_iters: int = 30,
                         eig_max: float | None = None) -> list[SpmdBoxLevel]:
    """Fine-to-coarse sharded levels with per-level spectral estimates
    (the power iteration itself runs sharded).

    ``eig_max``: skip the estimation and use this value on every level —
    for extreme sizes where even a few power iterations are expensive
    (lambda_max(D^-1 A) of the constant-coefficient box operator is
    measured level-invariant to < 1%, and the Chebyshev margin covers
    it; see structured/gmg.py)."""
    form = form or _forms.laplace_form
    levels = []
    d = domain
    while True:
        op = SpmdBoxOperator(BoxStencilOperator(d, form), mesh)
        lvl = SpmdBoxLevel(d, op, 0.0)
        lvl.eig_max = (eig_max if eig_max is not None
                       else _estimate_eig_spmd(lvl, eig_iters))
        levels.append(lvl)
        if d.level <= min_level:
            break
        d = d.coarse()
    return levels


def _estimate_eig_spmd(lvl: SpmdBoxLevel, iters: int) -> float:
    dom = lvl.domain
    inner = lvl.inner
    dinv = lvl.dinv

    @jax.jit
    def body(x):
        y = inner * (dinv * lvl.apply_global(inner * x))
        return y / _norm(y)

    @jax.jit
    def rayleigh(x):
        y = inner * (dinv * lvl.apply_global(inner * x))
        return _dot(x, y)

    x = jnp.ones(dom.block_shape, dtype=dom.dtype)
    x = x / float(jnp.sqrt(dom.num_dofs()))
    for _ in range(iters):
        x = body(x)
    return float(rayleigh(x))


def _cheby_spmd(lvl: SpmdBoxLevel, x, b, degree: int):
    """Chebyshev smoother on global-view arrays (same interval policy as
    structured/gmg.py:_cheby)."""
    lmax = lvl.eig_max * 1.1
    lmin = lvl.eig_max * 0.15
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    dinv = lvl.dinv
    inner = lvl.inner

    def resid(x):
        return inner * (dinv * (b - lvl.apply_global(x)))

    d = resid(x) / theta
    x = x + d
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * resid(x)
        x = x + d
        rho = rho_new
    return x


def coarse_cg_spmd(lvl: SpmdBoxLevel, b, iters: int = 40):
    inner = lvl.inner

    def A(v):
        return inner * lvl.apply_global(inner * v)

    x = jnp.zeros_like(b)
    r = inner * b
    p = r
    rs = _dot(r, r)

    def body(carry, _):
        x, r, p, rs = carry
        Ap = A(p)
        denom = _dot(p, Ap)
        alpha = jnp.where(denom > 0, rs / jnp.maximum(denom, 1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = _dot(r, r)
        beta = jnp.where(rs > 0, rs_new / jnp.maximum(rs, 1e-30), 0.0)
        p = r + beta * p
        return (x, r, p, rs_new), None

    (x, *_), _ = jax.lax.scan(body, (x, r, p, rs), None, length=iters)
    return x


def spmd_vcycle(levels: list[SpmdBoxLevel], x, b, pre: int = 2,
                post: int = 2, coarse_iters: int = 40, _k: int = 0):
    """One sharded V-cycle on levels[_k:] (global-view arrays; the
    transfers are plain structured/transfer.py ops — GSPMD partitions
    their stride-2 slices and shifts)."""
    lvl = levels[_k]
    if _k == len(levels) - 1:
        return coarse_cg_spmd(lvl, b, coarse_iters)
    x = _cheby_spmd(lvl, x, b, pre)
    r = lvl.inner * (b - lvl.apply_global(x))
    r_c = _transfer.restrict(r, lvl.domain, levels[_k + 1].domain)
    r_c = levels[_k + 1].inner * r_c
    e_c = spmd_vcycle(levels, jnp.zeros_like(r_c), r_c, pre, post,
                      coarse_iters, _k + 1)
    e = _transfer.prolongate(levels[_k + 1].inner * e_c,
                             levels[_k + 1].domain, lvl.domain)
    x = x + lvl.inner * e
    return _cheby_spmd(lvl, x, b, post)


def spmd_solve_poisson(levels: list[SpmdBoxLevel], f, cycles: int = 5,
                       pre: int = 2, post: int = 2, coarse_iters: int = 40):
    """Dirichlet Poisson solve (homogeneous boundary), returns
    (u, per-cycle residual norms).  Jit the returned callable's body once:

        solve = jax.jit(functools.partial(spmd_solve_poisson, levels))
    """
    lvl = levels[0]
    b = lvl.inner * f
    x = jnp.zeros_like(b)
    rns = []
    for _ in range(cycles):
        x = spmd_vcycle(levels, x, b, pre, post, coarse_iters)
        rns.append(_norm(lvl.inner * (b - lvl.apply_global(x))))
    return x, jnp.stack(rns)
