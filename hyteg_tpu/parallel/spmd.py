"""Multi-device SPMD execution over a JAX device mesh.

Analog of the reference's MPI distribution
(reference: src/hyteg/primitivestorage/PrimitiveStorage.cpp:62-140 +
communication/BufferedCommunication.*): macro-cells are sharded over a 1-D
``cells`` mesh axis via shard_map; all interface exchanges become
``psum`` collectives over that axis (see P1Space.exchange_*).

The per-shard slot maps are fed in as arrays sharded along their leading
(device) axis, so the same kernels run single-device (static maps) and
multi-device (traced maps).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

shard_map = jax.shard_map

from ..core.types import BoundaryCondition, DoFType, FLAG_INNER
from ..functions.p1 import P1ShardData, P1Space
from ..primitives.storage import CellStorage

AXIS = "cells"


def device_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def _sd_specs(sd: P1ShardData) -> P1ShardData:
    """in_specs pytree for stacked shard data (leading device axis) —
    mirrored from the actual pytree so optional leaves (neighbor-exchange
    tables) stay in sync; shard_map compares treedefs incl. static aux."""
    return jax.tree.map(lambda _: P(AXIS), sd)


def _squeeze_sd(sd: P1ShardData) -> P1ShardData:
    return jax.tree.map(lambda a: a[0], sd)


class SpmdContext:
    """Bundles a storage sharded over a device mesh with the per-level
    stacked shard data and helpers to build sharded global DoF arrays."""

    def __init__(self, storage: CellStorage, mesh: Mesh,
                 bc: BoundaryCondition | None = None,
                 pitch: int | None = None):
        assert storage.num_shards == mesh.devices.size
        self.storage = storage
        self.mesh = mesh
        self.bc = bc or BoundaryCondition.all_dirichlet()
        self.num_devices = storage.num_shards
        # shared lane pitch for GMG stacks (see indexing/flat.py); None ->
        # every level uses its own natural pitch N
        self.pitch = pitch

    def space(self, level: int, dtype=jnp.float32) -> P1Space:
        return P1Space(self.storage, level, dtype, pitch=self.pitch)

    def stacked_sd(self, level: int):
        return self.space(level).stacked_shard_data(self.bc)

    def global_zeros(self, level: int, dtype=jnp.float32):
        sp = self.space(level, dtype)
        shape = (self.storage.num_cells, sp.N, sp.lanes)
        sharding = NamedSharding(self.mesh, P(AXIS))
        return jax.device_put(jnp.zeros(shape, dtype), sharding)

    def shard(self, fn: Callable, num_levels_args: list[int],
              n_array_args: int, out_spec=P(AXIS)):
        """Wrap ``fn(x1..xn, sd_l1.., axis_name=AXIS)`` with shard_map.

        fn receives device-local DoF blocks and squeezed P1ShardData per
        level (in the order of num_levels_args).
        """
        sds = [self.stacked_sd(l) for l in num_levels_args]

        def body(*args):
            xs = args[:n_array_args]
            sd_stacked = args[n_array_args:]
            sd_local = [_squeeze_sd(s) for s in sd_stacked]
            return fn(*xs, *sd_local)

        specs_in = tuple([P(AXIS)] * n_array_args) + tuple(
            _sd_specs(s) for s in sds
        )
        # one shard_map wrapper for the lifetime of the callable — a fresh
        # wrapper per call would retrace (and recompile when called
        # eagerly) on every invocation
        sm = shard_map(body, mesh=self.mesh, in_specs=specs_in,
                       out_specs=out_spec, check_vma=False)

        def wrapped(*arrays):
            return sm(*arrays, *sds)

        return wrapped


def build_agglomerated_coarse_solve(ctx: SpmdContext, level: int, form,
                                    coarse_iters: int = 100):
    """Coarse solve for the SPMD V-cycle in the agglomeration style
    (reference: solvers/controlflow/AgglomerationWrapper.hpp:75 gathers the
    coarse level onto a rank subset): all-gather the coarse DoF blocks over
    the mesh axis, run CG on the full (small) coarse system redundantly on
    every device with zero communication, slice the local shard back out.
    """
    from ..operators.p1_elementwise import P1ElementwiseOperator, compute_elmats
    from ..solvers.krylov import cg_solve_fixed

    sp = ctx.space(level)
    gsd = sp.global_shard_data(ctx.bc)
    elmats = compute_elmats(sp, form, gsd.cell_vertices)
    op = P1ElementwiseOperator(sp, form, elmats=elmats)

    def apply_fn(v):
        return op.apply_inner(v, gsd, FLAG_INNER)

    def dot_fn(u, v):
        return sp.dot(u, v, FLAG_INNER, gsd)

    C_loc = ctx.storage.cells_per_shard

    def coarse_solve(b_local, x_local):
        xg = jax.lax.all_gather(x_local, AXIS, axis=0, tiled=True)
        bg = jax.lax.all_gather(b_local, AXIS, axis=0, tiled=True)
        xg = cg_solve_fixed(apply_fn, dot_fn, bg, xg, coarse_iters)
        i = jax.lax.axis_index(AXIS)
        return jax.lax.dynamic_slice_in_dim(xg, i * C_loc, C_loc, 0)

    return coarse_solve


def build_spmd_poisson_vcycle(
    ctx: SpmdContext,
    min_level: int,
    max_level: int,
    form=None,
    smoother: str = "chebyshev",
    eigs: dict[int, float] | None = None,
    agglomerate_coarse: bool = False,
    **gmg_kwargs,
):
    """Returns jitted (x, b) -> x running one V-cycle, fully sharded.

    The GMG stack (element matrices, diagonals, spectral estimates) is built
    inside the trace from the sharded maps, so one jit covers setup + cycle.
    With ``agglomerate_coarse``, the coarse level is all-gathered and solved
    redundantly on every device (see build_agglomerated_coarse_solve).
    """
    from ..operators import forms as _forms
    from ..solvers.templates import make_p1_gmg

    form = form or _forms.laplace_form
    levels = list(range(min_level, max_level + 1))
    if ctx.pitch is None and ctx.storage.dim == 3:
        ctx = SpmdContext(ctx.storage, ctx.mesh, ctx.bc,
                          pitch=(1 << max_level) + 1)
    coarse_fn = (build_agglomerated_coarse_solve(
        ctx, min_level, form, gmg_kwargs.get("coarse_iters", 100))
        if agglomerate_coarse else None)

    def step(x, b, *sd_local):
        sd_per_level = dict(zip(levels, sd_local))
        stack = make_p1_gmg(
            ctx.storage, min_level, max_level, form=form, bc=ctx.bc,
            smoother=smoother, axis_name=AXIS, sd_per_level=sd_per_level,
            eigs=eigs, coarse_solve_fn=coarse_fn, **gmg_kwargs,
        )
        return stack.gmg.cycle(x, b)

    sharded = ctx.shard(step, levels, n_array_args=2)
    return jax.jit(sharded)


def build_spmd_stokes_vcycle(
    ctx: SpmdContext,
    min_level: int,
    max_level: int,
    viscosity: float = 1.0,
    mu=None,
    epsilon: bool = False,
    eigs: dict | None = None,
    **gmg_kwargs,
):
    """Jitted fully sharded Stokes (Uzawa) V-cycle: (x, b) -> x with
    TaylorHoodVec pytrees of globally sharded blocks.

    The whole P2-P1 stack (element matrices, diagonals, Uzawa damping) is
    built inside the shard_map trace from the device-local maps — the SPMD
    analog of the reference's distributed Stokes GMG
    (apps/2020-scaling-workshop/Helpers.cpp:103-173). ``eigs`` per-level
    eig_max values skip the in-trace power iteration (recommended: estimate
    once at setup like the reference's Chebyshev glue).
    """
    from ..composites.stokes import TaylorHoodVec
    from ..core.types import BoundaryCondition
    from ..solvers.uzawa import make_stokes_gmg

    levels = list(range(min_level, max_level + 1))
    pitch = (1 << (max_level + 1)) + 1
    # stacked shard data per level: velocity on the node grid (level + 1,
    # function BC), pressure on the vertex grid (all-Neumann)
    vel_sds, pre_sds = [], []
    for l in levels:
        vel_sp = P1Space(ctx.storage, l + 1, pitch=pitch)
        pre_sp = P1Space(ctx.storage, l, pitch=pitch)
        vel_sds.append(vel_sp.stacked_shard_data(ctx.bc))
        pre_sds.append(pre_sp.stacked_shard_data(
            BoundaryCondition.all_neumann()))

    def step(xv, xp, bv, bp, *sd_flat):
        n = len(levels)
        sdl = {
            l: (sd_flat[i], sd_flat[n + i]) for i, l in enumerate(levels)
        }
        _, gmg = make_stokes_gmg(
            ctx.storage, min_level, max_level, bc=ctx.bc,
            viscosity=viscosity, mu=mu, epsilon=epsilon, eigs=eigs,
            axis_name=AXIS, sd_per_level=sdl, **gmg_kwargs,
        )
        x = TaylorHoodVec(tuple(xv), xp)
        b = TaylorHoodVec(tuple(bv), bp)
        out = gmg.cycle(x, b)
        return tuple(out.vel), out.pre

    dim = ctx.storage.dim
    sds = vel_sds + pre_sds

    def wrapped(x: TaylorHoodVec, b: TaylorHoodVec):
        specs_sd = tuple(_sd_specs(s) for s in sds)
        vspec = (P(AXIS),) * dim

        def body(xv, xp, bv, bp, *sd_stacked):
            sd_local = [_squeeze_sd(s) for s in sd_stacked]
            return step(xv, xp, bv, bp, *sd_local)

        out_v, out_p = shard_map(
            body, mesh=ctx.mesh,
            in_specs=(vspec, P(AXIS), vspec, P(AXIS)) + specs_sd,
            out_specs=(vspec, P(AXIS)),
            check_vma=False,
        )(tuple(x.vel), x.pre, tuple(b.vel), b.pre, *sds)
        return TaylorHoodVec(tuple(out_v), out_p)

    return jax.jit(wrapped)


def build_spmd_apply(ctx: SpmdContext, level: int, form=None):
    """Jitted sharded operator apply (the weak-scaling benchmark kernel)."""
    from ..operators import forms as _forms
    from ..operators.p1_elementwise import P1ElementwiseOperator

    form = form or _forms.laplace_form
    sp = ctx.space(level)

    def step(x, sd_local):
        op = P1ElementwiseOperator.from_shard_data(sp, form, sd_local)
        return op.apply_raw(x, sd=sd_local, axis_name=AXIS)

    return jax.jit(ctx.shard(step, [level], n_array_args=1))
