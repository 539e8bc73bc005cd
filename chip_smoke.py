"""Smoke run of the P1 multigrid solve on a GPU, at sizes HyTeG users run.

Drives the library's own entry points in one process, compares every
kernel on the path with its plain reference, and checks that the
multigrid solves converge.  It needs a CUDA GPU: on any other platform it
exits non-zero before it computes anything.  No phase catches an error in
order to carry on.

    python chip_smoke.py               # one card: every single-card phase
    python chip_smoke.py --four-cards  # four cards: the sharded solves only

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

BOX_LEVEL = 8          # 513^3 = 135M DoFs, 540 MB per f32 array
TET_LEVELS = (5, 6)    # unit cube of 48 macro-tets; 2.1M DoFs at level 6
P2_LEVEL = 5
SHELL_LEVEL, SHELL_GATE_LEVEL = 4, 3
CYCLES = 8
SHARDED_TET_CYCLES = 4
MIN_REDUCTION = 1e4


class SmokeFailure(RuntimeError):
    """A phase produced a wrong or non-converged result."""


def compare(got, want, tol: float, what: str) -> float:
    """max|got - want| / max|want| <= tol, else SmokeFailure."""
    got = np.asarray(jnp.asarray(got, jnp.float32), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    if got.shape != want.shape:
        raise SmokeFailure(f"{what}: shape {got.shape} != {want.shape}")
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    print(f"  {what}: rel err {err:.3e} (tol {tol:.0e})", flush=True)
    if not np.isfinite(err) or err > tol:
        raise SmokeFailure(f"{what}: rel err {err:.3e} > {tol:.0e}")
    return err


def converged(rns, what: str, reduction: float = MIN_REDUCTION) -> int:
    """rns[0] is the initial residual norm; returns the first cycle that
    reaches the reduction, else SmokeFailure."""
    rns = [float(r) for r in rns]
    for c in range(1, len(rns)):
        print(f"  {what}: cycle {c} residual {rns[c]:.4e} "
              f"rate {rns[c] / rns[c - 1]:.4f} "
              f"reduction {rns[0] / rns[c]:.3e}", flush=True)
    if not all(np.isfinite(rns)):
        raise SmokeFailure(f"{what}: non-finite residuals {rns}")
    for c in range(1, len(rns)):
        if rns[c] <= rns[0] / reduction:
            return c
    raise SmokeFailure(f"{what}: residual reduction {rns[0] / rns[-1]:.3e} "
                       f"< {reduction:.0e} after {len(rns) - 1} cycles")


def print_memory(what: str, compiled) -> None:
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    print(f"  {what} memory_analysis: " + " ".join(
        f"{f.replace('_size_in_bytes', '')}={getattr(ma, f, None)}"
        for f in fields), flush=True)


def compile_all(lowered) -> list:
    """Compile lowered programs side by side.  XLA releases the GIL while
    it compiles, and compiling takes most of a cold run."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(lowered)) as pool:
        out = list(pool.map(lambda lo: lo.compile(), lowered))
    print(f"  compiled {len(lowered)} programs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def phase(name):
    def wrap(fn):
        def run(*args, **kwargs):
            print(f"phase {name}", flush=True)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            return out
        return run
    return wrap


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------


@phase("box apply")
def box_apply(level: int = BOX_LEVEL) -> None:
    from hyteg_tpu.structured import BoxDomain, BoxStencilOperator

    dom = BoxDomain((2, 2, 2), level=level)
    op = BoxStencilOperator(dom)
    print(f"  box level {level}: dims {dom.dims}, {dom.num_dofs()} DoFs",
          flush=True)
    u = jax.random.normal(jax.random.PRNGKey(0), dom.block_shape,
                          dtype=jnp.float32)
    apply = jax.jit(op.apply_raw).lower(u).compile()
    print_memory("apply_raw f32", apply)
    want = jax.jit(op._apply_xla)(u)
    compare(apply(u), want, 1e-5, "apply_raw vs _apply_xla, f32")

    ub = u.astype(jnp.bfloat16)
    got_b = jax.jit(op.apply_raw)(ub)
    if got_b.dtype != jnp.bfloat16:
        raise SmokeFailure(f"bf16 storage returned {got_b.dtype}")
    compare(got_b, jax.jit(op._apply_xla)(ub), 2e-2,
            "apply_raw vs _apply_xla, bf16 storage")
    compare(got_b, want, 2e-2, "apply_raw bf16 storage vs f32 reference")


@phase("box GMG solve")
def box_gmg(level: int = BOX_LEVEL, min_level: int = 3) -> None:
    from hyteg_tpu.structured import BoxDomain
    from hyteg_tpu.structured import gmg

    dom = BoxDomain((2, 2, 2), level=level)
    levels = gmg.build_hierarchy(dom, min_level=min_level)
    inner = jnp.asarray(dom.interior_mask, dtype=jnp.float32)
    f = inner * jax.random.normal(jax.random.PRNGKey(1), dom.block_shape,
                                  dtype=jnp.float32)
    solve = jax.jit(lambda f: gmg.solve_poisson(levels, f, cycles=CYCLES))
    t0 = time.perf_counter()
    compiled = solve.lower(f).compile()
    print(f"  V(2,2) levels {level}..{min_level}: compiled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print_memory(f"{CYCLES}-cycle solve", compiled)
    _, rns = compiled(f)
    r0 = float(jnp.sqrt(jnp.sum(f * f)))
    c = converged([r0, *np.asarray(rns)], f"box V(2,2) level {level}")
    print(f"  reduction {MIN_REDUCTION:.0e} reached at cycle {c}", flush=True)


def _manufactured(stack):
    """The sin(pi x) sin(pi y) sin(pi z) Poisson problem: (x0, b, exact)."""
    from hyteg_tpu.core.types import BoundaryCondition, DoFType, FLAG_INNER
    from hyteg_tpu.operators import forms
    from hyteg_tpu.operators.p1_elementwise import P1ElementwiseOperator

    sp, bc = stack.space(), BoundaryCondition.all_dirichlet()

    def U(p):
        return (jnp.sin(jnp.pi * p[..., 0]) * jnp.sin(jnp.pi * p[..., 1])
                * jnp.sin(jnp.pi * p[..., 2]))

    mass = P1ElementwiseOperator(sp, forms.mass_form)
    x0 = sp.interpolate(U, sp.zeros(), DoFType.DIRICHLET, bc)
    f = sp.interpolate(lambda p: 3 * jnp.pi ** 2 * U(p), sp.zeros(),
                       DoFType.ALL, bc)
    b = sp.restore_rows(mass.apply_raw(f), sp.zeros(), FLAG_INNER, bc)
    exact = sp.interpolate(U, sp.zeros(), DoFType.ALL, bc)
    return x0, b, exact


def _cycles(cycle, rnorm, x, b, cycles: int = CYCLES):
    rns = [float(rnorm(x, b))]
    for _ in range(cycles):
        x = cycle(x, b)
        rns.append(float(rnorm(x, b)))
    return x, rns


@phase("tet P1 GMG solve")
def tet_gmg(levels=TET_LEVELS, min_level: int = 2, mesh_n: int = 2,
            manufactured_reduction: float = 1e3) -> None:
    from hyteg_tpu.core.types import DoFType, FLAG_INNER
    from hyteg_tpu.mesh import meshinfo as mi
    from hyteg_tpu.primitives.storage import CellStorage
    from hyteg_tpu.solvers.templates import make_p1_gmg

    storage = CellStorage(mi.mesh_unit_cube(mesh_n))
    runs, lowered = [], []
    for level in levels:
        t0 = time.perf_counter()
        stack = make_p1_gmg(storage, min_level, level, smoother="chebyshev")
        sp = stack.space()
        print(f"  level {level}: {sp.num_global_dofs()} DoFs, block "
              f"{sp.block_shape}, stack built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        x0, b, exact = _manufactured(stack)
        runs.append((level, stack, x0, b, exact))
        lowered += [jax.jit(stack.gmg.cycle).lower(x0, b),
                    jax.jit(stack.residual_norm).lower(x0, b)]
    compiled = compile_all(lowered)

    errors = {}
    for i, (level, stack, x0, b, exact) in enumerate(runs):
        cycle, rnorm = compiled[2 * i:2 * i + 2]
        sp = stack.space()
        x, rns = _cycles(cycle, rnorm, x0, b)
        # a smooth right-hand side meets the f32 round-off floor of the
        # residual: on a CPU the f32 reduction stalls near 3.3e5, 1.1e5 and
        # 3.3e4 at levels 3, 4, 5 (a factor ~3.2 per level), where f64
        # passes 1e4 by cycle 4 on every level
        converged(rns, f"manufactured level {level}",
                  manufactured_reduction)
        e = x - exact
        errors[level] = float(jnp.sqrt(
            sp.dot(e, e, DoFType.ALL, sp.resolve_sd(None))
            / sp.num_global_dofs()))
        print(f"  level {level}: nodal RMS error {errors[level]:.4e}",
              flush=True)

    # a rough right-hand side keeps the round-off floor far below 1e-4
    key = jax.random.PRNGKey(2)
    b = jax.random.normal(key, sp.block_shape, dtype=sp.dtype)
    b = b * jnp.asarray(sp.vertex_mask[None], dtype=sp.dtype)
    sd = sp.resolve_sd(None)
    b = sp.exchange_rep(b, sd)
    b = sp.restore_rows(b, jnp.zeros_like(b), FLAG_INNER, sd)
    _, rns = _cycles(cycle, rnorm, jnp.zeros_like(b), b)
    c = converged(rns, f"random rhs level {level}")
    print(f"  reduction {MIN_REDUCTION:.0e} reached at cycle {c}", flush=True)

    lo, hi = levels[-2], levels[-1]
    ratio = errors[hi] / errors[lo]
    print(f"  error ratio level {hi} / level {lo}: {ratio:.4f} "
          "(O(h^2) predicts 0.25)", flush=True)
    if not ratio <= 1.0 / 3.0:
        raise SmokeFailure(f"error ratio {ratio:.4f} > 1/3")

    # constant-stencil apply vs the unrolled elementwise reference
    from hyteg_tpu.kernels.p1_const_stencil import p1_const_apply_xla
    from hyteg_tpu.operators.p1_elementwise import p1_apply_local

    op = stack.operators[hi]
    x = jax.random.normal(key, sp.block_shape, dtype=sp.dtype)
    x = x * jnp.asarray(sp.vertex_mask[None], dtype=sp.dtype)
    with jax.default_matmul_precision("highest"):
        got = jax.jit(lambda v: p1_const_apply_xla(
            v, op.stencil, sp.level, sp.dim, sp.pitch,
            E=op.stencil_face))(x)
        want = jax.jit(lambda v: p1_apply_local(
            v, op.elmats, sp.level, sp.dim, sp.pitch, unroll=True))(x)
    compare(got, want, 1e-5, f"p1_const_apply_xla level {hi}")


@phase("P2 const stencil")
def p2_const(level: int = P2_LEVEL, mesh_n: int = 2) -> None:
    from hyteg_tpu.functions.p2 import P2Space
    from hyteg_tpu.kernels.p2_const_stencil import (
        p2_const_apply_xla, p2_face_weights, p2_stencil_weights)
    from hyteg_tpu.mesh import meshinfo as mi
    from hyteg_tpu.operators.p2_elementwise import (compute_p2_elmats,
                                                    p2_apply_local)
    from hyteg_tpu.primitives.storage import CellStorage

    p2 = P2Space(CellStorage(mi.mesh_unit_cube(mesh_n)), level)
    elm = compute_p2_elmats(p2, "laplace")
    A = p2_stencil_weights(elm, p2.dim)
    E = p2_face_weights(elm, p2.dim)
    x = jax.random.normal(jax.random.PRNGKey(3), p2.block_shape,
                          dtype=jnp.float32)
    x = x * jnp.asarray(p2.vertex_mask[None], dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        got = jax.jit(lambda v: p2_const_apply_xla(
            v, A, E, level, p2.dim, p2.pitch))(x)
        want = jax.jit(lambda v: p2_apply_local(
            v, elm, level, p2.dim, p2.pitch))(x)
    compare(got, want, 1e-5, f"p2_const_apply_xla level {level}, block "
            f"{p2.block_shape}")


@phase("blended shell apply")
def shell(level: int = SHELL_LEVEL,
          gate_level: int = SHELL_GATE_LEVEL) -> None:
    from hyteg_tpu.functions.p1 import P1Space
    from hyteg_tpu.geometry.maps import IcosahedralShellMap
    from hyteg_tpu.mesh import meshinfo as mi
    from hyteg_tpu.operators import forms
    from hyteg_tpu.operators.p1_blended import (
        P1BlendedOperator, blended_coords, p1_apply_local_vargeom_stacked)
    from hyteg_tpu.primitives.storage import CellStorage

    storage = CellStorage(mi.mesh_spherical_shell(2, 2, 0.55, 1.0))
    gmap = IcosahedralShellMap()
    key = jax.random.PRNGKey(4)

    def field(sp):
        x = jax.random.normal(key, sp.block_shape, dtype=sp.dtype)
        return x * jnp.asarray(sp.vertex_mask[None], dtype=sp.dtype)

    gsp = P1Space(storage, gate_level)
    gsd = gsp.resolve_sd(None)
    gx = field(gsp)
    gop = P1BlendedOperator(gsp, forms.laplace_form, gmap)
    want = jax.jit(lambda v: gsp.exchange_add(
        p1_apply_local_vargeom_stacked(
            v, blended_coords(gsp, gmap, 0), gsp.level, gsp.dim,
            forms.laplace_form, gsp.pitch), gsd))(gx)
    got = jax.jit(lambda v: gop.apply_raw(v, sd=gsd))(gx)
    compare(got, want, 1e-5, f"shell scan vs stacked form, level "
            f"{gate_level}")

    sp = P1Space(storage, level)
    sd = sp.resolve_sd(None)
    op = P1BlendedOperator(sp, forms.laplace_form, gmap)
    y = jax.jit(lambda v: op.apply_raw(v, sd=sd))(field(sp))
    if y.shape != sp.block_shape or not bool(jnp.isfinite(y).all()):
        raise SmokeFailure(f"shell apply level {level}: shape {y.shape} "
                           "or non-finite values")
    print(f"  shell apply level {level}: {sp.num_global_dofs()} DoFs, "
          f"block {y.shape}, finite", flush=True)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def _by_global_id(space, shards: int):
    """Function mapping per-shard blocks to a host array indexed by global
    DoF id."""
    ids = [space.global_ids(d) for d in range(shards)]
    sels = [i >= 0 for i in ids]

    def gather(blocks):
        out = np.full(space.num_global_dofs(), np.nan)
        blocks = np.asarray(blocks)
        C = blocks.shape[0] // shards
        for d in range(shards):
            out[ids[d][sels[d]]] = blocks[d * C:(d + 1) * C][sels[d]]
        return out

    return gather


def _sharded_tet(devices, level: int = 6, min_level: int = 2,
                 mesh_n: int = 2, cycles: int = SHARDED_TET_CYCLES):
    """The sharded Poisson V-cycle against the one-card stack: returns the
    two lowered programs and the comparison that runs them."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hyteg_tpu.core.types import BoundaryCondition, DoFType
    from hyteg_tpu.mesh import meshinfo as mi
    from hyteg_tpu.parallel import spmd
    from hyteg_tpu.primitives.storage import CellStorage
    from hyteg_tpu.solvers.smoothers import p1_stencil_eig_fourier
    from hyteg_tpu.solvers.templates import make_p1_gmg

    n = len(devices)
    mesh_info = mi.mesh_unit_cube(mesh_n)
    bc = BoundaryCondition.all_dirichlet()

    def U(p):
        return p[..., 0] * p[..., 1] + jnp.sin(jnp.pi * p[..., 2])

    # one card; the same Chebyshev intervals drive both runs
    stack = make_p1_gmg(CellStorage(mesh_info, num_shards=1), min_level,
                        level, smoother="chebyshev")
    eigs = {l: p1_stencil_eig_fourier(stack.operators[l].stencil,
                                      stack.space(l).dim)
            for l in stack.operators}
    sp1 = stack.space()
    x1 = sp1.interpolate(U, sp1.zeros(), DoFType.ALL, bc)
    b1 = sp1.zeros()

    ctx = spmd.SpmdContext(CellStorage(mesh_info, num_shards=n),
                           spmd.device_mesh(devices), bc)
    vcycle = spmd.build_spmd_poisson_vcycle(ctx, min_level, level,
                                            smoother="chebyshev", eigs=eigs)
    sp = ctx.space(level)
    xs = [sp.interpolate(U, sp.zeros(), DoFType.ALL, sp.shard_data(d, bc))
          for d in range(n)]
    x = jax.device_put(jnp.concatenate(xs),
                       NamedSharding(ctx.mesh, P(spmd.AXIS)))
    b = ctx.global_zeros(level)
    print(f"  tet: {sp.num_global_dofs()} DoFs over {n} shards; input on "
          f"{sorted(d.id for d in x.sharding.device_set)}", flush=True)
    lowered = [jax.jit(stack.gmg.cycle).lower(x1, b1), vcycle.lower(x, b)]

    def run(cycle1, cycle_n):
        one_card, sharded = _by_global_id(sp1, 1), _by_global_id(sp, n)
        # the one-card program run twice from the same start: the spread
        # of its scatter-adds' float32 sums, printed beside the sharded
        # difference
        xa, xb, xn = x1, x1, x
        for c in range(1, cycles + 1):
            xa, xb, xn = cycle1(xa, b1), cycle1(xb, b1), cycle_n(xn, b)
            want, got = one_card(xa), sharded(xn)
            if np.isnan(want).any() or np.isnan(got).any():
                raise SmokeFailure("a global DoF id has no value")
            d = np.abs(got - want)
            scale = np.abs(want).max()
            spread = np.abs(one_card(xb) - want).max() / scale
            print(f"  cycle {c}: max difference {d.max():.3e} at global id "
                  f"{int(d.argmax())}, rel {d.max() / scale:.3e}; one-card "
                  f"rerun: rel {spread:.3e}", flush=True)
        print(f"  output on {sorted(d.id for d in xn.sharding.device_set)}",
              flush=True)
        compare(got, want, 1e-5, f"{n}-shard vs one-card P1 after {cycles} "
                f"V-cycles, level {level}")

    return lowered, run


def _sharded_box(devices, level: int = BOX_LEVEL, min_level: int = 3,
                 cycles: int = CYCLES):
    """The row-slab box solve against the one-card box solve: returns the
    two lowered programs and the comparison that runs them."""
    from hyteg_tpu.structured import BoxDomain
    from hyteg_tpu.structured import gmg
    from hyteg_tpu.structured import spmd as box_spmd

    dom = BoxDomain((2, 2, 2), level=level)
    levels1 = gmg.build_hierarchy(dom, min_level=min_level)
    mesh = box_spmd.device_mesh(devices)
    levelsN = box_spmd.build_spmd_hierarchy(dom, mesh, min_level=min_level,
                                            eig_max=1.0)
    for l1, lN in zip(levels1, levelsN):
        lN.eig_max = l1.eig_max  # the same Chebyshev intervals
    same = all(np.array_equal(np.asarray(l1.op.w_vecs),
                              np.asarray(lN.op.op.w_vecs))
               for l1, lN in zip(levels1, levelsN))
    print(f"  box: level {level}, {dom.num_dofs()} DoFs; both hierarchies "
          f"hold bit-identical stencil weights: {same}", flush=True)
    f = jnp.asarray(dom.interior_mask, jnp.float32) * jax.random.normal(
        jax.random.PRNGKey(5), dom.block_shape, dtype=jnp.float32)
    lowered = [
        jax.jit(lambda f: gmg.solve_poisson(levels1, f, cycles=cycles))
        .lower(f),
        jax.jit(lambda f: box_spmd.spmd_solve_poisson(levelsN, f,
                                                      cycles=cycles))
        .lower(f)]

    def run(solve1, solve_n):
        u1, rns1 = solve1(f)
        un, rnsn = solve_n(f)
        print(f"  residuals one card {np.asarray(rns1)}", flush=True)
        print(f"  residuals {len(devices)} cards {np.asarray(rnsn)}",
              flush=True)
        print(f"  sharded solution on "
              f"{sorted(d.id for d in un.sharding.device_set)}", flush=True)
        compare(un, u1, 1e-5, f"{len(devices)}-slab vs one-card box solve, "
                f"level {level}, {cycles} cycles")

    return lowered, run


def four_cards(devices) -> None:
    """Set up both sharded comparisons, compile their four programs side by
    side, then run each comparison as its own phase."""
    parts = phase("four-card set-up")(lambda: [
        (name, *prepare(devices)) for name, prepare in (
            ("sharded tet P1 V-cycles", _sharded_tet),
            ("sharded box solve", _sharded_box))])()
    compiled = phase("four-card compile")(compile_all)(
        [lo for _, lowered, _ in parts for lo in lowered])
    for name, lowered, run in parts:
        phase(name)(run)(*compiled[:len(lowered)])
        compiled = compiled[len(lowered):]


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded solves, on four cards")
    args = parser.parse_args(argv)

    from hyteg_tpu.core.compile_cache import enable_compile_cache
    from hyteg_tpu.core.device import card_info

    cache = enable_compile_cache()
    devices = jax.devices()
    platform = devices[0].platform
    need = 4 if args.four_cards else 1
    if platform != "gpu" or len(devices) < need:
        print(f"chip_smoke: needs {need} GPU(s); JAX found {len(devices)} "
              f"{platform} device(s)", file=sys.stderr)
        return 1
    kind = devices[0].device_kind
    print(f"device: platform={platform} kind={kind} count={len(devices)} "
          f"jax={jax.__version__}", flush=True)
    for line in card_info():
        print(f"nvidia-smi: {line}", flush=True)
    print(f"compile cache: {cache}", flush=True)

    if args.four_cards:
        four_cards(devices[:4])
        print("sharded convection step: left out; it differs from one "
              "shard by 0.7% (ROADMAP 2.1)", flush=True)
    else:
        box_apply()
        box_gmg()
        tet_gmg()
        p2_const()
        shell()
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
