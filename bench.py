"""Headline benchmarks on one GPU: matrix-free apply + GMG V-cycle.

Mirrors the reference's ApplyBenchmark and MultigridStudies drivers
(reference: apps/benchmarks/ApplyBenchmark/ApplyBenchmark.cpp:104 —
GDoF/s = global DoF updates per second; apps/2020-scaling-workshop/
Helpers.cpp:31-71,532 — per-V-cycle wall time).

One JSON line per metric (the first is the headline):

  1. box fast path apply — unit cube as 2x2x2 Kuhn boxes, level 7
     (257^3 = 17.0M DoFs) in one dense block (hyteg_tpu/structured/),
  2. box GMG V(2,2)-cycle wall time at level 7,
  3. general tet P1 GMG V-cycle wall time,
  4. box apply with bfloat16 storage,
  5. blended icosahedral-shell apply (exact vargeom, gated scan-vs-
     stacked) + LSQP surrogate (the TerraNeo geometry; reference:
     p1_diffusion_blending_q3 family and P1SurrogateOperator).

Every timed kernel first passes an on-device correctness gate at the
exact benchmarked shapes (core/benchgate.py): an independent formulation
must agree, and solvers must converge, else the line reports an error.

Timing: applies are chained inside one jitted ``lax.scan`` at two
lengths; the marginal time removes dispatch and fetch overheads
(core/benchtime.py).  ``vs_baseline`` is the fraction of the card's
published memory bandwidth at the bytes one apply must move per DoF
(8 B in f32, 4 B with bfloat16 storage), from PEAKS.  Every line names
the device it ran on.  The script exits non-zero on a platform other
than the GPU, on a device kind missing from PEAKS, and when any line
fails.
"""

import json
import sys
import traceback

import jax
import jax.numpy as jnp

#: Published peaks per ``device_kind``.  NVIDIA H100 SXM5 data sheet,
#: dense rates without sparsity, at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gb_s": 3350.0, "f32_tflop_s": 67.0,
                              "bf16_tflop_s": 989.0},
}


def device_peaks(kind: str) -> dict:
    """Peak rates of a device kind; an unknown kind is an error."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(f"no peak rates for device kind {kind!r}: add it "
                         "to bench.PEAKS with its source") from None


def _vs_baseline(gdofs_per_s: float, peaks: dict,
                 bytes_per_dof: float = 8.0) -> float:
    return round(gdofs_per_s / (peaks["hbm_gb_s"] / bytes_per_dof), 4)


def bench_box(peaks: dict, level: int = 7):
    from hyteg_tpu.core.benchgate import gate_box_apply, gate_positive_time
    from hyteg_tpu.core.benchtime import auto_time
    from hyteg_tpu.structured import BoxDomain, BoxStencilOperator

    dom = BoxDomain((2, 2, 2), level=level)
    op = BoxStencilOperator(dom)

    key = jax.random.PRNGKey(0)
    u = jax.random.normal(key, dom.block_shape, dtype=jnp.float32)

    gate_box_apply(op, u)

    dt = gate_positive_time(
        auto_time(lambda v: op.apply_raw(v), u, repeats=3),
        "box apply marginal time")
    gdofs_per_s = dom.num_dofs() / 1e9 / dt
    return {
        "metric": "p1_laplace_apply_gdofs_per_s",
        "value": round(gdofs_per_s, 4),
        "unit": "GDoF/s",
        "vs_baseline": _vs_baseline(gdofs_per_s, peaks),
    }


def bench_box_bf16(peaks: dict, level: int = 7):
    """Mixed-precision box apply: bf16 block stream, f32 weights and
    accumulation (the float configuration of the reference's mixed-
    precision support, tests/hyteg/mixedPrecision/). Gated against the
    f32 apply at bf16 storage tolerance."""
    from hyteg_tpu.core.benchgate import gate_close, gate_positive_time
    from hyteg_tpu.core.benchtime import auto_time
    from hyteg_tpu.structured import BoxDomain, BoxStencilOperator

    dom = BoxDomain((2, 2, 2), level=level)
    op = BoxStencilOperator(dom)
    key = jax.random.PRNGKey(0)
    u = jax.random.normal(key, dom.block_shape, dtype=jnp.float32)
    ub = u.astype(jnp.bfloat16)

    yb = jax.jit(op.apply_raw)(ub)
    gate_close(yb.astype(jnp.float32), op._apply_xla(u),
               f"bf16 vs f32 box apply at {dom.block_shape}", rtol=2e-2)

    dt = gate_positive_time(
        auto_time(lambda v: op.apply_raw(v), ub, repeats=3),
        "bf16 box apply marginal time")
    gdofs_per_s = dom.num_dofs() / 1e9 / dt
    return {
        "metric": "p1_laplace_apply_bf16_gdofs_per_s",
        "value": round(gdofs_per_s, 4),
        "unit": "GDoF/s",
        "vs_baseline": _vs_baseline(gdofs_per_s, peaks, bytes_per_dof=4.0),
    }


def bench_box_vcycle(peaks: dict, level: int = 7):
    """GMG V(2,2)-cycle wall time on the box fast path (the north-star
    metric; reference: Helpers.cpp:31-71,532)."""
    from hyteg_tpu.core.benchgate import (gate_box_apply, gate_positive_time,
                                          gate_residuals)
    from hyteg_tpu.core.benchtime import eager_marginal_time
    from hyteg_tpu.structured import BoxDomain
    from hyteg_tpu.structured import gmg as box_gmg

    dom = BoxDomain((2, 2, 2), level=level)
    levels = box_gmg.build_hierarchy(dom, min_level=min(3, level - 1))
    key = jax.random.PRNGKey(0)
    inner = jnp.asarray(dom.interior_mask, dtype=jnp.float32)
    b = inner * jax.random.normal(key, dom.block_shape, dtype=jnp.float32)

    gate_box_apply(levels[0].op, b)
    x = jnp.zeros_like(b)
    step = jax.jit(lambda x: box_gmg.vcycle(levels, x, b))
    rns = [float(box_gmg._norm(inner * levels[0].op.residual(x, b)))]
    for _ in range(6):
        x = step(x)
        rns.append(float(box_gmg._norm(inner * levels[0].op.residual(x, b))))
    gate_residuals(rns, f"box V(2,2) at level {level}", max_rate=0.4,
                   min_cycles=4)

    dt = gate_positive_time(
        eager_marginal_time(lambda v: box_gmg.vcycle(levels, v, b),
                            jnp.zeros_like(b)),
        "box V-cycle marginal time")
    gdofs = dom.num_dofs() / 1e9
    return {
        "metric": f"box_p1_vcycle_level{level}_ms",
        "value": round(dt * 1e3, 3),
        "unit": "ms",
        "gdofs_per_s": round(gdofs / dt, 4),
        "residual_rate": round((rns[4] / rns[0]) ** 0.25, 4),
        "vs_baseline": _vs_baseline(gdofs / dt, peaks),
    }


def bench_tet_vcycle(peaks: dict, level: int = 5):
    """P1 GMG V-cycle wall time on the general macro-tet path."""
    from hyteg_tpu.core.benchgate import gate_positive_time, gate_residuals
    from hyteg_tpu.core.benchtime import eager_marginal_time
    from hyteg_tpu.core.types import FLAG_INNER
    from hyteg_tpu.mesh import meshinfo as mi
    from hyteg_tpu.primitives.storage import CellStorage
    from hyteg_tpu.solvers.templates import make_p1_gmg

    storage = CellStorage(mi.mesh_unit_cube(2), num_shards=1)
    stack = make_p1_gmg(storage, min_level=2, max_level=level,
                        smoother="chebyshev", coarse_iters=30)
    sp = stack.space()
    sd = sp.resolve_sd(None)
    key = jax.random.PRNGKey(0)
    b = jax.random.normal(key, sp.block_shape, dtype=sp.dtype)
    b = b * jnp.asarray(sp.vertex_mask[None], dtype=sp.dtype)
    # interface replicas must agree (one value per DoF) and non-inner
    # rows must be zero, else no consistent x can match b
    b = sp.exchange_rep(b, sd)
    b = sp.restore_rows(b, jnp.zeros_like(b), FLAG_INNER, sd)

    x = jnp.zeros_like(b)
    step = jax.jit(lambda x: stack.gmg.cycle(x, b))
    rns = [float(stack.residual_norm(x, b))]
    for _ in range(5):
        x = step(x)
        rns.append(float(stack.residual_norm(x, b)))
    gate_residuals(rns, f"tet P1 V-cycle level {level}", max_rate=0.6,
                   min_cycles=4)

    dt = gate_positive_time(
        eager_marginal_time(lambda v: stack.gmg.cycle(v, b),
                            jnp.zeros_like(b)),
        "tet V-cycle marginal time")
    gdofs = sp.num_global_dofs() / 1e9
    return {
        "metric": f"tet_p1_vcycle_level{level}_ms",
        "value": round(dt * 1e3, 3),
        "unit": "ms",
        "gdofs_per_s": round(gdofs / dt, 4),
        "residual_rate": round((rns[4] / rns[0]) ** 0.25, 4),
        "vs_baseline": _vs_baseline(gdofs / dt, peaks),
    }


def bench_shell(peaks: dict, level: int = 4, gate_level: int = 3):
    """Blended icosahedral-shell apply: exact vargeom (scan-form), gated
    on device against the independent stacked-form evaluation, plus the
    LSQP surrogate fast path."""
    from hyteg_tpu.core.benchgate import gate_close, gate_positive_time
    from hyteg_tpu.core.benchtime import auto_time
    from hyteg_tpu.functions.p1 import P1Space
    from hyteg_tpu.geometry.maps import IcosahedralShellMap
    from hyteg_tpu.mesh import meshinfo as mi
    from hyteg_tpu.operators import forms
    from hyteg_tpu.operators.p1_blended import (
        P1BlendedOperator, P1SurrogateOperator, blended_coords,
        p1_apply_local_vargeom_stacked)
    from hyteg_tpu.primitives.storage import CellStorage

    storage = CellStorage(mi.mesh_spherical_shell(2, 2, 0.55, 1.0),
                          num_shards=1)
    gmap = IcosahedralShellMap()
    key = jax.random.PRNGKey(0)

    # on-device cross-check: scan-form vs the independent stacked-form
    # evaluation through the same exchange
    gsp = P1Space(storage, gate_level)
    gsd = gsp.resolve_sd(None)
    gx = jax.random.normal(key, gsp.block_shape, dtype=gsp.dtype)
    gx = gx * jnp.asarray(gsp.vertex_mask[None], dtype=gsp.dtype)
    gop = P1BlendedOperator(gsp, forms.laplace_form, gmap)
    gco = blended_coords(gsp, gmap, 0)
    ref = gsp.exchange_add(
        p1_apply_local_vargeom_stacked(gx, gco, gsp.level, gsp.dim,
                                       forms.laplace_form, gsp.pitch), gsd)
    gate_close(gop.apply_raw(gx, sd=gsd), ref,
               f"shell vargeom scan-vs-stacked at {gsp.block_shape}")

    space = P1Space(storage, level)
    op = P1BlendedOperator(space, forms.laplace_form, gmap)
    sd = space.resolve_sd(None)
    x = jax.random.normal(key, space.block_shape, dtype=space.dtype)
    x = x * jnp.asarray(space.vertex_mask[None], dtype=space.dtype)

    dt = gate_positive_time(
        auto_time(lambda v: op.apply_raw(v, sd=sd), x, repeats=3),
        "shell vargeom marginal time")
    gdofs_per_s = space.num_global_dofs() / 1e9 / dt
    sur = P1SurrogateOperator(space, forms.laplace_form, gmap, degree=2)
    err = float(sur.compute_surrogate_error(op, x))
    dt2 = gate_positive_time(
        auto_time(lambda v: sur.apply_raw(v, sd=sd), x, repeats=3),
        "shell surrogate marginal time")
    return {
        "metric": "p1_shell_blended_apply_gdofs_per_s",
        "value": round(gdofs_per_s, 4),
        "unit": "GDoF/s",
        "vs_baseline": _vs_baseline(gdofs_per_s, peaks),
        "surrogate_gdofs_per_s": round(
            space.num_global_dofs() / 1e9 / dt2, 4),
        "surrogate_rel_error": round(err, 6),
    }


def main() -> int:
    from hyteg_tpu.core.compile_cache import enable_compile_cache
    from hyteg_tpu.core.device import device_stamp

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    peaks = device_peaks(dev.device_kind)
    stamp = device_stamp()
    failed = 0
    # headline first, then the north-star V-cycle wall times, then the
    # remaining apply lines
    for fn in (bench_box, bench_box_vcycle, bench_tet_vcycle,
               bench_box_bf16, bench_shell):
        try:
            rec = fn(peaks)
        except Exception as e:  # report the line and go on to the next
            traceback.print_exc()
            rec = {"metric": fn.__name__, "error": str(e)[:200]}
            failed += 1
        print(json.dumps({**rec, **stamp}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
