"""V-cycle benchmark: P1 and P2 Laplace GMG V-cycle wall time + DoF/s.

Reference: apps/MultigridStudies/ and the 2020-scaling-workshop drivers
(apps/2020-scaling-workshop/Helpers.cpp:31-71,532) measure per-V-cycle
wall time, residual-reduction tables and timing-tree JSON; this is the
single-chip analog (the north-star metric of BASELINE.md is a P2 Laplace
GMG V-cycle).

Usage: python bench_vcycle.py [p1_level] [p2_level]
Prints one JSON line per discretization plus a residual-per-cycle table
written through io.tables (FixedSizeSQLDB analog).
"""

import json
import sys

import jax
import jax.numpy as jnp


def _gate_stack(stack, step, b, what, cycles=4, max_rate=0.6):
    """Convergence gate for a GMG stack before it is timed."""
    from hyteg_tpu.core.benchgate import gate_residuals

    x = jnp.zeros_like(b)
    rns = [float(stack.residual_norm(x, b))]
    jstep = jax.jit(step)
    for _ in range(cycles):
        x = jstep(x)
        rns.append(float(stack.residual_norm(x, b)))
    gate_residuals(rns, what, max_rate=max_rate, min_cycles=cycles)


def bench_p1(level: int):
    from hyteg_tpu.core.benchtime import auto_time
    from hyteg_tpu.core.types import BoundaryCondition
    from hyteg_tpu.mesh import meshinfo as mi
    from hyteg_tpu.primitives.storage import CellStorage
    from hyteg_tpu.solvers.templates import make_p1_gmg

    storage = CellStorage(mi.mesh_unit_cube(2), num_shards=1)
    stack = make_p1_gmg(storage, min_level=2, max_level=level,
                        smoother="chebyshev", coarse_iters=20)
    sp = stack.space()
    key = jax.random.PRNGKey(0)
    b = jax.random.normal(key, sp.block_shape, dtype=sp.dtype)
    b = b * jnp.asarray(sp.vertex_mask[None], dtype=sp.dtype)
    b = stack.residual(jnp.zeros_like(b), b)  # restrict rhs to solved rows

    def step(x):
        return stack.gmg.cycle(x, b)

    _gate_stack(stack, step, b, f"p1 V-cycle level {level}")

    dt = auto_time(step, jnp.zeros_like(b), repeats=3)
    gdofs = sp.num_global_dofs() / 1e9
    return {"metric": f"p1_vcycle_level{level}", "value": round(dt * 1e3, 3),
            "unit": "ms", "gdofs_per_s": round(gdofs / dt, 4)}


def bench_p2(level: int):
    from hyteg_tpu.core.benchtime import auto_time
    from hyteg_tpu.core.types import BoundaryCondition
    from hyteg_tpu.mesh import meshinfo as mi
    from hyteg_tpu.primitives.storage import CellStorage
    from hyteg_tpu.solvers.templates import make_p2_gmg

    storage = CellStorage(mi.mesh_unit_cube(2), num_shards=1)
    stack = make_p2_gmg(storage, min_level=1, max_level=level,
                        coarse_iters=20)
    sp = stack.space()
    key = jax.random.PRNGKey(0)
    b = jax.random.normal(key, sp.block_shape, dtype=jnp.float32)
    b = b * jnp.asarray(sp.vertex_mask[None], dtype=jnp.float32)
    b = stack.residual(jnp.zeros_like(b), b)  # restrict rhs to solved rows

    def step(x):
        return stack.gmg.cycle(x, b)

    _gate_stack(stack, step, b, f"p2 V-cycle level {level}")

    dt = auto_time(step, jnp.zeros_like(b), repeats=3)
    gdofs = sp.num_global_dofs() / 1e9
    return {"metric": f"p2_vcycle_level{level}", "value": round(dt * 1e3, 3),
            "unit": "ms", "gdofs_per_s": round(gdofs / dt, 4)}


def bench_box(level: int):
    """V(2,2) cycle on the structured box fast path (flagship)."""
    from hyteg_tpu.core.benchgate import gate_box_apply, gate_residuals
    from hyteg_tpu.core.benchtime import auto_time
    from hyteg_tpu.structured import BoxDomain
    from hyteg_tpu.structured import gmg as box_gmg

    dom = BoxDomain((2, 2, 2), level=level)
    levels = box_gmg.build_hierarchy(dom, min_level=min(3, level - 1))
    key = jax.random.PRNGKey(0)
    inner = jnp.asarray(dom.interior_mask, dtype=jnp.float32)
    b = inner * jax.random.normal(key, dom.block_shape, dtype=jnp.float32)

    # correctness gates at the timed shapes: kernel equivalence + the
    # solver must actually converge before its speed means anything
    gate_box_apply(levels[0].op, b)
    x = jnp.zeros_like(b)
    rns = [float(box_gmg._norm(inner * levels[0].op.residual(x, b)))]
    for _ in range(4):
        x = jax.jit(lambda x: box_gmg.vcycle(levels, x, b))(x)
        rns.append(float(box_gmg._norm(inner * levels[0].op.residual(x, b))))
    gate_residuals(rns, f"box V(2,2) at level {level}", max_rate=0.4,
                   min_cycles=4)

    def step(x):
        return box_gmg.vcycle(levels, x, b)

    dt = auto_time(step, jnp.zeros_like(b), repeats=3)
    gdofs = dom.num_dofs() / 1e9
    return {"metric": f"box_p1_vcycle_level{level}",
            "value": round(dt * 1e3, 3),
            "unit": "ms", "gdofs_per_s": round(gdofs / dt, 4),
            "residual_rate": round((rns[-1] / rns[0]) ** 0.25, 4)}


def main():
    from hyteg_tpu.core.compile_cache import enable_compile_cache

    enable_compile_cache()
    p1_level = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    p2_level = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    box_level = int(sys.argv[3]) if len(sys.argv) > 3 else 7
    for rec in (bench_box(box_level), bench_p1(p1_level), bench_p2(p2_level)):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
