"""Weak-scaling and large-run benchmark harness (single chip).

Reference parity: apps/benchmarks/ApplyBenchmark/ApplyBenchmark.cpp:104
(GDoF/s over a growing face-chain at fixed per-process work) and the
2020-scaling-workshop drivers (apps/2020-scaling-workshop/
Helpers.cpp:31-71,532 — per-cycle residual tables + timing JSON).

Three sections, each one JSON line + a table written via io.tables:

  1. weak-scaling apply: box domains of growing macro count at fixed
     level — GDoF/s should stay ~flat as the domain grows,
  2. large apply: >= 1e8 DoFs on one chip (513^3-equivalent grid),
  3. V-cycle residual table: per-cycle residuals of a full Poisson
     solve (FixedSizeSQLDB + Table sinks).

The path to 1e9 DoFs: a 1025^3 grid is 4.3 GB in f32, which fits one
80 GB card, or four with the row-slab SPMD sharding of
structured/spmd.py; per-card work is identical to section 2.

Usage: python bench_scaling.py [level]
"""

import json
import sys
import time

import jax
import jax.numpy as jnp


def _marginal(step, x, what="bench_scaling"):
    """Marginal time with an auto-sized window; a non-positive result is
    a measurement failure, never clamped (round 3 committed a
    0.0 ms -> 2.1e9 GDoF/s row from exactly that clamp)."""
    from hyteg_tpu.core.benchgate import gate_positive_time
    from hyteg_tpu.core.benchtime import auto_time

    return gate_positive_time(auto_time(step, x, repeats=3), what)


def weak_scaling(level: int):
    """Fixed refinement level, growing macro count: GDoF/s should stay
    ~flat (the single-chip analog of ApplyBenchmark's face-chain weak
    scaling, ApplyBenchmark.cpp:48-52).  Run at level >= 7 — smaller
    blocks take < 0.1 ms/apply and the marginal-time methodology then
    measures dispatch jitter, which produced round 3's falling curve."""
    from hyteg_tpu.core.benchgate import gate_box_apply
    from hyteg_tpu.io.tables import Table
    from hyteg_tpu.structured import BoxDomain, BoxStencilOperator

    tab = Table(["m", "dofs", "ms_per_apply", "gdofs_per_s"])
    rows = []
    for m in [(1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2)]:
        dom = BoxDomain(m, level=level)
        op = BoxStencilOperator(dom)
        u = jax.random.normal(jax.random.PRNGKey(0), dom.block_shape,
                              dtype=jnp.float32)
        gate_box_apply(op, u)
        dt = _marginal(lambda v: op.apply_raw(v), u,
                       f"weak scaling m={m} level={level}")
        g = dom.num_dofs() / 1e9 / dt
        tab.add_row(str(m), dom.num_dofs(), round(dt * 1e3, 4), round(g, 3))
        rows.append(g)
    tab.write_text("bench_weak_scaling.txt")
    eff = rows[-1] / max(rows[0], 1e-30)
    return {"metric": f"box_weak_scaling_level{level}",
            "value": round(rows[-1], 3), "unit": "GDoF/s",
            "weak_efficiency_vs_1cube": round(eff, 3)}


def large_apply():
    """>= 1e8 DoFs on one chip: (16,2,2) boxes at level 7 = 2049 x 257 x
    257 = 135.3M nodes (same uniform h as a 513^3 cube)."""
    from hyteg_tpu.structured import BoxDomain, BoxStencilOperator

    from hyteg_tpu.core.benchgate import gate_box_apply

    dom = BoxDomain((16, 2, 2), level=7, extent=(8.0, 1.0, 1.0))
    op = BoxStencilOperator(dom)
    u = jax.random.normal(jax.random.PRNGKey(0), dom.block_shape,
                          dtype=jnp.float32)
    gate_box_apply(op, u)
    dt = _marginal(lambda v: op.apply_raw(v), u, "large apply")
    return {"metric": "box_large_apply", "dofs": dom.num_dofs(),
            "value": round(dom.num_dofs() / 1e9 / dt, 3), "unit": "GDoF/s",
            "ms_per_apply": round(dt * 1e3, 3)}


def vcycle_residual_table(level: int):
    from hyteg_tpu.io.tables import FixedSizeSQLDB, Table
    from hyteg_tpu.operators import forms
    from hyteg_tpu.structured import BoxDomain, BoxStencilOperator
    from hyteg_tpu.structured import gmg

    from hyteg_tpu.core.benchgate import gate_residuals

    dom = BoxDomain((2, 2, 2), level=level)
    levels = gmg.build_hierarchy(dom, min_level=min(2, level - 1))
    exact = lambda x, y, z: jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y) * jnp.sin(jnp.pi * z)
    f = dom.interpolate(lambda x, y, z: 3 * jnp.pi**2 * exact(x, y, z))
    b = BoxStencilOperator(dom, forms.mass_form).apply_raw(f)

    t0 = time.time()
    u, rns = jax.jit(
        lambda b: gmg.solve_poisson(levels, b, cycles=8, pre=3, post=3))(b)
    jax.block_until_ready(rns)
    wall = time.time() - t0

    rns = [float(r) for r in rns]
    # refuse to publish a diverging solve (round-3 failure mode): monotone
    # decrease + mean rate <= 0.3 over the pre-roundoff window
    gate_residuals(rns, f"box Poisson V(3,3) level {level}", max_rate=0.3,
                   min_cycles=4)
    tab = Table(["cycle", "residual", "rate"])
    db = FixedSizeSQLDB("bench_vcycle_residuals.db")
    db.set_constant_entry("level", level)
    db.set_constant_entry("dofs", dom.num_dofs())
    for i, r in enumerate(rns):
        rate = r / rns[i - 1] if i else float("nan")
        tab.add_row(i + 1, f"{r:.3e}", f"{rate:.3f}" if i else "-")
        db.set_variable_entry("cycle", i + 1)
        db.set_variable_entry("residual", r)
        db.write_row_on_root()
    tab.write_text("bench_vcycle_residuals.txt")
    # average the pre-roundoff window only: once the residual hits the
    # f32 noise floor the per-cycle "rate" tends to 1 by construction
    floor = 5.0 * rns[-1]
    k = max(3, sum(1 for r in rns if r > floor))
    avg_rate = (rns[k - 1] / rns[0]) ** (1.0 / (k - 1))
    return {"metric": f"box_poisson_solve_level{level}",
            "value": round(wall, 3), "unit": "s_incl_compile",
            "dofs": dom.num_dofs(),
            "avg_residual_rate": round(avg_rate, 4)}


def main():
    from hyteg_tpu.core.compile_cache import enable_compile_cache

    enable_compile_cache()
    level = int(sys.argv[1]) if len(sys.argv) > 1 else 7
    for rec in (weak_scaling(level), large_apply(),
                vcycle_residual_table(level)):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
