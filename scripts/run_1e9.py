"""Extreme-scale sharded box GMG run (virtual multi-device CPU mesh).

Default: (4, 4, 4) boxes at level 7 = a 513^3 grid, 1.35e8 DoFs, row-slab
sharded over 8 virtual devices — the correctness-at-scale analog of the
reference's extreme-scale GMG runs (reference: apps/2020-scaling-workshop/
Helpers.cpp:103-532; SISC 2022 TME paper).  Prints one JSON record with
per-cycle residuals and CPU wall times.

Why not execute 1025^3 here: XLA:CPU hard-terminates any collective whose
participants arrive > 40 s apart (rendezvous.cc:127).  On this 2-core
host, per-device work between halo ppermutes at 1e9 DoFs takes minutes
(measured: the run dies at the first collective at 8 AND 2 devices), so
the billion-DoF execution is environment-bound, not framework-bound: the
sharded memory footprint (4.3 GB/array split over the mesh), the
compiled program, and the per-level collectives are identical at 513^3,
which executes and converges below.  Pass m=8 to attempt the full size
on a larger host.

Usage:  python scripts/run_1e9.py [cycles] [devices] [m]
"""

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

_NDEV = int(sys.argv[2]) if len(sys.argv) > 2 else 8
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={_NDEV}")

import jax.numpy as jnp
import numpy as np


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from hyteg_tpu.structured import BoxDomain
    from hyteg_tpu.structured import spmd

    cycles = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    m = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    mesh = spmd.device_mesh(jax.devices())
    dom = BoxDomain((m, m, m), level=7, extent=(float(m),) * 3)
    print(f"devices={len(jax.devices())} dofs={dom.num_dofs():,}", flush=True)

    t0 = time.time()
    # lambda_max(D^-1 A) measured level-invariant (1.92..1.99 levels 2-7);
    # estimating it at 1e9 DoFs costs more than the solve on this host
    levels = spmd.build_spmd_hierarchy(dom, mesh, min_level=4, eig_max=1.99)
    print(f"hierarchy built in {time.time() - t0:.1f}s "
          f"({len(levels)} levels)", flush=True)

    # rhs built in-trace (iota-based): a host-side interpolate would
    # materialize a 12.9 GB coordinate array
    y, z = dom.lane_yz
    hx, hy, hz = dom.h

    def build_b():
        xs = jnp.arange(dom.X, dtype=jnp.float32) * hx
        ys = jnp.asarray(y, jnp.float32) * hy
        zs = jnp.asarray(z, jnp.float32) * hz
        f = (jnp.sin(jnp.pi * xs / m)[:, None]
             * (jnp.sin(jnp.pi * ys / m)
                * jnp.sin(jnp.pi * zs / m))[None, :])
        return levels[0].inner * f

    cycle = jax.jit(lambda x, b: spmd.spmd_vcycle(levels, x, b,
                                                  coarse_iters=20))
    rnorm = jax.jit(lambda x, b: spmd._norm(
        levels[0].inner * (b - levels[0].apply_global(x))))

    t0 = time.time()
    b = jax.jit(build_b)()
    jax.block_until_ready(b)
    x = jnp.zeros_like(b)
    print(f"rhs built in {time.time() - t0:.1f}s", flush=True)

    rns = [float(rnorm(x, b))]
    print(f"initial residual {rns[0]:.4e}", flush=True)
    walls = []
    for c in range(cycles):
        t0 = time.time()
        x = cycle(x, b)
        jax.block_until_ready(x)
        walls.append(time.time() - t0)
        rns.append(float(rnorm(x, b)))
        print(f"cycle {c + 1}: residual {rns[-1]:.4e} "
              f"rate {rns[-1] / rns[-2]:.3f} wall {walls[-1]:.1f}s",
              flush=True)

    rec = {
        "metric": "box_gmg_extreme_scale",
        "dofs": dom.num_dofs(),
        "target_dofs_1e9": 1025 ** 3,
        "devices": len(jax.devices()),
        "cycles": cycles,
        "residuals": [f"{r:.4e}" for r in rns],
        "rates": [round(rns[i + 1] / rns[i], 4) for i in range(len(rns) - 1)],
        "wall_s_per_cycle_cpu": [round(w, 1) for w in walls],
    }
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
