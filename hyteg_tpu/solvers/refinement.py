"""Mixed-precision iterative refinement.

Equivalent of the reference's mixed-precision configuration
(reference: tests/hyteg/mixedPrecision/mixedPrecisionIterativeRefinement.cpp
— function spaces templated on ValueType, refined in higher precision). The
natural split is bfloat16 for the bandwidth-bound inner solver (half the
bytes of every stencil sweep) and float32 for the outer
residual/accumulation:

    r_k = b - A x_k            (f32 matvec)
    d_k = solve_lo(r_k)        (bf16 inner solver, approximate)
    x_{k+1} = x_k + d_k        (f32 update)

which recovers f32-level accuracy as long as the inner solve reduces the
error by any fixed factor."""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def iterative_refinement(
    apply_hi: Callable,
    inner_solve_lo: Callable,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    num_outer: int,
    lo_dtype=jnp.bfloat16,
) -> jnp.ndarray:
    """x <- x + up( inner_solve_lo( down(b - A x) ) ), ``num_outer`` times.

    ``inner_solve_lo`` maps a lo-precision residual block to a lo-precision
    correction (e.g. some V-cycles or smoother sweeps built on a lo-dtype
    space)."""
    hi = b.dtype

    def body(_, x):
        r = b - apply_hi(x)
        d = inner_solve_lo(r.astype(lo_dtype))
        return x + d.astype(hi)

    return jax.lax.fori_loop(0, num_outer, body, x0)
