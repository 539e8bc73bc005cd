"""Pallas kernel (Triton route) for the BoxDomain 15-point stencil apply.

The box layout makes this the minimal stencil kernel: no diagonal shells
and no face inclusion-exclusion in the kernel.  The boundary handling
lives in the precomputed per-lane weight vectors (structured/kuhn.py)
plus two single-row fixes.

Work split.  Program (j, k) owns lane tile j (``block_lanes`` lanes) and
walks the rows of x-chunk k (``chunk_rows`` rows) in a loop.  The 15
directions fall into 7 lane shifts (0, +-1, +-Z, +-(Z+1)); each row is
read once per lane shift and folded into three dx-grouped sums

    C(r) = sum_{dx=0} w u[r, l+ls],  P(r) = sum_{dx=+1} ...,
    M(r) = sum_{dx=-1} ...,

so that dst[r-1] = C(r-1) + P(r) + M(r-2): 7 reads per row instead of 15,
and the loop carries C and M of the last two rows in registers.  The
interior weights of the tile are loaded once per program.  Lane and row
indices of the reads are clamped into the array: every clamped read
carries an exactly zero weight (kuhn.lane_weights), so no masks are
needed on loads.  Rows 0 and X-1 take their own weight vectors and are
recomputed after the loop by the programs that own them.

Storage may be bfloat16: the kernel loads the storage dtype, accumulates
in float32 with float32 weights, and stores the storage dtype.

Reference analog: src/constant_stencil_operator/P1generatedKernels/
apply_3D_macrocell_vertexdof_to_vertexdof_replace.cpp:14-60 (the 15-point
sweep); the aggregation over whole micro-cubes removes its per-primitive
boundary loops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..structured import kuhn


def _terms(Z: int):
    """(s, dx, lane shift) per stencil direction, and the sorted shifts."""
    dirs = kuhn.stencil_dirs()
    terms = [(s, int(d[0]), int(d[1]) * Z + int(d[2]))
             for s, d in enumerate(dirs)]
    return terms, sorted({ls for _, _, ls in terms})


def _make_kernel(X: int, Y: int, Z: int, block_lanes: int, chunk_rows: int):
    L = Y * Z
    terms, shifts = _terms(Z)
    n_s = len(terms)
    BL, XC = block_lanes, chunk_rows

    def kernel(w_ref, u_ref, o_ref):
        j = pl.program_id(0)
        x0 = pl.program_id(1) * XC
        lanes = j * BL + jnp.arange(BL, dtype=jnp.int32)
        lane_ok = lanes < L
        lidx = {ls: jnp.clip(lanes + ls, 0, L - 1) for ls in shifts}

        def weights(c):
            return [w_ref[c * n_s + s, lidx[0]] for s in range(n_s)]

        def reads(r):
            rc = jnp.clip(r, 0, X - 1)
            return {ls: u_ref[rc, lidx[ls]].astype(jnp.float32)
                    for ls in shifts}

        def group(w, rd, gdx):
            acc = None
            for s, dx, ls in terms:
                if dx == gdx:
                    t = w[s] * rd[ls]
                    acc = t if acc is None else acc + t
            return acc

        def store(r, v):
            pltriton.store(o_ref.at[r, pl.ds(j * BL, BL)],
                           v.astype(o_ref.dtype), mask=lane_ok)

        w0 = weights(0)
        m_prev = group(w0, reads(x0 - 1), -1)
        rd = reads(x0)
        carry = (m_prev, group(w0, rd, 0), group(w0, rd, -1))

        def body(i, carry):
            m_prev, c_cur, m_cur = carry
            r = x0 + 1 + i
            rd = reads(r)

            @pl.when(r - 1 < X)
            def _():
                store(r - 1, c_cur + group(w0, rd, 1) + m_prev)

            return m_cur, group(w0, rd, 0), group(w0, rd, -1)

        jax.lax.fori_loop(0, XC, body, carry)

        # dx = -1 weights are exactly zero on row 0, dx = +1 on row X-1
        @pl.when(x0 == 0)
        def _():
            w1 = weights(1)
            store(0, group(w1, reads(0), 0) + group(w1, reads(1), 1))

        @pl.when(x0 + XC >= X)
        def _():
            w2 = weights(2)
            store(X - 1, group(w2, reads(X - 1), 0)
                  + group(w2, reads(X - 2), -1))

    return kernel


@functools.partial(jax.jit, static_argnames=("dims", "block_lanes",
                                             "chunk_rows", "interpret"))
def box_apply_triton(u: jnp.ndarray, w_vecs: jnp.ndarray, dims,
                     block_lanes: int = 256, chunk_rows: int = 64,
                     interpret: bool = False) -> jnp.ndarray:
    """u: (X, L) in float32 or bfloat16; w_vecs: (3, n_s, L) from
    kuhn.lane_weights.  Returns A u in the dtype of ``u``.

    The default tile (with 4 warps per program) was the fastest of ten
    (block_lanes, chunk_rows, warps) choices on an H100 (400 W limit) at
    513^3 DoFs; the other nine took 1.06-1.45x as long."""
    X, Y, Z = dims
    L = Y * Z
    if u.shape != (X, L):
        raise ValueError(f"u has shape {u.shape}, expected {(X, L)}")
    if X < 2:
        raise ValueError(f"the box kernel needs X >= 2 rows, got {X}")
    n_s = w_vecs.shape[1]
    w = w_vecs.reshape(3 * n_s, L).astype(jnp.float32)
    grid = (pl.cdiv(L, block_lanes), pl.cdiv(X, chunk_rows))
    return pl.pallas_call(
        _make_kernel(X, Y, Z, block_lanes, chunk_rows),
        grid=grid,
        out_shape=jax.ShapeDtypeStruct(u.shape, u.dtype),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4,
                                                num_stages=1),
        name="box_stencil_apply",
        interpret=interpret,
    )(w, u)
