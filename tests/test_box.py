"""Box fast path: stencil apply vs brute-force FE assembly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hyteg_tpu.operators import forms
from hyteg_tpu.structured import BoxDomain, BoxStencilOperator
from hyteg_tpu.structured import kuhn


def assemble_dense(domain, form):
    """Brute-force global FE matrix over all micro-tets (numpy)."""
    X, Y, Z = domain.dims
    n = X * Y * Z

    def gid(p):
        return (p[0] * Y + p[1]) * Z + p[2]

    verts = kuhn.micro_vertices(domain.h)
    elm = np.asarray(form(jnp.asarray(verts)))  # (6, 4, 4)
    A = np.zeros((n, n))
    for bx in range(X - 1):
        for by in range(Y - 1):
            for bz in range(Z - 1):
                base = np.array([bx, by, bz])
                for t in range(6):
                    nodes = [gid(base + kuhn.KUHN_OFFSETS[t, a])
                             for a in range(4)]
                    for a in range(4):
                        for b in range(4):
                            A[nodes[a], nodes[b]] += elm[t, a, b]
    return A


@pytest.mark.parametrize("m,extent", [
    ((2, 1, 1), (1.0, 1.0, 1.0)),
    ((1, 1, 1), (2.0, 1.0, 0.5)),
])
@pytest.mark.parametrize("form", [forms.laplace_form, forms.mass_form])
def test_apply_matches_assembly(m, extent, form):
    domain = BoxDomain(m, level=2, extent=extent)
    A = assemble_dense(domain, form)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(domain.block_shape).astype(np.float32)
    X, Y, Z = domain.dims
    want = (A @ u.reshape(-1)).reshape(X, Y * Z)
    got = np.asarray(BoxStencilOperator(domain, form)._apply_xla(
        jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_diagonal_matches_assembly():
    domain = BoxDomain((1, 2, 1), level=2)
    A = assemble_dense(domain, forms.laplace_form)
    op = BoxStencilOperator(domain)
    X, Y, Z = domain.dims
    want = np.diag(A).reshape(X, Y * Z)
    np.testing.assert_allclose(np.asarray(op.diagonal), want, rtol=1e-5)


# (m, level, block_lanes, chunk_rows): lane counts 81 and 45 are not powers
# of two; X = 17 and X = 9 are not multiples of the row chunk
KERNEL_SHAPES = [((2, 1, 1), 3, 64, 5), ((1, 1, 2), 2, 16, 4)]


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,level,block_lanes,chunk_rows", KERNEL_SHAPES)
def test_apply_triton_interpret(m, level, block_lanes, chunk_rows, dtype,
                                tol):
    """The Triton kernel in interpret mode against the XLA formulation."""
    from hyteg_tpu.kernels.box_stencil import box_apply_triton

    domain = BoxDomain(m, level=level)
    op = BoxStencilOperator(domain)
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.standard_normal(domain.block_shape), dtype)
    want = np.asarray(op._apply_xla(u), np.float32)
    got = box_apply_triton(u, op.w_vecs, domain.dims,
                           block_lanes=block_lanes, chunk_rows=chunk_rows,
                           interpret=True)
    assert got.dtype == dtype
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= tol * np.abs(want).max()


@pytest.mark.parametrize("m,level", [((2, 1, 1), 3), ((1, 2, 3), 2)])
def test_apply_bf16_storage_accumulates_in_f32(m, level):
    """bf16 storage: f32 weights and sums, bf16 result, within bf16
    rounding of the f32 apply."""
    domain = BoxDomain(m, level=level)
    op = BoxStencilOperator(domain)
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.standard_normal(domain.block_shape), jnp.float32)
    want = np.asarray(op.apply_raw(u))
    got = op.apply_raw(u.astype(jnp.bfloat16))
    assert got.dtype == jnp.bfloat16
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= 2e-2 * np.abs(want).max()


def test_apply_raw_takes_xla_on_cpu():
    """A CPU array takes the XLA formulation: no kernel in the program."""
    domain = BoxDomain((2, 1, 1), level=2)
    op = BoxStencilOperator(domain)
    u = jnp.ones(domain.block_shape, jnp.float32)
    hlo = jax.jit(op.apply_raw).lower(u).as_text()
    assert "triton" not in hlo.lower()
    np.testing.assert_array_equal(np.asarray(op.apply_raw(u)),
                                  np.asarray(op._apply_xla(u)))
