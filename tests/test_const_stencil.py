"""Constant-stencil fast-path tests: the XLA formulation pinned against
the general elementwise path.

Reference: the generated constant-stencil kernels
(src/constant_stencil_operator/P1generatedKernels/) are verified against the
elementwise operators in tests/hyteg/P1/P1LaplaceOperator3DTest.cpp-style
equivalence tests; this is the same pyramid for the const-stencil path.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hyteg_tpu.functions.p1 import P1Space
from hyteg_tpu.kernels.p1_const_stencil import (
    face_weights_full,
    ordered_scatter_add,
    p1_const_apply_xla,
    stencil_tables,
    stencil_weights,
)
from hyteg_tpu.mesh import meshinfo as mi
from hyteg_tpu.operators import forms
from hyteg_tpu.operators.p1_elementwise import (
    P1ElementwiseOperator,
    compute_elmats,
    p1_apply_local,
)
from hyteg_tpu.primitives.storage import CellStorage


CASES = [
    ("cube_l2", lambda: mi.mesh_unit_cube(1), 2),
    ("cube_l3", lambda: mi.mesh_unit_cube(1), 3),
    ("rect_l3", lambda: mi.mesh_rectangle((0, 0), (1, 1), 2, 1), 3),
    ("annulus_l2", lambda: mi.mesh_annulus(0.5, 1.0, 6, 1), 2),
    ("cube2_l2", lambda: mi.mesh_unit_cube(2), 2),
    ("rect_l5", lambda: mi.mesh_rectangle((0, 0), (1, 1), 2, 2), 5),
]


def _setup(mesh_fn, level, form=forms.laplace_form):
    storage = CellStorage(mesh_fn(), num_shards=1)
    space = P1Space(storage, level)
    elm = compute_elmats(space, form, jnp.asarray(space.cell_vertices(0)))
    rng = np.random.default_rng(0)
    x = rng.standard_normal(space.block_shape).astype(np.float32)
    x = jnp.asarray(x * space.vertex_mask[None])
    y_ref = p1_apply_local(x, elm, level, space.dim, space.pitch)
    return space, elm, x, np.asarray(y_ref)


@pytest.mark.parametrize("name,mesh_fn,level", CASES)
def test_const_xla_matches_general(name, mesh_fn, level):
    space, elm, x, y_ref = _setup(mesh_fn, level)
    A = stencil_weights(elm, space.dim)
    E = face_weights_full(elm, space.dim)
    y = p1_const_apply_xla(x, A, level, space.dim, space.pitch, E=E)
    assert np.allclose(np.asarray(y), y_ref, rtol=1e-4, atol=1e-5)


def test_const_mass_form_matches_general():
    """The fast path is form-agnostic (any constant-per-cell element
    matrix), not Laplace-specific."""
    space, elm, x, y_ref = _setup(lambda: mi.mesh_unit_cube(1), 2,
                                  forms.mass_form)
    A = stencil_weights(elm, space.dim)
    E = face_weights_full(elm, space.dim)
    y = p1_const_apply_xla(x, A, 2, space.dim, space.pitch, E=E)
    assert np.allclose(np.asarray(y), y_ref, rtol=1e-4, atol=1e-6)


def test_operator_routes_through_const_path():
    """P1ElementwiseOperator.apply_raw (coeff=None) must agree with the
    general path bit-for-bit-ish after the exchange."""
    storage = CellStorage(mi.mesh_unit_cube(1), num_shards=1)
    space = P1Space(storage, 2)
    op = P1ElementwiseOperator(space, forms.laplace_form)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(space.block_shape).astype(np.float32)
    x = jnp.asarray(x * space.vertex_mask[None])
    try:
        P1ElementwiseOperator.use_const_stencil = False
        y_gen = np.asarray(op.apply_raw(x))
    finally:
        P1ElementwiseOperator.use_const_stencil = True
    y_const = np.asarray(op.apply_raw(x))
    assert np.allclose(y_const, y_gen, rtol=1e-4, atol=1e-5)


def test_gemv_residual_fused():
    storage = CellStorage(mi.mesh_unit_cube(1), num_shards=1)
    space = P1Space(storage, 2)
    op = P1ElementwiseOperator(space, forms.laplace_form)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal(space.block_shape).astype(np.float32)
                    * space.vertex_mask[None])
    b = jnp.asarray(rng.standard_normal(space.block_shape).astype(np.float32)
                    * space.vertex_mask[None])
    r = op.residual(x, b)
    r_ref = b - op.apply_raw(x)
    assert np.allclose(np.asarray(r), np.asarray(r_ref), rtol=1e-5, atol=1e-5)
    z = op.gemv(x, b, alpha=2.0, beta=-0.5)
    z_ref = 2.0 * op.apply_raw(x) - 0.5 * b
    assert np.allclose(np.asarray(z), np.asarray(z_ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cols", [[0, 1, 0, 2, 0], [2, 2, 2, 0, 0],
                                  [1, 1, 1, 1, 1]])
def test_ordered_scatter_add_sums_in_table_order(cols):
    """Each slot is the float32 left fold of its entries in table order;
    a slot with no entries is zero."""
    vals = np.asarray([[1e8, 1.0, -1e8, 3.0, 1.0],
                       [0.5, 1e-8, 2.0, -7.0, 1e-8]], np.float32)
    got = np.asarray(ordered_scatter_add(jnp.asarray(vals), cols, 4))
    want = np.zeros((2, 4), np.float32)
    for k, c in enumerate(cols):
        want[:, c] = want[:, c] + vals[:, k]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,mesh_fn,level", CASES[:3])
def test_weights_same_eager_and_traced(name, mesh_fn, level):
    """Stencil and face weights come out bit-identical whether built
    eagerly or inside a jitted program, and match a float64 assembly."""
    space, elm, _, _ = _setup(mesh_fn, level)
    for build in (stencil_weights, face_weights_full):
        eager = np.asarray(build(elm, space.dim))
        traced = np.asarray(jax.jit(build, static_argnums=1)(elm, space.dim))
        np.testing.assert_array_equal(eager, traced)
    dirs, tab, n_j = stencil_tables(space.dim)
    flatm = np.asarray(elm, np.float64).reshape(elm.shape[0], -1)
    ref = np.zeros((elm.shape[0], dirs.shape[0], n_j))
    np.add.at(ref, (slice(None), tab[:, 0], tab[:, 1]), flatm)
    A = np.asarray(stencil_weights(elm, space.dim))
    assert np.abs(A - ref).max() <= 1e-6 * np.abs(ref).max()
