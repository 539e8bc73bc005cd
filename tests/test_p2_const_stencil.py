"""P2 parity-stencil path: the XLA formulation pinned against the
general strided P2 apply, and the operator's routing to the general apply.

Reference: src/constant_stencil_operator/P2generatedKernels/ verified
against P2ElementwiseOperator in the reference's operator tests."""

import numpy as np
import pytest

import jax.numpy as jnp

from hyteg_tpu.functions.p2 import P2Space
from hyteg_tpu.kernels.p2_const_stencil import (
    p2_const_apply_xla,
    p2_face_weights,
    p2_stencil_weights,
)
from hyteg_tpu.mesh import meshinfo as mi
from hyteg_tpu.operators.p2_elementwise import (
    P2ElementwiseOperator,
    compute_p2_elmats,
    p2_apply_local,
)
from hyteg_tpu.primitives.storage import CellStorage


CASES = [
    ("rect_l2", lambda: mi.mesh_rectangle((0, 0), (1, 1), 2, 1), 2),
    ("cube_l1", lambda: mi.mesh_unit_cube(1), 1),
    ("cube_l2", lambda: mi.mesh_unit_cube(1), 2),
    ("rect_l3", lambda: mi.mesh_rectangle((0, 0), (1, 1), 2, 2), 3),
    ("cube2_l1", lambda: mi.mesh_unit_cube(2), 1),
]


def _setup(mesh_fn, level, kind="laplace"):
    storage = CellStorage(mesh_fn(), num_shards=1)
    p2 = P2Space(storage, level)
    elm = compute_p2_elmats(p2, kind)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(p2.block_shape).astype(np.float32)
    x = jnp.asarray(x * p2.vertex_mask[None])
    y_ref = np.asarray(p2_apply_local(x, elm, level, p2.dim, p2.pitch))
    return p2, elm, x, y_ref


@pytest.mark.parametrize("name,mesh_fn,level", CASES)
def test_p2_const_xla_matches_general(name, mesh_fn, level):
    p2, elm, x, y_ref = _setup(mesh_fn, level)
    A = p2_stencil_weights(elm, p2.dim)
    E = p2_face_weights(elm, p2.dim)
    y = p2_const_apply_xla(x, A, E, level, p2.dim, p2.pitch)
    scale = np.abs(y_ref).max() + 1e-12
    assert np.abs(np.asarray(y) - y_ref).max() / scale < 1e-5


@pytest.mark.parametrize("name,mesh_fn,level", CASES[:2])
def test_p2_operator_routes_through_general_path(name, mesh_fn, level):
    """Constant coefficients take the general apply (the stencil path is
    slower on the GPU); the stencil path agrees with it."""
    p2, elm, x, y_ref = _setup(mesh_fn, level)
    op = P2ElementwiseOperator(p2, "laplace")
    y_op = np.asarray(op._apply_local(x, None))
    np.testing.assert_array_equal(y_op, y_ref)
    y_xla = np.asarray(p2_const_apply_xla(
        x, p2_stencil_weights(elm, p2.dim), p2_face_weights(elm, p2.dim),
        level, p2.dim, p2.pitch))
    scale = np.abs(y_ref).max() + 1e-12
    assert np.abs(y_xla - y_ref).max() / scale < 1e-5


def test_p2_const_mass_matches_general():
    p2, elm, x, y_ref = _setup(lambda: mi.mesh_unit_cube(1), 1, "mass")
    A = p2_stencil_weights(elm, p2.dim)
    E = p2_face_weights(elm, p2.dim)
    y = p2_const_apply_xla(x, A, E, 1, p2.dim, p2.pitch)
    scale = np.abs(y_ref).max() + 1e-12
    assert np.abs(np.asarray(y) - y_ref).max() / scale < 1e-5
