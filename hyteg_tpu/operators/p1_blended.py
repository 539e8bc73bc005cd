"""P1 elementwise operators on blended (curved) geometry.

Reference: the blending operator families (p1_diffusion_blending_q3 etc.,
src/hyteg/forms/form_hyteg_generated/) and P2P1ElementwiseBlendingStokes.
Here, blending is isoparametric-P1: the geometry map snaps every
micro-vertex onto the curved domain, and element matrices are computed
per micro-element from the *blended vertex coordinate field* — an exact
matrix-free variable-geometry apply (no stencil tables), evaluated with
the same shifted-dense-op machinery as the affine path. The LSQP surrogate
path (reference: P1SurrogateOperator) approximates this for speed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import DoFType, FLAG_INNER
from ..functions.p1 import P1Space
from ..geometry.maps import GeometryMap
from ..indexing import micro
from .p1_elementwise import _class_masks, _shift_read, _shift_write


def blended_coords(space: P1Space, gmap: GeometryMap, shard: int = 0):
    """(C, N..., 3) micro-vertex coordinates on the blended geometry."""
    affine = space.coords(shard)
    ref = jnp.asarray(space._ref_coords, dtype=space.dtype)
    verts = jnp.asarray(space.cell_vertices(shard), dtype=space.dtype)
    return gmap.apply(affine, ref, verts)


def _dyn_shift_write(v, s0, ls, pitch: int):
    """out[p + off] = v[p] with traced micro-offset (s0 = off_x,
    ls = off_y * pitch + off_z, both in [0, pitch + 1]): pad-then-
    dynamic-slice reproduces flat.shift_write's zero-fill semantics."""
    pad_rows = pitch + 1
    vp = jnp.pad(v, [(0, 0), (1, 0), (pad_rows, 0)])
    start = (jnp.int32(0), 1 - s0.astype(jnp.int32),
             pad_rows - ls.astype(jnp.int32))
    return jax.lax.dynamic_slice(vp, start, v.shape)


def laplace_elmats_scalar(verts):
    """Laplace element matrices from component-wise vertex fields.

    verts: nested [b][j] of (...) arrays (nv=4 vertices x 3 components);
    returns nested [a][b] of (...) arrays — every op runs on the large
    flat layout. The generic ``forms.laplace_form`` evaluates on arrays
    with TRAILING (nv, dim) axes, whose minor dimension of 3 pads badly
    in tiled layouts; this component form is the same math on the large
    flat layout."""
    e = [[verts[k + 1][j] - verts[0][j] for j in range(3)]
         for k in range(3)]  # e[k][j]: component j of edge k (J columns)
    # cof[j][k] = cofactor of J[j][k] (J[j][k] = e[k][j])
    J = lambda j, k: e[k][j]
    cof = [[None] * 3 for _ in range(3)]
    for j in range(3):
        j1, j2 = [r for r in range(3) if r != j]
        for k in range(3):
            k1, k2 = [c for c in range(3) if c != k]
            m = J(j1, k1) * J(j2, k2) - J(j1, k2) * J(j2, k1)
            cof[j][k] = m if (j + k) % 2 == 0 else -m
    det = J(0, 0) * cof[0][0] + J(0, 1) * cof[0][1] + J(0, 2) * cof[0][2]
    inv_det = 1.0 / jnp.where(det == 0, 1.0, det)
    # grad lambda_k = row k of J^-1 = cof[:, k] / det  (k = 1..3)
    g = [[cof[j][k] * inv_det for j in range(3)] for k in range(3)]
    g0 = [-(g[0][j] + g[1][j] + g[2][j]) for j in range(3)]
    grads = [g0] + g  # [a][j]
    vol = jnp.abs(det) / 6.0
    el = [[vol * sum(grads[a][j] * grads[b][j] for j in range(3))
           for b in range(4)] for a in range(4)]
    return el


#: forms with a fast component-wise evaluation (vargeom hot path)
_SCALAR_FORMS = {}


def _register_scalar_form():
    from . import forms as _f

    _SCALAR_FORMS[_f.laplace_form] = laplace_elmats_scalar


def p1_apply_local_vargeom_scan(src, coords, level: int, dim: int, form,
                                pitch: int | None = None):
    """3D vargeom apply: ``lax.scan`` over element classes, component-wise
    fields.

    Semantically identical to the unrolled path below, but (a) the form
    (with its per-element Jacobian inverses — the bulk of the traced
    graph) is traced ONCE instead of once per element class, cutting the
    XLA compile ~5x, and (b) when the form has a registered scalar
    variant, geometry/element matrices are evaluated on component-wise
    (C, N, L) arrays instead of trailing (nv, dim) axes (40x layout
    penalty, see laplace_elmats_scalar). Reads use the 8 statically
    pre-shifted corner variants selected by ``lax.switch`` (a traced
    take would lower to a scalar-core gather); writes use a dynamic
    pad-and-slice shift."""
    assert dim == 3
    if not _SCALAR_FORMS:
        _register_scalar_form()
    N = (1 << level) + 1
    pitch = N if pitch is None else pitch
    offs = micro.offsets(dim)  # (T, nv, 3), entries in {0, 1}
    T, nv = offs.shape[0], offs.shape[1]
    masks = jnp.asarray(
        np.stack([np.asarray(m) for m in
                  _class_masks(level, dim, pitch, str(src.dtype))]))
    corner_idx = {(i, j, k): i * 4 + j * 2 + k
                  for i in (0, 1) for j in (0, 1) for k in (0, 1)}
    corners = sorted(corner_idx, key=corner_idx.get)
    scalar_el = _SCALAR_FORMS.get(form)
    co_t = jnp.moveaxis(coords, -1, 0)  # (3, C, N, L): lane-major comps
    co8 = [[_shift_read(co_t[j], c, pitch, dim) for j in range(3)]
           for c in corners]  # [corner][comp] (C, N, L)
    x8 = [_shift_read(src, c, pitch, dim) for c in corners]
    idx = [[corner_idx[tuple(int(v) for v in offs[t, b])]
            for b in range(nv)] for t in range(T)]
    woff = offs.astype(np.int32)  # (T, nv, 3)

    def mk_branch(tt):
        def br():
            verts = [[co8[i][j] for j in range(3)] for i in idx[tt]]
            reads = [x8[i] for i in idx[tt]]
            return tuple(v for vs in verts for v in vs) + tuple(reads)
        return br

    branches = [mk_branch(tt) for tt in range(T)]

    def body(dst, per_t):
        t, woff_t, mask_t = per_t
        flat_parts = jax.lax.switch(t, branches)
        verts = [[flat_parts[3 * b + j] for j in range(3)]
                 for b in range(nv)]
        reads = list(flat_parts[3 * nv:])
        if scalar_el is not None:
            el = scalar_el(verts)  # [a][b] of (C, N, L)
            get = lambda a, b: el[a][b]
        else:
            vstack = jnp.stack(
                [jnp.stack(v, axis=-1) for v in verts], axis=-2)
            el_t = form(vstack)
            get = lambda a, b: el_t[..., a, b]
        for a in range(nv):
            acc = get(a, 0) * reads[0]
            for b in range(1, nv):
                acc = acc + get(a, b) * reads[b]
            acc = jnp.where(mask_t[None] > 0, acc, 0.0)
            ls = woff_t[a, 1] * pitch + woff_t[a, 2]
            dst = dst + _dyn_shift_write(acc, woff_t[a, 0], ls, pitch)
        return dst, None

    dst, _ = jax.lax.scan(
        body, jnp.zeros_like(src),
        (jnp.arange(T, dtype=jnp.int32), jnp.asarray(woff), masks))
    return dst


def p1_apply_local_vargeom_stacked(src, coords, level: int, dim: int, form,
                                   pitch: int | None = None):
    """3D vargeom apply with all element classes batched into ONE form
    call (verts stacked over the class axis). Same math as the scan path
    with an independent evaluation order — used as its on-device
    correctness gate (bench.py) and as a fallback."""
    assert dim == 3
    N = (1 << level) + 1
    pitch = N if pitch is None else pitch
    offs = micro.offsets(dim)
    T, nv = offs.shape[0], offs.shape[1]
    masks = _class_masks(level, dim, pitch, str(src.dtype))
    verts_all = jnp.stack(
        [jnp.stack([_shift_read(coords, offs[t, b], pitch, dim, ncomp=1)
                    for b in range(nv)], axis=-2) for t in range(T)])
    el_all = form(verts_all)  # (T, C, N, L, nv, nv) — one traced form
    dst = jnp.zeros_like(src)
    for t in range(T):
        el = el_all[t]
        reads = [_shift_read(src, offs[t, b], pitch, dim)
                 for b in range(nv)]
        base_mask = jnp.asarray(masks[t]) > 0
        for a in range(nv):
            acc = el[..., a, 0] * reads[0]
            for b in range(1, nv):
                acc = acc + el[..., a, b] * reads[b]
            acc = jnp.where(base_mask, acc, 0.0)
            dst = dst + _shift_write(acc, offs[t, a], pitch, dim)
    return dst


def p1_apply_local_vargeom(src, coords, level: int, dim: int, form,
                           pitch: int | None = None):
    """Per-cell apply with per-micro-element geometry.

    coords: (C, N, lanes, 3) blended vertex field; form: (..., nv, dim) ->
    (..., nv, nv) evaluated pointwise over all base positions.
    """
    N = (1 << level) + 1
    pitch = N if (pitch is None or dim == 2) else pitch
    if dim == 3:
        return p1_apply_local_vargeom_scan(src, coords, level, dim, form,
                                           pitch)
    offs = micro.offsets(dim)
    T, nv = offs.shape[0], offs.shape[1]
    masks = _class_masks(level, dim, pitch, str(src.dtype))
    co = coords[..., :dim] if dim == 2 else coords
    dst = jnp.zeros_like(src)
    for t in range(T):
        verts = jnp.stack(
            [_shift_read(co, offs[t, b], pitch, dim, ncomp=1)
             for b in range(nv)],
            axis=-2,
        )  # (C, N, lanes, nv, dim)
        el = form(verts)  # (C, N, lanes, nv, nv)
        reads = [_shift_read(src, offs[t, b], pitch, dim) for b in range(nv)]
        base_mask = jnp.asarray(masks[t]) > 0
        for a in range(nv):
            acc = el[..., a, 0] * reads[0]
            for b in range(1, nv):
                acc = acc + el[..., a, b] * reads[b]
            # where (not *): el is NaN on padding elements (degenerate
            # zero-coordinate reads) and NaN * 0 would poison the result
            acc = jnp.where(base_mask, acc, 0.0)
            dst = dst + _shift_write(acc, offs[t, a], pitch, dim)
    return dst


def p1_diagonal_local_vargeom(coords, level: int, dim: int, form, block_shape,
                              pitch: int | None = None):
    N = (1 << level) + 1
    pitch = N if (pitch is None or dim == 2) else pitch
    offs = micro.offsets(dim)
    T, nv = offs.shape[0], offs.shape[1]
    masks = _class_masks(level, dim, pitch, "float32")
    co = coords[..., :dim] if dim == 2 else coords
    dst = jnp.zeros(block_shape, dtype=coords.dtype)
    for t in range(T):
        verts = jnp.stack(
            [_shift_read(co, offs[t, b], pitch, dim, ncomp=1)
             for b in range(nv)],
            axis=-2,
        )
        el = form(verts)
        base_mask = jnp.asarray(masks[t]) > 0
        for a in range(nv):
            v = jnp.where(base_mask, el[..., a, a], 0.0)
            dst = dst + _shift_write(v, offs[t, a], pitch, dim)
    return dst


class P1BlendedOperator:
    """Variable-geometry P1 operator (exact, matrix-free)."""

    def __init__(self, space: P1Space, form, gmap: GeometryMap, shard: int = 0):
        self.space = space
        self.form = form
        self.gmap = gmap
        self.shard = shard

    @property
    def coords(self):
        """Blended micro-vertex field, recomputed per trace: materializing
        it eagerly would bake an O(C * N * lanes * 3) constant into every
        jitted program using this operator (34 MB at shell level 3); in
        the trace it derives from the tiny cell-vertex array plus the
        small reference grid."""
        return blended_coords(self.space, self.gmap, self.shard)

    def apply_raw(self, x, sd=None, axis_name=None):
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        y = p1_apply_local_vargeom(x, self.coords, sp.level, sp.dim,
                                   self.form, sp.pitch)
        return sp.exchange_add(y, sd, axis_name)

    def apply_inner(self, x, sd_or_bc=None, flag: DoFType = FLAG_INNER,
                    axis_name=None):
        sd = self.space.resolve_sd(sd_or_bc, self.shard)
        y = self.apply_raw(x, sd, axis_name)
        return self.space.restore_rows(y, jnp.zeros_like(y), flag, sd)

    def diagonal_raw(self, sd=None, axis_name=None):
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        d = p1_diagonal_local_vargeom(self.coords, sp.level, sp.dim, self.form,
                                      sp.block_shape, sp.pitch)
        return sp.exchange_add(d, sd, axis_name)

    def inverse_diagonal(self, sd=None, axis_name=None):
        d = self.diagonal_raw(sd, axis_name)
        mask = jnp.asarray(self.space.vertex_mask[None], dtype=bool)
        return jnp.where(mask & (d != 0), 1.0 / jnp.where(d == 0, 1.0, d), 0.0)


# ---------------------------------------------------------------------------
# LSQP surrogate operator (reference: src/hyteg/polynomial/LSQPInterpolator,
# P1SurrogateOperator.hpp:36-118): approximate each of the 15 stencil-weight
# fields of the blended operator by a low-degree polynomial in the reference
# coordinates, least-squares fitted — evaluation is pure elementwise work.
# ---------------------------------------------------------------------------


def _monomials(dim: int, degree: int) -> list[tuple[int, ...]]:
    import itertools

    return [
        p
        for p in itertools.product(range(degree + 1), repeat=dim)
        if sum(p) <= degree
    ]


class P1SurrogateOperator:
    """Polynomial surrogate of a blended operator's stencil weights.

    The exact per-(class, a, b) weight fields w(x) are sampled on the base
    grid and fitted with total-degree-``degree`` polynomials per cell; apply
    evaluates the polynomials on the fly (Horner-free monomial basis) and
    runs the standard shifted accumulation. computeSurrogateError compares
    against the exact blended apply.
    """

    def __init__(self, space: P1Space, form, gmap: GeometryMap,
                 degree: int = 2, shard: int = 0):
        self.space = space
        self.degree = degree
        self.shard = shard
        dim = space.dim
        self.monos = _monomials(dim, degree)
        coords = blended_coords(space, gmap, shard)
        offs = micro.offsets(dim)
        T, nv = offs.shape[0], offs.shape[1]
        ref = np.asarray(space._ref_coords)  # (N, lanes, dim)
        self._coeffs = []  # per class: (C, n_mono, nv, nv)
        co = coords[..., :dim] if dim == 2 else coords
        for t in range(T):
            verts = jnp.stack(
                [_shift_read(co, offs[t, b], space.pitch, dim, ncomp=1)
                 for b in range(nv)],
                axis=-2,
            )
            el = np.asarray(form(verts))  # (C, N, lanes, nv, nv)
            mask = np.asarray(
                micro.elem_base_mask_flat(space.level, t, dim, space.pitch)
                if dim == 3 else micro.elem_base_mask(space.level, t, dim))
            sel = mask.reshape(-1)
            X = ref.reshape(-1, dim)[sel]  # (nb, dim)
            V = np.stack(
                [np.prod(X ** np.array(m), axis=1) for m in self.monos], axis=1
            )  # (nb, n_mono)
            Y = el.reshape(el.shape[0], -1, nv * nv)[:, sel, :]  # (C, nb, 16)
            pinv = np.linalg.pinv(V)  # (n_mono, nb) least-squares fit
            coefs = np.einsum("mk,ckf->cmf", pinv, Y)  # (C, n_mono, 16)
            self._coeffs.append(
                jnp.asarray(coefs.reshape(coefs.shape[0], len(self.monos), nv, nv),
                            dtype=space.dtype)
            )
        self._mono_fields = jnp.asarray(
            np.stack(
                [np.prod(ref ** np.array(m), axis=-1) for m in self.monos],
                axis=0,
            ),
            dtype=space.dtype,
        )  # (n_mono, N...)

    def apply_raw(self, x, sd=None, axis_name=None):
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        dim = sp.dim
        offs = micro.offsets(dim)
        T, nv = offs.shape[0], offs.shape[1]
        masks = _class_masks(sp.level, dim, sp.pitch, str(x.dtype))
        dst = jnp.zeros_like(x)
        mono = self._mono_fields  # (n_mono, N, lanes)
        mono_flat = mono.reshape(mono.shape[0], -1)
        for t in range(T):
            reads = [_shift_read(x, offs[t, b], sp.pitch, dim)
                     for b in range(nv)]
            base_mask = jnp.asarray(masks[t]) > 0
            for a in range(nv):
                acc = None
                for b in range(nv):
                    # w_ab(x) = coef[c, m] @ mono[m, :] — per (a, b) so
                    # every array keeps the large flat minor axis (an
                    # einsum producing trailing (nv, nv) axes pads its
                    # minor dim to 128 lanes: ~40x layout waste)
                    w = jnp.matmul(
                        self._coeffs[t][:, :, a, b], mono_flat,
                        precision=jax.lax.Precision.HIGHEST,
                    ).reshape((-1,) + mono.shape[1:])
                    term = w * reads[b]
                    acc = term if acc is None else acc + term
                dst = dst + _shift_write(jnp.where(base_mask, acc, 0.0),
                                         offs[t, a], sp.pitch, dim)
        return sp.exchange_add(dst, sd, axis_name)

    def compute_surrogate_error(self, exact_op: P1BlendedOperator, x) -> float:
        """Relative L2 apply error vs the exact blended operator
        (reference: P1SurrogateOperator::computeSurrogateError)."""
        ye = exact_op.apply_raw(x)
        ys = self.apply_raw(x)
        sp = self.space
        num = sp.dot(ye - ys, ye - ys)
        den = sp.dot(ye, ye)
        return jnp.sqrt(num / jnp.maximum(den, 1e-30))
