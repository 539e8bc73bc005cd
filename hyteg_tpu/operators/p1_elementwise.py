"""Matrix-free P1 elementwise operators on structured micro-grids.

Redesign of the reference's hot loop
(reference: src/hyteg/elementwiseoperators/P1ElementwiseOperator.cpp:88-253
and the generated constant-stencil kernels,
src/constant_stencil_operator/P1generatedKernels/
apply_3D_macrocell_vertexdof_to_vertexdof_replace.cpp:14-60).

Formulation: for each micro-element congruence class t the local element
matrix is constant over the macro-cell (affine geometry), so

    dst[base + off_t[a]] += sum_b elMat[c, t, a, b] * src[base + off_t[b]]

over all valid base positions — a sum of *shifted dense multiply-adds* over
the flat (C, N, N*pitch) block, masked to the per-class base region.  The
apply is bandwidth-bound either way, so the flop overhead vs. an ideal
15-point stencil is cheap while staying exact for arbitrary per-cell
geometry — the same code path serves constant, variable-coefficient and
(via per-element rescaling) blended operators.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import BoundaryCondition, DoFType, FLAG_INNER, UpdateType
from ..functions.p1 import P1Function, P1ShardData, P1Space
from ..indexing import flat, micro
from .averaging import coeff_average


def _shift_read(u, off, pitch: int, dim: int, ncomp: int = 0):
    """out[p] = u[p + off] on flat blocks (zero beyond the block; lane
    aliasing killed by the base-region masks)."""
    return flat.shift_read(u, off, pitch, dim, ncomp)


def _shift_write(v, off, pitch: int, dim: int, ncomp: int = 0):
    """out[p + off] = v[p] (dropped beyond the block)."""
    return flat.shift_write(v, off, pitch, dim, ncomp)


@functools.lru_cache(maxsize=None)
def _class_masks(level: int, dim: int, pitch: int, dtype_name: str) -> tuple:
    return tuple(
        np.asarray(micro.elem_base_mask_flat(level, t, dim, pitch),
                   dtype=dtype_name)
        for t in range(micro.num_classes(dim))
    )


def compute_elmats(space: P1Space, form, cell_vertices) -> jnp.ndarray:
    """(C, T, nv, nv) element matrices — one micro-element per congruence
    class (base-independent for affine cells). Traceable."""
    dim = space.dim
    verts = cell_vertices[..., :dim] if dim == 2 else cell_vertices
    v0 = verts[:, :1, :]
    J = verts[:, 1:, :] - v0  # (C, dim, dim) rows are edge vectors
    offs = jnp.asarray(micro.offsets(dim), dtype=verts.dtype) / space.n
    micro_verts = v0[:, None] + jnp.einsum("tvd,cde->ctve", offs, J)
    return jnp.asarray(form(micro_verts), dtype=space.dtype)


def p1_apply_local(
    src: jnp.ndarray,
    elmats: jnp.ndarray,
    level: int,
    dim: int,
    pitch: int | None = None,
    coeff: jnp.ndarray | None = None,
    coeff_avg: str = "arithmetic",
    unroll: bool = False,
) -> jnp.ndarray:
    """Per-cell operator apply (partial sums on interface rows).

    src:    (C, N, N*pitch) [3D] / (C, N, N) [2D]
    elmats: (C, T, nv, nv)
    coeff:  optional nodal field (same shape as src); each element is scaled
            by the mean of its nv vertex values (variable-coefficient path).

    Default: a ``lax.scan`` over the T element classes with dynamic cyclic
    rolls — the XLA graph is one class body instead of T unrolled copies
    (the unrolled form made every CPU GMG compile minutes-long).  Cyclic
    wrap is exact here: every term is multiplied by its base-region mask
    BEFORE the write roll, so wrapped entries are zeros, and reads of
    valid bases never leave the block.  ``unroll=True`` keeps the
    statically-shifted zero-fill form (independent reference for gates).
    """
    N = (1 << level) + 1
    pitch = N if (pitch is None or dim == 2) else pitch
    offs = micro.offsets(dim)  # (T, nv, dim)
    T, nv = offs.shape[0], offs.shape[1]
    masks = _class_masks(level, dim, pitch, str(src.dtype))
    if unroll:
        dst = jnp.zeros_like(src)
        for t in range(T):
            reads = [_shift_read(src, offs[t, b], pitch, dim)
                     for b in range(nv)]
            if coeff is not None:
                creads = [_shift_read(coeff, offs[t, b], pitch, dim)
                          for b in range(nv)]
                scale = coeff_average(creads, coeff_avg)
            base_mask = jnp.asarray(masks[t])
            for a in range(nv):
                acc = elmats[:, t, a, 0].reshape(-1, 1, 1) * reads[0]
                for b in range(1, nv):
                    acc = acc + elmats[:, t, a, b].reshape(-1, 1, 1) * reads[b]
                if coeff is not None:
                    acc = acc * scale
                dst = dst + _shift_write(acc * base_mask, offs[t, a],
                                         pitch, dim)
        return dst

    if dim == 3:
        lshift = offs[:, :, 1] * pitch + offs[:, :, 2]  # (T, nv)
    else:
        lshift = offs[:, :, 1]
    xshift = offs[:, :, 0]
    joffs = jnp.asarray(np.stack([xshift, lshift], axis=-1))  # (T, nv, 2)
    jmask = jnp.asarray(np.stack(masks))                      # (T, N, L)

    def roll2(u, dx, ls):
        return jnp.roll(jnp.roll(u, -dx, axis=-2), -ls, axis=-1)

    def body(dst, t):
        off = joffs[t]                       # (nv, 2) traced ints
        mask = jmask[t]
        em = jnp.take(elmats, t, axis=1)     # (C, nv, nv)
        reads = [roll2(src, off[b, 0], off[b, 1]) for b in range(nv)]
        if coeff is not None:
            creads = [roll2(coeff, off[b, 0], off[b, 1]) for b in range(nv)]
            scale = coeff_average(creads, coeff_avg)
        for a in range(nv):
            acc = em[:, a, 0].reshape(-1, 1, 1) * reads[0]
            for b in range(1, nv):
                acc = acc + em[:, a, b].reshape(-1, 1, 1) * reads[b]
            if coeff is not None:
                acc = acc * scale
            dst = dst + roll2(acc * mask, -off[a, 0], -off[a, 1])
        return dst, None

    dst, _ = jax.lax.scan(body, jnp.zeros_like(src), jnp.arange(T))
    return dst


def _p1_diag_local(elmats, level, dim, block_shape, pitch, coeff, entry_fn,
                   coeff_avg: str = "arithmetic"):
    N = (1 << level) + 1
    pitch = N if (pitch is None or dim == 2) else pitch
    offs = micro.offsets(dim)
    T, nv = offs.shape[0], offs.shape[1]
    masks = _class_masks(level, dim, pitch,
                         str(jnp.zeros(0, elmats.dtype).dtype))
    dst = jnp.zeros(block_shape, dtype=elmats.dtype)
    for t in range(T):
        base_mask = jnp.asarray(masks[t])
        if coeff is not None:
            creads = [_shift_read(coeff, offs[t, b], pitch, dim)
                      for b in range(nv)]
            scale = coeff_average(creads, coeff_avg)
        for a in range(nv):
            acc = jnp.broadcast_to(
                entry_fn(elmats, t, a).reshape(-1, 1, 1), block_shape
            ) * base_mask
            if coeff is not None:
                acc = acc * scale
            dst = dst + _shift_write(acc, offs[t, a], pitch, dim)
    return dst


def p1_diagonal_local(elmats, level, dim, block_shape, pitch=None, coeff=None,
                      coeff_avg: str = "arithmetic"):
    """Per-cell partial diagonal: dst[base + off_a] += elMat[t, a, a]."""
    return _p1_diag_local(
        elmats, level, dim, block_shape, pitch, coeff,
        lambda e, t, a: e[:, t, a, a], coeff_avg
    )


def p1_lumped_local(elmats, level, dim, block_shape, pitch=None, coeff=None):
    """Row-sum (lumped) partial diagonal: dst[off_a] += sum_b elMat[a, b]."""
    return _p1_diag_local(
        elmats, level, dim, block_shape, pitch, coeff,
        lambda e, t, a: e[:, t, a, :].sum(-1)
    )


class P1ElementwiseOperator:
    """A: src -> dst with constant-per-cell element matrices.

    ``form``: callable (..., nv, dim) physical vertex coords -> (..., nv, nv).
    Variable-coefficient operators pass the nodal field via ``coeff=``.

    When ``coeff`` is None the apply routes through the shell-resolved
    constant-stencil fast path (kernels/p1_const_stencil.py — the analog of
    the reference's generated 15-point kernels,
    src/constant_stencil_operator/P1ConstantOperator.cpp:239-667): 15
    shifted reads instead of 96 masked accumulation passes.
    """

    #: module-wide switch for the constant-stencil fast path
    use_const_stencil: bool = True

    def __init__(self, space: P1Space, form, shard: int = 0, elmats=None,
                 coeff_avg: str = "arithmetic"):
        self.space = space
        self.form = form
        self.shard = shard
        #: averaging of nodal coefficient fields over element vertices
        #: (reference: src/hyteg/forms/CoefficientAveraging.hpp)
        self.coeff_avg = coeff_avg
        if elmats is None:
            elmats = compute_elmats(
                space, form, jnp.asarray(space.cell_vertices(shard))
            )
        self.elmats = elmats
        from ..kernels.p1_const_stencil import (face_weights_full,
                                                stencil_weights)

        self.stencil = stencil_weights(elmats, space.dim)
        self.stencil_face = face_weights_full(elmats, space.dim)

    @classmethod
    def from_shard_data(cls, space: P1Space, form, sd: P1ShardData):
        """Build with traced element matrices (shard_map path)."""
        return cls(space, form, elmats=compute_elmats(space, form, sd.cell_vertices))

    # -- raw array API (used by solvers inside jit) --------------------------

    def _apply_local(self, x, coeff, cells=None):
        """Per-cell partial apply (no exchange).  ``cells`` restricts to
        a (traced) subset of local cells: ``x`` must already be gathered
        to those rows; the per-cell tables are gathered here."""
        sp = self.space
        if cells is not None:
            sub = object.__new__(P1ElementwiseOperator)
            sub.__dict__.update(self.__dict__)
            sub.stencil = jnp.take(self.stencil, cells, axis=0)
            sub.stencil_face = jnp.take(self.stencil_face, cells, axis=0)
            sub.elmats = jnp.take(self.elmats, cells, axis=0)
            return sub._apply_local(x, coeff)
        if coeff is None and P1ElementwiseOperator.use_const_stencil:
            from ..kernels.p1_const_stencil import p1_const_apply_xla

            return p1_const_apply_xla(x, self.stencil, sp.level, sp.dim,
                                      sp.pitch, E=self.stencil_face)
        return p1_apply_local(x, self.elmats, sp.level, sp.dim, sp.pitch,
                              coeff, self.coeff_avg)

    def apply_raw(self, x, coeff=None, sd=None, axis_name=None) -> jnp.ndarray:
        """Full A x on every row (interface rows exchanged additively).

        On the SPMD path with overlap tables the apply is split: the
        interface-incident cells are computed first and their exchange
        started, the interior cells are computed while the ppermutes are
        in flight, then the received partials are folded in (reference:
        BufferedCommunication start/endCommunication)."""
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        if (axis_name is not None and sd.nbr_pack is not None
                and sd.ovl_cells is not None and 0 < sd.ovl_k):
            return self._apply_overlapped(x, coeff, sd, axis_name)
        y = self._apply_local(x, coeff)
        return sp.exchange_add(y, sd, axis_name)

    def _apply_overlapped(self, x, coeff, sd, axis_name) -> jnp.ndarray:
        sp = self.space
        K = sd.ovl_k
        perm = sd.ovl_cells

        def gather(a, idx):
            return None if a is None else jnp.take(a, idx, axis=0)

        xi = jnp.take(x, perm[:K], axis=0)
        y_ifc = self._apply_local(xi, gather(coeff, perm[:K]),
                                  cells=perm[:K])
        acc_recv = sp._exchange_nbr_start(y_ifc, sd, axis_name)
        y = jnp.zeros_like(x).at[perm[:K]].set(y_ifc)
        if K < x.shape[0]:
            xj = jnp.take(x, perm[K:], axis=0)
            y_int = self._apply_local(xj, gather(coeff, perm[K:]),
                                      cells=perm[K:])
            y = y.at[perm[K:]].set(y_int)
        return sp._exchange_nbr_finish(y, acc_recv, sd)

    def gemv(self, x, y, alpha=1.0, beta=1.0, coeff=None, sd=None,
             axis_name=None) -> jnp.ndarray:
        """alpha * A x + beta * y in one fused pass
        (reference: P1ElementwiseOperator gemv, P1ElementwiseOperator.cpp:67).

        The axpy epilogue fuses with the exchange scatter under jit, saving
        a separate full-array pass per smoother step / residual."""
        z = self.apply_raw(x, coeff, sd, axis_name)
        return alpha * z + beta * y

    def residual(self, x, b, coeff=None, sd=None, axis_name=None):
        """b - A x (fused)."""
        return self.gemv(x, b, alpha=-1.0, beta=1.0, coeff=coeff, sd=sd,
                         axis_name=axis_name)

    def apply_inner(self, x, sd_or_bc=None, flag: DoFType = FLAG_INNER,
                    coeff=None, axis_name=None) -> jnp.ndarray:
        """A x with rows outside ``flag`` zeroed (Dirichlet rows untouched)."""
        sd = self.space.resolve_sd(sd_or_bc, self.shard)
        y = self.apply_raw(x, coeff, sd, axis_name)
        return self.space.restore_rows(y, jnp.zeros_like(y), flag, sd)

    def diagonal_raw(self, coeff=None, sd=None, axis_name=None) -> jnp.ndarray:
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        d = p1_diagonal_local(self.elmats, sp.level, sp.dim, sp.block_shape,
                              sp.pitch, coeff, self.coeff_avg)
        return sp.exchange_add(d, sd, axis_name)

    def inverse_diagonal(self, coeff=None, sd=None, axis_name=None) -> jnp.ndarray:
        """1/diag on valid rows, 0 elsewhere
        (reference: computeInverseDiagonalOperatorValues)."""
        d = self.diagonal_raw(coeff, sd, axis_name)
        mask = jnp.asarray(self.space.vertex_mask[None], dtype=bool)
        return jnp.where(mask & (d != 0), 1.0 / jnp.where(d == 0, 1.0, d), 0.0)

    def lumped_inverse_diagonal(self, coeff=None, sd=None, axis_name=None):
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        d = p1_lumped_local(self.elmats, sp.level, sp.dim, sp.block_shape,
                            sp.pitch, coeff)
        d = sp.exchange_add(d, sd, axis_name)
        mask = jnp.asarray(sp.vertex_mask[None], dtype=bool)
        return jnp.where(mask & (d != 0), 1.0 / jnp.where(d == 0, 1.0, d), 0.0)

    # -- HyTeG-style function API -------------------------------------------

    def apply(
        self,
        src: P1Function,
        dst: P1Function,
        flag: DoFType = FLAG_INNER,
        update: UpdateType = UpdateType.REPLACE,
    ) -> P1Function:
        sd = self.space.shard_data(self.shard, dst.bc)
        y = self.apply_raw(src.cells, sd=sd)
        if update == UpdateType.ADD:
            y = y + dst.cells
        out = self.space.restore_rows(y, dst.cells, flag, sd)
        return P1Function(out, dst.space, dst.bc)
