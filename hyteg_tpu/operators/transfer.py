"""Inter-level grid transfer operators (P1 linear P/R + injection).

Redesign of the reference's grid transfers
(reference: src/hyteg/gridtransferoperators/P1toP1LinearProlongation.hpp,
P1toP1LinearRestriction.hpp and the generated kernels under
gridtransferoperators/generatedKernels/).

Every odd-parity fine micro-vertex is the midpoint of exactly one coarse
micro-edge of the structured tet grid; collecting the 7 parity classes'
edge ends over the fine grid turns both directions into ONE symmetric
15-direction stencil S (center 1, the 14 tet stencil directions 1/2):

    P:        u_f = S expand(u_c)        (zero-interleave then S)
    R = P^T:  r_c = decimate(S r_f)      (sample even positions)

The stencil runs on the exact 3D view (C, N, N, pitch) — per-axis
pad/slice shifts, no lane aliasing, one fused XLA pass — and
decimation/expansion are a cheap major-axis slice plus one-hot
band-matrix einsums over the two minor axes (exact at HIGHEST
precision), which avoid strided ``[::2]`` access on the minor axes.

Restriction pre-scales fine interface replicas by 1/multiplicity so each
fine DoF contributes exactly once globally, then exchanges the coarse
result additively (reference: the additive PackInfos).
"""

from __future__ import annotations

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np

from ..functions.p1 import P1Space
from ..indexing import flat, micro

_HI = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _even_onehot(n_fine: int, n_coarse: int) -> np.ndarray:
    oh = np.zeros((n_fine, n_coarse), dtype=np.float32)
    idx = np.arange(n_coarse)
    keep = 2 * idx < n_fine
    oh[2 * idx[keep], idx[keep]] = 1.0
    return oh


def _stencil_dirs(dim: int):
    dirs = micro.stencil_directions(dim)
    return [tuple(int(v) for v in d) for d in dirs
            if any(int(v) != 0 for v in d)]


def _shift_nd(u, d):
    """out[p] = u[p + d], zero-filled, exact per-axis (trailing axes)."""
    nd = u.ndim
    k = len(d)
    for i, dv in enumerate(d):
        ax = nd - k + i
        if dv == 0:
            continue
        pads = [(0, 0)] * nd
        sl = [slice(None)] * nd
        if dv > 0:
            sl[ax] = slice(dv, None)
            pads[ax] = (0, dv)
        else:
            sl[ax] = slice(0, dv)
            pads[ax] = (-dv, 0)
        u = jnp.pad(u[tuple(sl)], pads)
    return u


def _stencil15(u, dim: int):
    """S u: center 1 + 1/2 on the tet stencil directions (exact view)."""
    acc = u
    for d in _stencil_dirs(dim):
        acc = acc + 0.5 * _shift_nd(u, d)
    return acc


class P1Transfer:
    """Prolongation/restriction between two levels on the same storage.

    The transfer core needs both levels on one lane pitch (GMG stacks
    share pitch = N_max; see solvers/templates.py). Spaces built with
    mismatched pitches still work — the coarse array is repitched at the
    boundary (a materialized relayout, fine on cold paths)."""

    def __init__(self, coarse: P1Space, fine: P1Space):
        assert fine.level == coarse.level + 1
        assert fine.storage is coarse.storage
        self.coarse = coarse
        self.fine = fine
        self.dim = coarse.dim
        self._repitch = coarse.dim == 3 and coarse.pitch != fine.pitch

    def _c_in(self, uc):
        if not self._repitch:
            return uc
        return flat.repitch(uc, self.coarse.N, self.coarse.pitch,
                            self.fine.pitch)

    def _c_out(self, rc):
        if not self._repitch:
            return rc
        return flat.repitch(rc, self.coarse.N, self.fine.pitch,
                            self.coarse.pitch)

    # -- 3D/2D views ---------------------------------------------------------

    def _view_f(self, u):
        if self.dim == 2:
            return u
        fsp = self.fine
        return u.reshape(u.shape[0], fsp.N, fsp.N, fsp.pitch)

    def _view_c(self, u):
        if self.dim == 2:
            return u
        csp, fsp = self.coarse, self.fine
        return u.reshape(u.shape[0], csp.N, csp.N, fsp.pitch)

    def _flat_f(self, g):
        if self.dim == 2:
            return g
        fsp = self.fine
        return g.reshape(g.shape[0], fsp.N, fsp.N * fsp.pitch)

    def _flat_c(self, g):
        if self.dim == 2:
            return g
        csp, fsp = self.coarse, self.fine
        return g.reshape(g.shape[0], csp.N, csp.N * fsp.pitch)

    def _expand(self, gc):
        """Coarse view -> fine-shaped view with values at even positions."""
        csp, fsp = self.coarse, self.fine
        if self.dim == 2:
            Xf = fsp.N
            st = jnp.stack([gc, jnp.zeros_like(gc)], axis=2)
            e = st.reshape(gc.shape[0], 2 * csp.N, csp.N)[:, :Xf]
            Ez = jnp.asarray(_even_onehot(fsp.N, csp.N))
            return jnp.einsum("cxw,zw->cxz", e, Ez, precision=_HI)
        st = jnp.stack([gc, jnp.zeros_like(gc)], axis=2)
        e = st.reshape(gc.shape[0], 2 * csp.N, csp.N, fsp.pitch)[:, :fsp.N]
        Ey = jnp.asarray(_even_onehot(fsp.N, csp.N))
        Ez = jnp.asarray(_even_onehot(fsp.pitch, fsp.pitch))
        e = jnp.einsum("cxvz,yv->cxyz", e, Ey, precision=_HI)
        return jnp.einsum("cxyw,zw->cxyz", e, Ez, precision=_HI)

    def _decimate(self, gf):
        """Fine view -> coarse-shaped view (even-position sampling)."""
        csp, fsp = self.coarse, self.fine
        if self.dim == 2:
            s = gf[:, ::2]
            Dz = jnp.asarray(_even_onehot(fsp.N, csp.N))
            return jnp.einsum("cxz,zw->cxw", s, Dz, precision=_HI)
        s = gf[:, ::2]
        Dy = jnp.asarray(_even_onehot(fsp.N, csp.N))
        Dz = jnp.asarray(_even_onehot(fsp.pitch, fsp.pitch))
        s = jnp.einsum("cxyz,yv->cxvz", s, Dy, precision=_HI)
        return jnp.einsum("cxvz,zw->cxvw", s, Dz, precision=_HI)

    # -- prolongation ---------------------------------------------------------

    def prolongate_local(self, uc: jnp.ndarray) -> jnp.ndarray:
        """(C, Nc, Lc) -> (C, Nf, Lf) linear interpolation, per-cell."""
        csp, fsp = self.coarse, self.fine
        uc = self._c_in(uc)
        cvm = micro.vertex_mask_flat(csp.level, 3, fsp.pitch) \
            if self.dim == 3 else micro.vertex_mask(csp.level, 2)
        ucm = uc * jnp.asarray(cvm[None], dtype=uc.dtype)
        e = self._expand(self._view_c(ucm))
        out = self._flat_f(_stencil15(e, self.dim))
        fine_mask = jnp.asarray(fsp.vertex_mask[None], dtype=uc.dtype)
        return out * fine_mask

    def prolongate(self, uc, sd_fine=None, axis_name=None):
        return self.prolongate_local(uc)

    def prolongate_and_add(self, uc, uf, sd_fine=None, axis_name=None):
        return uf + self.prolongate_local(uc)

    # -- restriction ----------------------------------------------------------

    def restrict(self, rf: jnp.ndarray, sd_fine=None, sd_coarse=None,
                 axis_name=None) -> jnp.ndarray:
        """(C, Nf, Lf) -> (C, Nc, Lc), exact transpose of prolongate.

        Fine interface replicas are pre-scaled by 1/mult so each fine DoF
        contributes once globally; the coarse result is exchanged
        additively.
        """
        csp, fsp = self.coarse, self.fine
        sd_f = fsp.resolve_sd(sd_fine)
        sd_c = csp.resolve_sd(sd_coarse)
        if fsp._dense_ok(sd_f, axis_name):
            rfs = fsp.dense_ifc.scale_ifc(rf)
        else:
            inv = sd_f.slot_inv_mult.astype(rf.dtype)
            sf = sd_f.slot_flat
            fl = rf.reshape(-1)
            idx = jnp.minimum(sf, fl.shape[0] - 1)
            fl = fl.at[sf].set(fl[idx] * inv, mode="drop")
            rfs = fl.reshape(rf.shape)
        rfs = rfs * jnp.asarray(fsp.vertex_mask[None], dtype=rf.dtype)

        s = _stencil15(self._view_f(rfs), self.dim)
        rc = self._flat_c(self._decimate(s))
        rc = self._c_out(rc)
        cvm = jnp.asarray(csp.vertex_mask[None], dtype=rf.dtype)
        rc = rc * cvm
        return csp.exchange_add(rc, sd_c, axis_name)

    def restrict_injection(self, rf: jnp.ndarray, sd_fine=None,
                           axis_name=None):
        """Injection restriction (reference: P1toP1InjectionRestriction)."""
        rc = self._flat_c(self._decimate(self._view_f(rf)))
        rc = self._c_out(rc)
        return rc * jnp.asarray(self.coarse.vertex_mask[None],
                                dtype=rf.dtype)
