"""N1E1 (edge-element) grid transfers: Whitney-form interpolation.

Analog of the reference's edge-element transfers
(reference: src/hyteg/gridtransferoperators/N1E1toN1E1Prolongation.cpp,
N1E1toN1E1Restriction.cpp): the canonical H(curl) prolongation takes the
coarse Whitney field u_c = sum_E c_E W_E and assigns every fine edge its
circulation. W_E . t is linear along any segment, so the midpoint rule is
EXACT:

    (P c)_e = W(x_mid(e)) . vec(e).

On the structured doubled-grid layout (functions/n1e1.py: edge DoFs at
odd nodes of the level+1 node grid) the whole map is a period-4 stencil:
a fine edge's geometry relative to its containing coarse micro-tet
depends only on its doubled-grid coordinates mod 4, so the weights form
a closed-form table {(m4 pattern, offset delta) -> weight} computed here
per micro-element class — no per-level work and no gathers. The apply is
masked shifted reads of the even-embedded coarse block (the same
expand/decimate machinery as operators/transfer.py); restriction is the
exact transpose with the standard interface prescale + additive
exchange. Per-cell canonical-orientation signs enter as parity-mask sign
fields on both sides.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..functions import n1e1 as n1
from ..functions.n1e1 import N1E1Space
from ..indexing import micro

_HI = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _locate_class(frac: tuple) -> int:
    """Micro-element class whose closed reference tet contains ``frac``
    (coords in [0, 1]^3 of the unit micro-cube); ties broken by the
    largest minimum barycentric coordinate (consistent everywhere)."""
    offs = micro.offsets(3)
    x = np.asarray(frac, dtype=np.float64)
    best, best_t = -np.inf, -1
    for t in range(offs.shape[0]):
        V = offs[t].astype(np.float64)  # (4, 3)
        J = (V[1:] - V[:1]).T
        lam123 = np.linalg.solve(J, x - V[0])
        lam = np.concatenate([[1.0 - lam123.sum()], lam123])
        m = lam.min()
        if m > best + 1e-12:
            best, best_t = m, t
    assert best > -1e-9, f"point {frac} outside all classes"
    return best_t


@functools.lru_cache(maxsize=None)
def whitney_stencil_table():
    """{(m4 pattern, delta) -> weight} for the N1E1 prolongation.

    m4: fine doubled-grid coords mod 4 of the fine edge midpoint (odd
    pattern); delta: fine-doubled offset to the coarse edge's embedded
    position (2 * coarse odd node - fine node); weight: against the
    coarse edge DoF in its +d_parity local orientation, producing the
    fine DoF in its +d_parity local orientation. Scale-free (Whitney
    values ~ 1/h_c cancel the ~h_c fine edge length)."""
    offs = micro.offsets(3)
    node_offs, par_idx, s_local = n1.edge_tables(3)
    dirs = n1.directions(3)
    pars = n1.parities(3)
    table: dict = {}
    for m4 in np.ndindex(4, 4, 4):
        p = tuple(v % 2 for v in m4)
        if p == (0, 0, 0):
            continue  # even node: not an edge midpoint
        k = next(i for i in range(len(pars)) if tuple(pars[i]) == p)
        d = dirs[k].astype(np.float64)
        frac = tuple(v / 4.0 for v in m4)  # in micro-cube units (h_c = 1)
        t = _locate_class(frac)
        V = offs[t].astype(np.float64)
        J = (V[1:] - V[:1]).T
        Jinv = np.linalg.inv(J)
        lam123 = Jinv @ (np.asarray(frac) - V[0])
        lam = np.concatenate([[1.0 - lam123.sum()], lam123])
        G = np.vstack([-Jinv.sum(axis=0), Jinv])  # (4, 3) barycentric grads
        # fine edge vector in micro-cube units: d / 2 (half a coarse edge)
        vec = d / 2.0
        entries = []
        for e, (a, b) in enumerate(n1._local_edges(3)):
            w = (lam[a] * G[b] - lam[b] * G[a]) @ vec
            w = w * s_local[t, e]
            if abs(w) < 1e-14:
                continue
            delta = tuple(int(2 * no - m) for no, m in
                          zip(node_offs[t, e], m4))
            entries.append((delta, float(w)))
        table[m4] = entries
    return table


@functools.lru_cache(maxsize=None)
def _grouped_terms():
    """[(m4 pattern, delta, weight)] flattened, grouped by delta for
    shared shifted reads."""
    by_delta: dict = {}
    for m4, entries in whitney_stencil_table().items():
        for delta, w in entries:
            by_delta.setdefault(delta, []).append((m4, w))
    return tuple(sorted(by_delta.items()))


@functools.lru_cache(maxsize=None)
def _even_onehot(n_fine: int, n_coarse: int) -> np.ndarray:
    oh = np.zeros((n_fine, n_coarse), dtype=np.float32)
    idx = np.arange(n_coarse)
    keep = 2 * idx < n_fine
    oh[2 * idx[keep], idx[keep]] = 1.0
    return oh


def _shift3(u, d):
    """Exact zero-filled shift on the trailing 3 axes of a 4D view."""
    for i, dv in enumerate(d):
        ax = u.ndim - 3 + i
        if dv == 0:
            continue
        pads = [(0, 0)] * u.ndim
        sl = [slice(None)] * u.ndim
        if dv > 0:
            sl[ax] = slice(dv, None)
            pads[ax] = (0, dv)
        else:
            sl[ax] = slice(0, dv)
            pads[ax] = (-dv, 0)
        u = jnp.pad(u[tuple(sl)], pads)
    return u


class N1E1Transfer:
    """Prolongation/restriction between N1E1 levels on one storage."""

    def __init__(self, coarse: N1E1Space, fine: N1E1Space):
        assert fine.level == coarse.level + 1
        assert fine.storage is coarse.storage
        self.coarse = coarse
        self.fine = fine

    # -- static fields --------------------------------------------------------

    @functools.cached_property
    def _mod4_masks(self):
        """{m4 pattern -> (Mf, lanes) float mask} for patterns in use."""
        fsp = self.fine
        M, P = fsp.M, fsp.node_space.pitch
        ly = np.arange(M * P) // P
        lz = np.arange(M * P) % P
        xs = np.arange(M)[:, None]
        em = fsp.edge_mask
        out = {}
        for m4 in whitney_stencil_table():
            m = ((xs % 4 == m4[0])
                 & (ly[None] % 4 == m4[1])
                 & (lz[None] % 4 == m4[2]))
            out[m4] = (m & em).astype(np.float32)
        return out

    def _sign_field(self, space: N1E1Space, shard: int = 0) -> jnp.ndarray:
        """(C, M, lanes) canonical<->local orientation signs (1 off-edge)."""
        signs = jnp.asarray(space.parity_signs(shard),
                            dtype=space.dtype)  # (C, P)
        masks = jnp.asarray(space.parity_masks, dtype=space.dtype)
        field = jnp.einsum("cp,pml->cml", signs,
                           masks.reshape(masks.shape[0], space.M, -1))
        em = jnp.asarray(space.edge_mask, dtype=space.dtype)
        return jnp.where(em[None] > 0, field, 1.0)

    @functools.cached_property
    def _sf(self):
        return self._sign_field(self.fine)

    @functools.cached_property
    def _sc(self):
        return self._sign_field(self.coarse)

    # -- embed / sample -------------------------------------------------------

    def _view(self, u, sp: N1E1Space):
        M, P = sp.M, sp.node_space.pitch
        return u.reshape(u.shape[0], M, M, P)

    def _flat(self, g):
        return g.reshape(g.shape[0], g.shape[1], -1)

    def _expand(self, gc):
        """Coarse node view -> fine-sized view, values at doubled coords."""
        fsp, csp = self.fine, self.coarse
        Mf, Pf = fsp.M, fsp.node_space.pitch
        Mc = csp.M
        st = jnp.stack([gc, jnp.zeros_like(gc)], axis=2)
        e = st.reshape(gc.shape[0], 2 * Mc, Mc, gc.shape[-1])[:, :Mf]
        Ey = jnp.asarray(_even_onehot(Mf, Mc))
        Ez = jnp.asarray(_even_onehot(Pf, gc.shape[-1]))
        e = jnp.einsum("cxvz,yv->cxyz", e, Ey, precision=_HI)
        return jnp.einsum("cxyw,zw->cxyz", e, Ez, precision=_HI)

    def _decimate(self, gf):
        fsp, csp = self.fine, self.coarse
        Mc, Pc = csp.M, csp.node_space.pitch
        s = gf[:, ::2]
        Dy = jnp.asarray(_even_onehot(gf.shape[2], Mc))
        Dz = jnp.asarray(_even_onehot(gf.shape[3], Pc))
        s = jnp.einsum("cxyz,yv->cxvz", s, Dy, precision=_HI)
        return jnp.einsum("cxvz,zw->cxvw", s, Dz, precision=_HI)

    # -- prolongation ---------------------------------------------------------

    def prolongate_local(self, uc: jnp.ndarray) -> jnp.ndarray:
        """(C, Mc, Lc) canonical coarse DoFs -> (C, Mf, Lf) fine."""
        fsp, csp = self.fine, self.coarse
        uloc = uc * self._sc  # canonical -> local (+d) orientation
        e = self._expand(self._view(uloc, csp))
        masks = self._mod4_masks
        out = None
        for delta, users in _grouped_terms():
            r = self._flat(_shift3(e, delta))
            acc = None
            for m4, w in users:
                t = w * jnp.asarray(masks[m4])[None]
                acc = t if acc is None else acc + t
            term = acc * r
            out = term if out is None else out + term
        return out * self._sf  # local -> canonical

    def prolongate(self, uc, sd_fine=None, axis_name=None):
        return self.prolongate_local(uc)

    def prolongate_and_add(self, uc, uf, sd_fine=None, axis_name=None):
        return uf + self.prolongate_local(uc)

    # -- restriction (exact transpose) ---------------------------------------

    def restrict(self, rf: jnp.ndarray, sd_fine=None, sd_coarse=None,
                 axis_name=None) -> jnp.ndarray:
        fsp, csp = self.fine, self.coarse
        nsp_f, nsp_c = fsp.node_space, csp.node_space
        sd_f = nsp_f.resolve_sd(sd_fine)
        sd_c = nsp_c.resolve_sd(sd_coarse)
        if nsp_f._dense_ok(sd_f, axis_name):
            rfs = nsp_f.dense_ifc.scale_ifc(rf)
        else:
            inv = sd_f.slot_inv_mult.astype(rf.dtype)
            sf = sd_f.slot_flat
            fl = rf.reshape(-1)
            idx = jnp.minimum(sf, fl.shape[0] - 1)
            fl = fl.at[sf].set(fl[idx] * inv, mode="drop")
            rfs = fl.reshape(rf.shape)
        rfs = rfs * self._sf  # canonical -> local weights are symmetric
        masks = self._mod4_masks
        acc_f = None
        for delta, users in _grouped_terms():
            wmask = None
            for m4, w in users:
                t = w * jnp.asarray(masks[m4])[None]
                wmask = t if wmask is None else wmask + t
            term = _shift3(self._view(wmask * rfs, fsp),
                           tuple(-v for v in delta))
            acc_f = term if acc_f is None else acc_f + term
        rc = self._flat(self._decimate(acc_f))
        rc = rc * self._sc
        rc = rc * jnp.asarray(self.coarse.edge_mask,
                              dtype=rf.dtype).reshape(1, csp.M, -1)
        return nsp_c.exchange_add(rc, sd_c, axis_name)
