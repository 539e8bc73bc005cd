"""Dense structured interface exchange (the compiled-PackInfo fast path).

The generic slot-map exchange (functions/p1.py) is exact but relies on
element-level gather/scatter. This module re-expresses the same exchange as
*dense plane/line operations*:

  * every interface DoF of a cell block lies on one of its faces (3D),
    edges, or vertices;
  * coordinate faces/edges are dense slices; the diagonal face x+y+z=n and
    diagonal edges are extracted/written with one-hot einsum contractions
    (dense arithmetic, no gathers);
  * faces are mapped to the canonical frame of their macro-face (sorted
    global vertex ids) by one of the 6 triangle symmetries — compositions
    of transpose and the shear (p,q) -> (p, n-p-q), found automatically at
    setup; edges by an optional flip;
  * accumulation across cells is row-wise (take/segment_sum over *rows*
    with large dense trailing dims — vectorized, unlike element gathers).

Write-back order faces -> edges -> vertices makes lower-dimensional sums
overwrite the garbage borders of higher-dimensional writes, reproducing the
reference's dimension-ordered halo protocol
(reference: src/hyteg/communication/BufferedCommunication.hpp:119 and the
additive PackInfos) by construction.

Single-shard path; the multi-device SPMD path keeps the slot/psum exchange.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import BoundaryCondition, DoFType
from ..indexing import micro

_LOCAL_FACES = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
_LOCAL_EDGES_3D = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_LOCAL_EDGES_2D = [(1, 2), (0, 1), (0, 2)]  # edge k opposite vertex k... see below
_VERT_POS_3D = lambda n: [(0, 0, 0), (n, 0, 0), (0, n, 0), (0, 0, n)]
_VERT_POS_2D = lambda n: [(0, 0), (n, 0), (0, n)]


# ---------------------------------------------------------------------------
# triangle symmetries: canonical transform search
# ---------------------------------------------------------------------------


def _apply_perm_coords(perm, p, q, n):
    """Coordinates (p', q') such that canon[p', q'] = face[p, q] when the
    face's ordered vertex triple is permuted by ``perm`` to the canonical
    (sorted) order: weights (n-p-q, p, q) -> take entries perm[1], perm[2]."""
    w = (n - p - q, p, q)
    return w[perm[1]], w[perm[2]]


def _op_T(a):  # transpose
    return jnp.swapaxes(a, -1, -2)


def _shear_matrix(N: int) -> np.ndarray:
    """W[p, k, q] = 1 iff k = n - p - q  (n = N - 1)."""
    n = N - 1
    W = np.zeros((N, N, N), dtype=np.float32)
    for p in range(N):
        for q in range(N - p):
            W[p, n - p - q, q] = 1.0
    return W


def _op_S(a, W):  # shear: out[p, q] = in[p, n-p-q]
    return jnp.einsum("...pk,pkq->...pq", a, jnp.asarray(W))


@functools.lru_cache(maxsize=None)
def _transform_sequences(N: int):
    """For each vertex permutation (as tuple), a sequence of ops ('T'/'S')
    realizing canon = seq(face), plus the inverse sequence. Found by search
    over compositions (length <= 4)."""
    n = N - 1
    # sample coordinates: enough triangle points to uniquely identify each
    # of the 6 symmetries (use the whole triangle for small N)
    samples = [(p, q) for p in range(N) for q in range(N - p)][:64]

    def sig(fn):
        return tuple(fn(p, q) for (p, q) in samples)

    # primitive coordinate maps (coords of *source* given dest): for dense
    # ops we track: out[p,q] = in[ m(p,q) ]
    def m_T(p, q):
        return (q, p)

    def m_S(p, q):
        return (p, n - p - q)

    def compose(seq):
        def f(p, q):
            for op in reversed(seq):  # out = op1(op2(...(in)))
                p, q = (m_T(p, q) if op == "T" else m_S(p, q))
            return (p, q)
        return f

    # enumerate all sequences up to length 4
    seq_by_sig = {}
    for L in range(0, 5):
        for seq in itertools.product("TS", repeat=L):
            s = sig(compose(list(seq)))
            seq_by_sig.setdefault(s, list(seq))

    out = {}
    for perm in itertools.permutations(range(3)):
        # canon[p', q'] = face[p, q] with (p', q') = _apply_perm_coords.
        # Equivalently canon[a, b] = face[src(a, b)] where src inverts it.
        # Build the forward map face->canon as: canon[a,b] = face[m(a,b)].
        inv = {perm[i]: i for i in range(3)}  # position of weight i
        def m_canon(a, b, inv=inv):
            wc = (n - a - b, a, b)  # canonical weights (w_a', w_b', w_c')
            # face weights: w_face[j] = wc[inv[j]] for j in 0..2
            wf = tuple(wc[inv[j]] for j in range(3))
            return wf[1], wf[2]
        key = sig(m_canon)
        assert key in seq_by_sig, f"no op sequence for perm {perm}"
        # inverse: face[p,q] = canon[m'(p,q)]
        def m_face(p, q, perm=perm):
            return _apply_perm_coords(perm, p, q, n)
        ikey = sig(m_face)
        assert ikey in seq_by_sig
        out[perm] = (tuple(seq_by_sig[key]), tuple(seq_by_sig[ikey]))
    return out


def _apply_seq(a, seq, W):
    for op in seq:
        a = _op_T(a) if op == "T" else _op_S(a, W)
    return a


# ---------------------------------------------------------------------------
# static masks
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tri_masks(N: int):
    """(valid, interior) masks of the parametrized face triangle (p+q <= n)."""
    n = N - 1
    p, q = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    valid = p + q <= n
    interior = (p > 0) & (q > 0) & (p + q < n)
    return valid, interior


@functools.lru_cache(maxsize=None)
def _line_interior_mask(N: int):
    m = np.zeros(N, dtype=bool)
    m[1 : N - 1] = True
    return m


# ---------------------------------------------------------------------------
# the exchange object
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DenseIfc:
    """Per-(storage, level) compiled dense exchange (single shard).

    Operates on the canonical flat block layout (C, N, N*pitch) in 3D
    (lane = y*pitch + z; see indexing/flat.py) and (C, N, N) in 2D.
    Faces/edges are extracted into their 2D/1D parametrizations by lane
    slicing and one-hot contractions (dense arithmetic, no gathers)."""

    N: int
    dim: int
    C: int
    pitch: int
    # 3D faces (C*4 rows)
    face_perm_id: np.ndarray | None    # (C*4,) int in [0, 6)
    face_macro: np.ndarray | None      # (C*4,) macro-face row id
    face_members: np.ndarray | None    # (F, 2) row ids into C*4, -1 if none
    face_flag: np.ndarray | None       # (F,) mesh flag
    # edges (C*E_loc rows)
    edge_flip: np.ndarray              # (C*E_loc,) bool
    edge_macro: np.ndarray             # (C*E_loc,) macro-edge id
    num_macro_edges: int
    edge_flag: np.ndarray              # (E,) mesh flag
    edge_rep_row: np.ndarray           # (E,) row id of representative
    # vertices (C*(dim+1) rows)
    vert_macro: np.ndarray             # (C*(dim+1),)
    num_macro_verts: int
    vert_flag: np.ndarray
    vert_rep_row: np.ndarray
    shear_W: np.ndarray                # (N, N, N) one-hot shear/diag matrix
    perms: tuple                       # ordered list of the 6 permutations

    # ------------------------------------------------------------------
    # static one-hot helpers (flat 3D layout)
    # ------------------------------------------------------------------

    @functools.cached_property
    def _yz(self):
        """(y_of_lane, z_of_lane) for the flat lane axis."""
        N, P = self.N, self.pitch
        l = np.arange(N * P)
        return l // P, l % P

    @functools.cached_property
    def _OH_diag(self) -> np.ndarray:
        """(N, L) one-hot: x == n - y - z on valid lanes (diagonal face)."""
        n = self.N - 1
        y, z = self._yz
        x = np.arange(self.N)
        return ((x[:, None] == n - y - z) & (z < self.N)).astype(np.float32)

    @functools.cached_property
    def _OH_e23(self) -> np.ndarray:
        """(L, N) one-hot: lane == (n - t)*pitch + t (the x=0 diagonal edge)."""
        n = self.N - 1
        y, z = self._yz
        t = np.arange(self.N)
        return ((y[:, None] == n - t) & (z[:, None] == t)).astype(np.float32)

    @functools.cached_property
    def _OH_z0(self) -> np.ndarray:
        """(L, N) one-hot: lane == y * pitch (the z = 0 plane), col y."""
        y, z = self._yz
        col = np.arange(self.N)
        return ((z[:, None] == 0) & (y[:, None] == col)).astype(np.float32)

    @functools.cached_property
    def _M_bnd(self) -> np.ndarray:
        """(N, L) float: 1 on every tet-boundary node (valid lanes only)."""
        n = self.N - 1
        y, z = self._yz
        x = np.arange(self.N)[:, None]
        s = x + y[None] + z[None]
        valid = (z[None] < self.N) & (s <= n)
        bnd = (x == 0) | (y[None] == 0) | (z[None] == 0) | (s == n)
        return (valid & bnd).astype(np.float32)

    def _lane_grid(self, a):
        """(..., L) -> (..., N, N): split lanes to (y, z<N)."""
        g = a.reshape(a.shape[:-1] + (self.N, self.pitch))
        return g[..., : self.N]

    def _grid_lane(self, f):
        """(..., N, N) -> (..., L): zero-pad z to pitch and flatten."""
        pad = [(0, 0)] * (f.ndim - 1) + [(0, self.pitch - self.N)]
        g = jnp.pad(f, pad)
        return g.reshape(f.shape[:-2] + (self.N * self.pitch,))

    # ------------------------------------------------------------------
    # extraction (lane slices + one-hot contractions; no strided-lane ops)
    # ------------------------------------------------------------------

    def extract_faces(self, u) -> jnp.ndarray:
        """(C, 4, N, N) face arrays, convention face[p, q] <-> weights
        (n-p-q, p, q) over the ordered local vertex triple."""
        P = self.pitch
        f0 = self._lane_grid(
            jnp.einsum("cxl,xl->cl", u, jnp.asarray(self._OH_diag))
        )  # diagonal x+y+z=n, params (y, z)
        f1 = self._lane_grid(u[:, 0, :])          # x=0, params (y, z)
        f2 = u[:, :, :P][..., : self.N]           # y=0, params (x, z)
        f3 = jnp.einsum("cxl,ly->cxy", u, jnp.asarray(self._OH_z0))  # z=0
        return jnp.stack([f0, f1, f2, f3], axis=1)

    def extract_edges(self, u, faces=None) -> jnp.ndarray:
        """(C, E_loc, N) edge lines, parametrized by the weight of the
        *second* local vertex of the edge."""
        W = jnp.asarray(self.shear_W)
        OH = W[:, :, 0]  # OH[x, t] = 1 iff x = n - t
        if self.dim == 3:
            if faces is None:
                faces = self.extract_faces(u)
            f2, f3 = faces[:, 2], faces[:, 3]
            row0 = u[:, 0, :]
            e01 = u[:, :, 0]
            e02 = f3[:, 0, :]
            e03 = row0[:, : self.N]
            # diagonal lines: line[t] = plane[n-t, t]
            e12 = jnp.einsum("cxt,xt->ct", f3, OH)
            e13 = jnp.einsum("cxt,xt->ct", f2, OH)
            e23 = jnp.einsum("cl,lt->ct", row0, jnp.asarray(self._OH_e23))
            return jnp.stack([e01, e02, e03, e12, e13, e23], axis=1)
        # 2D: cell "edges" are the 3 triangle sides; order (1,2),(0,1),(0,2)
        e12 = jnp.einsum("cxt,xt->ct", u, OH)  # diagonal x+y=n
        e01 = u[:, :, 0]
        e02 = u[:, 0, :]
        return jnp.stack([e12, e01, e02], axis=1)

    def _vert_pos_flat(self):
        n = self.N - 1
        if self.dim == 3:
            P = self.pitch
            return [(0, 0), (n, 0), (0, n * P), (0, n)]
        return _VERT_POS_2D(n)

    def extract_verts(self, u) -> jnp.ndarray:
        pos = self._vert_pos_flat()
        return jnp.stack([u[(slice(None),) + p] for p in pos], axis=1)

    # ------------------------------------------------------------------
    # write-back: ONE fused read-modify-write pass over the block. The
    # tet boundary decomposes into four disjoint deliveries (x=0 plane;
    # y=0 minus x=0; z=0 minus x=0, y=0; diag interior), each assembled
    # in its small extracted parametrization with the dimension-ordered
    # overwrite (faces -> edges -> verts) applied there, then expanded by
    # pads / one-hot contractions — no dynamic-update-slice, no strided
    # lane ops (reference ordering: BufferedCommunication.hpp:119).
    # ------------------------------------------------------------------

    def write_all(self, u, faces, edges, verts) -> jnp.ndarray:
        N, P = self.N, self.pitch
        n = N - 1
        valid, _ = _tri_masks(N)
        if self.dim == 2:
            W = jnp.asarray(self.shear_W)
            OH = W[:, :, 0]
            e12, e01, e02 = edges[:, 0], edges[:, 1], edges[:, 2]
            u = u * (1 - OH[None]) + OH[None] * e12[:, None, :]
            u = u.at[:, :, 0].set(e01)
            u = u.at[:, 0, :].set(e02)
            return self.write_verts(u, verts)

        W = jnp.asarray(self.shear_W)
        OH = W[:, :, 0]  # (p, t): 1 iff p = n - t
        vm = jnp.asarray(valid, dtype=u.dtype)
        f0, f1, f2, f3 = faces[:, 0], faces[:, 1], faces[:, 2], faces[:, 3]
        e01, e02, e03, e12, e13, e23 = [edges[:, k] for k in range(6)]
        v0, v1, v2, v3 = [verts[:, k] for k in range(4)]

        # x = 0 plane, params (y, z): face f1, edges e02/e03/e23, verts 0/2/3
        p0 = f1
        p0 = p0.at[:, 0, :].set(e03)
        p0 = p0.at[:, :, 0].set(e02)
        p0 = p0 * (1 - OH[None]) + OH[None] * e23[:, None, :]
        p0 = p0.at[:, 0, 0].set(v0)
        p0 = p0.at[:, n, 0].set(v2)
        p0 = p0.at[:, 0, n].set(v3)
        p0 = p0 * vm

        # y = 0 plane minus the x = 0 row, params (x, z)
        p2 = f2
        p2 = p2.at[:, :, 0].set(e01)
        p2 = p2 * (1 - OH[None]) + OH[None] * e13[:, None, :]
        p2 = p2.at[:, n, 0].set(v1)
        p2 = p2.at[:, 0, :].set(0.0)
        p2 = p2 * vm

        # z = 0 plane minus x = 0 / y = 0 borders, params (x, y)
        p3 = f3 * (1 - OH[None]) + OH[None] * e12[:, None, :]
        p3 = p3.at[:, 0, :].set(0.0)
        p3 = p3.at[:, :, 0].set(0.0)
        p3 = p3 * vm

        # diagonal face interior only, params (y, z)
        _, tri_int = _tri_masks(N)
        d0 = f0 * jnp.asarray(tri_int, dtype=u.dtype)

        X0 = jnp.pad(self._grid_lane(p0)[:, None, :], [(0, 0), (0, N - 1), (0, 0)])
        X2 = jnp.pad(p2, [(0, 0), (0, 0), (0, (N * P) - N)])
        X3 = jnp.einsum("cxy,ly->cxl", p3, jnp.asarray(self._OH_z0))
        XD = jnp.asarray(self._OH_diag)[None] * self._grid_lane(d0)[:, None, :]
        Mb = jnp.asarray(self._M_bnd, dtype=u.dtype)[None]
        return u * (1 - Mb) + X0 + X2 + X3 + XD

    # legacy sequential write API (kept for tests / partial updates)

    def write_faces(self, u, faces) -> jnp.ndarray:
        return self.write_all(u, faces, self.extract_edges(u),
                              self.extract_verts(u))

    def write_edges(self, u, edges) -> jnp.ndarray:
        return self.write_all(u, self.extract_faces(u), edges,
                              self.extract_verts(u))

    def write_verts(self, u, verts) -> jnp.ndarray:
        pos = self._vert_pos_flat()
        for k, p in enumerate(pos):
            u = u.at[(slice(None),) + p].set(verts[:, k])
        return u

    # ------------------------------------------------------------------
    # canonicalization
    # ------------------------------------------------------------------

    @functools.cached_property
    def _canon_trivial(self) -> bool:
        """True when every face is already in its canonical frame — always
        the case for sorted-vertex storages (primitives/topology.py)."""
        ident = self.perms.index((0, 1, 2))
        return bool(np.all(self.face_perm_id == ident))

    def _canon_faces(self, faces) -> jnp.ndarray:
        """(C*4, N, N) rows mapped into their macro-face canonical frame."""
        rows = faces.reshape(-1, self.N, self.N)
        if self._canon_trivial:
            return rows
        variants = []
        W = self.shear_W
        for perm in self.perms:
            seq, _ = _transform_sequences(self.N)[perm]
            variants.append(_apply_seq(rows, seq, W))
        stack = jnp.stack(variants, axis=0)  # (6, R, N, N)
        pid = jnp.asarray(self.face_perm_id)
        return jnp.take_along_axis(
            stack, pid[None, :, None, None], axis=0
        )[0]

    def _decanon_faces(self, canon_rows) -> jnp.ndarray:
        if self._canon_trivial:
            return canon_rows.reshape(self.C, 4, self.N, self.N)
        variants = []
        W = self.shear_W
        for perm in self.perms:
            _, iseq = _transform_sequences(self.N)[perm]
            variants.append(_apply_seq(canon_rows, iseq, W))
        stack = jnp.stack(variants, axis=0)
        pid = jnp.asarray(self.face_perm_id)
        rows = jnp.take_along_axis(stack, pid[None, :, None, None], axis=0)[0]
        return rows.reshape(self.C, 4, self.N, self.N)

    def _canon_edges(self, edges) -> jnp.ndarray:
        rows = edges.reshape(-1, self.N)
        if not bool(self.edge_flip.any()):
            return rows
        flip = jnp.asarray(self.edge_flip)[:, None]
        return jnp.where(flip, rows[:, ::-1], rows)

    def _decanon_edges(self, canon_rows) -> jnp.ndarray:
        if not bool(self.edge_flip.any()):
            return canon_rows.reshape(self.C, -1, self.N)
        flip = jnp.asarray(self.edge_flip)[:, None]
        rows = jnp.where(flip, canon_rows[:, ::-1], canon_rows)
        return rows.reshape(self.C, -1, self.N)

    # ------------------------------------------------------------------
    # exchanges
    # ------------------------------------------------------------------

    def _accumulate(self, u, combine: str) -> jnp.ndarray:
        """combine = 'add' (sum replicas) or 'rep' (representative value)."""
        dim = self.dim
        faces_new = None
        if dim == 3:
            faces = self.extract_faces(u)
            canon = self._canon_faces(faces)  # (C*4, N, N)
            mA = jnp.asarray(np.maximum(self.face_members[:, 0], 0))
            mB = jnp.asarray(np.maximum(self.face_members[:, 1], 0))
            hasB = jnp.asarray(
                (self.face_members[:, 1] >= 0).astype(np.float32)
            )[:, None, None]
            fA = jnp.take(canon, mA, axis=0)
            fB = jnp.take(canon, mB, axis=0) * hasB
            summed = fA + fB if combine == "add" else fA
            back = jnp.take(summed, jnp.asarray(self.face_macro), axis=0)
            faces_new = self._decanon_faces(back)
        edges = self.extract_edges(u, faces if dim == 3 else None)
        canon_e = self._canon_edges(edges)  # (R_e, N)
        if combine == "add":
            esum = jax.ops.segment_sum(
                canon_e, jnp.asarray(self.edge_macro),
                num_segments=self.num_macro_edges,
            )
        else:
            esum = jnp.take(canon_e, jnp.asarray(self.edge_rep_row), axis=0)
        eback = jnp.take(esum, jnp.asarray(self.edge_macro), axis=0)
        edges_new = self._decanon_edges(eback)

        verts = self.extract_verts(u).reshape(-1)
        if combine == "add":
            vsum = jax.ops.segment_sum(
                verts, jnp.asarray(self.vert_macro),
                num_segments=self.num_macro_verts,
            )
        else:
            vsum = jnp.take(verts, jnp.asarray(self.vert_rep_row))
        vback = jnp.take(vsum, jnp.asarray(self.vert_macro)).reshape(self.C, -1)

        return self.write_all(u, faces_new, edges_new, vback)

    def exchange_add(self, u) -> jnp.ndarray:
        return self._accumulate(u, "add")

    def exchange_rep(self, u) -> jnp.ndarray:
        return self._accumulate(u, "rep")

    # ------------------------------------------------------------------
    # reductions / masks
    # ------------------------------------------------------------------

    def _row_doftype(self, flags: np.ndarray, bc: BoundaryCondition) -> np.ndarray:
        out = np.zeros(flags.shape, dtype=np.int32)
        for f in np.unique(flags):
            out[flags == f] = int(bc.doftype_of(int(f)))
        return out

    def dot_ifc(self, u, v, flag: DoFType, bc: BoundaryCondition):
        """Interface part of the global dot (each DoF once)."""
        total = jnp.asarray(0.0, dtype=u.dtype)
        N = self.N
        if self.dim == 3:
            _, tri_int = _tri_masks(N)
            fu = self.extract_faces(u).reshape(-1, N, N)
            fv = self.extract_faces(v).reshape(-1, N, N)
            # representative (cell,face) row per macro face
            repA = np.maximum(self.face_members[:, 0], 0)
            fdt = self._row_doftype(self.face_flag, bc)
            sel = ((fdt & int(flag)) != 0).astype(np.float32)
            mu = jnp.take(fu, jnp.asarray(repA), axis=0)
            mv = jnp.take(fv, jnp.asarray(repA), axis=0)
            w = jnp.asarray(tri_int[None] * sel[:, None, None])
            total = total + jnp.sum(mu * mv * w)
        eu = self._canon_edges(self.extract_edges(u))
        ev = self._canon_edges(self.extract_edges(v))
        mu = jnp.take(eu, jnp.asarray(self.edge_rep_row), axis=0)
        mv = jnp.take(ev, jnp.asarray(self.edge_rep_row), axis=0)
        edt = self._row_doftype(self.edge_flag, bc)
        sel = ((edt & int(flag)) != 0).astype(np.float32)
        lw = jnp.asarray(_line_interior_mask(N)[None] * sel[:, None])
        total = total + jnp.sum(mu * mv * lw)
        vu = self.extract_verts(u).reshape(-1)
        vv = self.extract_verts(v).reshape(-1)
        su = jnp.take(vu, jnp.asarray(self.vert_rep_row))
        sv = jnp.take(vv, jnp.asarray(self.vert_rep_row))
        vdt = self._row_doftype(self.vert_flag, bc)
        sel = jnp.asarray(((vdt & int(flag)) != 0).astype(np.float32))
        total = total + jnp.sum(su * sv * sel)
        return total

    def restore_rows(self, base, new, old, flag: DoFType, bc: BoundaryCondition):
        """Write into ``base``: interface rows get ``new`` where their
        DoFType is in ``flag`` and ``old`` elsewhere (dense, no gathers)."""
        faces_m = None
        fn_all = fo_all = None
        if self.dim == 3:
            fdt = self._row_doftype(self.face_flag, bc)
            frow = ((fdt & int(flag)) != 0)[self.face_macro]  # per row
            sel = jnp.asarray(frow.astype(np.float32))[:, None, None]
            fn_all = self.extract_faces(new)
            fo_all = self.extract_faces(old)
            fn = fn_all.reshape(-1, self.N, self.N)
            fo = fo_all.reshape(-1, self.N, self.N)
            faces_m = (fn * sel + fo * (1 - sel)).reshape(
                self.C, 4, self.N, self.N)
        edt = self._row_doftype(self.edge_flag, bc)
        erow = ((edt & int(flag)) != 0)[self.edge_macro]
        sel = jnp.asarray(erow.astype(np.float32))[:, None]
        en = self.extract_edges(new, fn_all).reshape(-1, self.N)
        eo = self.extract_edges(old, fo_all).reshape(-1, self.N)
        edges_m = (en * sel + eo * (1 - sel)).reshape(self.C, -1, self.N)
        vdt = self._row_doftype(self.vert_flag, bc)
        vrow = ((vdt & int(flag)) != 0)[self.vert_macro]
        sel = jnp.asarray(vrow.astype(np.float32))
        vn = self.extract_verts(new).reshape(-1)
        vo = self.extract_verts(old).reshape(-1)
        verts_m = (vn * sel + vo * (1 - sel)).reshape(self.C, -1)
        return self.write_all(base, faces_m, edges_m, verts_m)

    def scale_ifc(self, u) -> jnp.ndarray:
        """Multiply every interface DoF by 1/multiplicity (restriction
        prescale). Face interiors: 1/#members; edges/verts: 1/#cells."""
        faces = faces_s = None
        if self.dim == 3:
            nmem = (self.face_members >= 0).sum(axis=1)[self.face_macro]
            sel = jnp.asarray((1.0 / np.maximum(nmem, 1)).astype(np.float32))
            faces = self.extract_faces(u)
            faces_s = (faces.reshape(-1, self.N, self.N) * sel[:, None, None]
                       ).reshape(self.C, 4, self.N, self.N)
        emult = np.bincount(self.edge_macro, minlength=self.num_macro_edges)
        es = jnp.asarray((1.0 / np.maximum(emult, 1))[self.edge_macro].astype(np.float32))
        edges = self.extract_edges(u, faces).reshape(-1, self.N)
        edges = (edges * es[:, None]).reshape(self.C, -1, self.N)
        vmult = np.bincount(self.vert_macro, minlength=self.num_macro_verts)
        vs = jnp.asarray((1.0 / np.maximum(vmult, 1))[self.vert_macro].astype(np.float32))
        verts = (self.extract_verts(u).reshape(-1) * vs).reshape(self.C, -1)
        return self.write_all(u, faces_s, edges, verts)


# ---------------------------------------------------------------------------
# construction from storage
# ---------------------------------------------------------------------------


def build_dense_ifc(storage, level: int, pitch: int | None = None) -> DenseIfc:
    """Compile the dense exchange metadata for a single-shard storage."""
    assert storage.num_shards == 1, "dense exchange is the single-shard path"
    dim = storage.dim
    n = 1 << level
    N = n + 1
    pitch = N if (pitch is None or dim == 2) else int(pitch)
    C = storage.cells_per_shard
    topo = storage.topo
    gids = storage.cell_gids  # (C, dim+1)
    valid = storage.cell_valid

    perms = tuple(itertools.permutations(range(3)))

    face_perm_id = face_macro = face_members = face_flag = None
    if dim == 3:
        rows = []
        keys = []
        for c in range(C):
            for lf, tri in enumerate(_LOCAL_FACES):
                g = gids[c, list(tri)]
                order = tuple(int(x) for x in np.argsort(g))
                rows.append(order)
                keys.append(tuple(sorted(int(x) for x in g)))
        face_perm_id = np.array([perms.index(o) for o in rows], dtype=np.int32)
        fidx = storage._lookup_faces(
            np.array(keys, dtype=np.int64)
        )
        face_macro = fidx.astype(np.int32)
        F = topo.num_faces
        face_members = np.full((F, 2), -1, dtype=np.int32)
        for row in range(C * 4):
            if not valid[row // 4]:
                continue
            m = face_macro[row]
            if face_members[m, 0] < 0:
                face_members[m, 0] = row
            elif face_members[m, 1] < 0:
                face_members[m, 1] = row
            else:
                raise AssertionError("macro-face with >2 cells")
        face_flag = topo.face_flag.astype(np.int32)
        # rows of padding cells: point them at a dummy macro face? They reuse
        # a real macro id (replicated gids) — harmless for C valid-only
        # storages; padding cells only occur multi-shard (excluded here).

    local_edges = _LOCAL_EDGES_3D if dim == 3 else _LOCAL_EDGES_2D
    e_rows_flip, e_rows_macro = [], []
    for c in range(C):
        for (i, j) in local_edges:
            gi, gj = int(gids[c, i]), int(gids[c, j])
            lo, hi = min(gi, gj), max(gi, gj)
            eidx = storage._lookup_edges(np.array([[lo, hi]], dtype=np.int64))[0]
            e_rows_macro.append(int(eidx))
            e_rows_flip.append(gi > gj)  # canonical param = weight of hi
    edge_macro = np.array(e_rows_macro, dtype=np.int32)
    edge_flip = np.array(e_rows_flip)
    E = topo.num_edges
    edge_rep_row = np.zeros(E, dtype=np.int32)
    seen = np.zeros(E, dtype=bool)
    for row in range(edge_macro.shape[0]):
        m = edge_macro[row]
        if not seen[m]:
            edge_rep_row[m] = row
            seen[m] = True

    nv = dim + 1
    vert_macro = gids[:, :nv].reshape(-1).astype(np.int32)
    V = topo.num_vertices
    vert_rep_row = np.zeros(V, dtype=np.int32)
    seen = np.zeros(V, dtype=bool)
    for row in range(vert_macro.shape[0]):
        m = vert_macro[row]
        if not seen[m]:
            vert_rep_row[m] = row
            seen[m] = True

    return DenseIfc(
        N=N, dim=dim, C=C, pitch=pitch,
        face_perm_id=face_perm_id,
        face_macro=face_macro,
        face_members=face_members,
        face_flag=face_flag,
        edge_flip=edge_flip,
        edge_macro=edge_macro,
        num_macro_edges=E,
        edge_flag=topo.edge_flag.astype(np.int32),
        edge_rep_row=edge_rep_row,
        vert_macro=vert_macro,
        num_macro_verts=V,
        vert_flag=topo.vertex_flag.astype(np.int32),
        vert_rep_row=vert_rep_row,
        shear_W=_shear_matrix(N),
        perms=perms,
    )
