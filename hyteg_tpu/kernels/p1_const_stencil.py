"""Constant-stencil P1 apply: the 15-point-stencil fast path.

Analog of the reference's constant-stencil operators
(reference: src/hyteg/constant_stencil_operator/P1ConstantOperator.cpp:239-667
and the generated kernels, e.g. apply_3D_macrocell_vertexdof_to_vertexdof_
replace.cpp:14-60 — a 15-point stencil swept over the macro-cell).

Derivation. With per-cell-constant element matrices, the elementwise apply

    dst[p] += sum_t sum_{a,b} [p - off_a in base_t] elm[t,a,b] src[p - off_a + off_b]

collapses into a stencil: for each direction s = off_b - off_a,

    dst[p] = sum_s c_s(p) * src[p + s].

The weight c_s(p) is position dependent only near the four macro-tet faces:

  * interior: c_s = W_s = sum over all (t,a,b) with direction s;
  * the two diagonal shells S(p) = x+y+z in {n, n-1} lose the terms with
    j(t,a) = margin_t - S(off_a) > n - S(p)  (shell correction, as in the
    reference's stencil assembly);
  * the coordinate faces p_i = 0 lose the terms with off_a_i = 1 (the
    element's base would need p_i - 1 = -1); inclusion-exclusion over face
    subsets G <= supp(off_a) with sign (-1)^(|G|+1) handles multi-face
    overlap (edges/corner).

The resulting weights are *pointwise exact*: any read whose target leaves
the macro-tet (lane aliasing across y-rows, block padding) is multiplied by
an exactly zero coefficient, so shifted reads need no per-direction masks.
All tables are static; the apply is 15 shifted reads and ~45
multiply-accumulate passes (vs. the 96 masked accumulation passes of the
general elementwise path), which XLA fuses into one loop.  Verified against
the general path / dense assembly in tests/test_const_stencil.py.
"""

from __future__ import annotations

import functools
import itertools

import jax.numpy as jnp
import numpy as np

from ..indexing import flat, micro


@functools.lru_cache(maxsize=None)
def stencil_tables(dim: int):
    """Static (t,a,b) -> (s, j) scatter tables.

    Returns (dirs (n_s, dim) int, tab (T*nv*nv, 2) int with columns
    (s_index, j), n_j)."""
    offs = micro.offsets(dim)  # (T, nv, dim)
    margins = micro.base_margin(dim)
    T, nv = offs.shape[0], offs.shape[1]
    dirs = micro.stencil_directions(dim)  # (n_s, dim), includes 0
    key = {tuple(int(x) for x in d): i for i, d in enumerate(dirs)}
    rows = []
    for t in range(T):
        for a in range(nv):
            j = int(margins[t]) - int(offs[t, a].sum())
            assert j >= 0
            for b in range(nv):
                s = tuple(int(x) for x in (offs[t, b] - offs[t, a]))
                rows.append((key[s], j))
    tab = np.asarray(rows, dtype=np.int64)
    return dirs, tab, int(tab[:, 1].max()) + 1


def ordered_scatter_add(vals: jnp.ndarray, cols, n_slots: int) -> jnp.ndarray:
    """``zeros((C, n_slots)).at[:, cols].add(vals)`` with each slot's
    entries added one after another in table order.

    A scatter-add with repeated slots sums in whatever order the GPU's
    atomics land, so two builds of the same weights can differ in the last
    bit.  A last-bit change of a stencil's row sum moves the float32
    solution of a Poisson problem by up to eps * cond(A) (1e-4 relative at
    2M DoFs).  The fixed order gives the same weights on every device and
    in every program, eager or traced."""
    cols = np.asarray(cols)
    counts = np.bincount(cols, minlength=n_slots)
    order = np.argsort(cols, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    # (n_slots, K) source columns; column vals.shape[1] is a zero pad
    idx = np.full((n_slots, int(counts.max())), vals.shape[1])
    for k in range(idx.shape[1]):
        has = counts > k
        idx[has, k] = order[starts[has] + k]
    padded = jnp.concatenate([vals, jnp.zeros_like(vals[:, :1])], axis=1)
    terms = padded[:, idx]
    acc = terms[..., 0]
    for k in range(1, idx.shape[1]):
        acc = acc + terms[..., k]
    return acc


def stencil_weights(elmats: jnp.ndarray, dim: int) -> jnp.ndarray:
    """(C, T, nv, nv) element matrices -> (C, n_s, n_j) shell-resolved
    stencil weights A (traceable; a fixed-order sum over static tables)."""
    dirs, tab, n_j = stencil_tables(dim)
    C = elmats.shape[0]
    flatm = elmats.reshape(C, -1)  # (C, T*nv*nv) in (t, a, b) order
    A = ordered_scatter_add(flatm, tab[:, 0] * n_j + tab[:, 1],
                            dirs.shape[0] * n_j)
    return A.reshape(C, dirs.shape[0], n_j)


@functools.lru_cache(maxsize=None)
def _structural_nonzero(dim: int):
    """Which (s, j) slots receive any element-matrix entry (static)."""
    dirs, tab, n_j = stencil_tables(dim)
    nz = np.zeros((dirs.shape[0], n_j), dtype=bool)
    nz[tab[:, 0], tab[:, 1]] = True
    return nz


# ---------------------------------------------------------------------------
# coordinate-face corrections (inclusion-exclusion over face subsets)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def face_tables_full(dim: int):
    """Like face_tables but with G <= supp(off_a) only (no off_b condition).

    These corrections make the stencil weights *pointwise exact* regardless
    of read semantics: any read whose target leaves the macro-tet (lane
    aliasing, out-of-block values) is multiplied by an exactly zero total
    weight, because no valid element couples p with an out-of-tet node.
    Returns (groups, (n_G, n_j, n_s) dense numpy scatter info) like
    face_tables."""
    offs = micro.offsets(dim)
    margins = micro.base_margin(dim)
    T, nv = offs.shape[0], offs.shape[1]
    dirs, _, n_j = stencil_tables(dim)
    key = {tuple(int(x) for x in d): i for i, d in enumerate(dirs)}
    groups = []
    for r in range(1, dim + 1):
        groups.extend(itertools.combinations(range(dim), r))
    gidx = {G: i for i, G in enumerate(groups)}
    rows, cols, signs = [], [], []
    for t in range(T):
        for a in range(nv):
            j = int(margins[t]) - int(offs[t, a].sum())
            supp = tuple(i for i in range(dim) if offs[t, a, i] == 1)
            if not supp:
                continue
            for b in range(nv):
                s = key[tuple(int(x) for x in offs[t, b] - offs[t, a])]
                src_row = (t * nv + a) * nv + b
                for r in range(1, len(supp) + 1):
                    for G in itertools.combinations(supp, r):
                        rows.append(src_row)
                        cols.append((gidx[G] * n_j + j) * len(dirs) + s)
                        signs.append(1.0 if (r % 2 == 1) else -1.0)
    return (
        tuple(groups),
        np.asarray(rows, dtype=np.int64),
        np.asarray(cols, dtype=np.int64),
        np.asarray(signs, dtype=np.float64),
        n_j,
    )


def face_weights_full(elmats: jnp.ndarray, dim: int) -> jnp.ndarray:
    """(C, n_G, n_j, n_s) signed full-scheme face corrections (traceable)."""
    groups, rows, cols, signs, n_j = face_tables_full(dim)
    dirs, _, _ = stencil_tables(dim)
    C = elmats.shape[0]
    flatm = elmats.reshape(C, -1)
    vals = flatm[:, rows] * jnp.asarray(signs, dtype=elmats.dtype)
    E = ordered_scatter_add(vals, cols, len(groups) * n_j * dirs.shape[0])
    return E.reshape(C, len(groups), n_j, dirs.shape[0])


@functools.lru_cache(maxsize=None)
def _face_nonzero_full(dim: int):
    groups, rows, cols, signs, n_j = face_tables_full(dim)
    dirs, _, _ = stencil_tables(dim)
    nz = np.zeros(len(groups) * n_j * dirs.shape[0], dtype=bool)
    nz[cols] = True
    return nz.reshape(len(groups), n_j, dirs.shape[0])


@functools.lru_cache(maxsize=None)
def _mask_arrays(level: int, dim: int, pitch: int):
    """Static (N, lanes) masks: K0 (inside tet), shells S = n - m, and the
    coordinate-face indicators p_i = 0 (numpy float32)."""
    n = 1 << level
    N = n + 1
    if dim == 3:
        ysum = flat.yz_sum(N, pitch)
        y, z = flat.yz_maps(N, pitch)
        ssum = ysum[None, :] + np.arange(N)[:, None]
        coord = [
            np.broadcast_to(np.arange(N)[:, None], (N, N * pitch)),
            np.broadcast_to(y[None, :], (N, N * pitch)),
            np.broadcast_to(z[None, :], (N, N * pitch)),
        ]
    else:
        ssum = np.add.outer(np.arange(N), np.arange(N))
        coord = [
            np.broadcast_to(np.arange(N)[:, None], (N, N)),
            np.broadcast_to(np.arange(N)[None, :], (N, N)),
        ]
    K0 = (ssum <= n).astype(np.float32)
    _, _, n_j = stencil_tables(dim)
    shells = tuple(
        (ssum == n - m).astype(np.float32) for m in range(n_j - 1)
    )
    faces = tuple((c == 0).astype(np.float32) * K0 for c in coord)
    return K0, shells, faces


def _combine(reads, main_w, main_tail, face_w, dim, masks):
    """Accumulation of the constant-stencil apply.

    reads: list of n_s shifted-read arrays (strictly zero-filled).
    main_w(s): total interior weight W_s (broadcastable against reads[s]).
    main_tail(s, m): sum_{j > m} A[s, j] or None (shell-correction tail).
    face_w(g, j, s): signed face-correction weight E or None.
    masks: (K0, shells, faces) arrays broadcastable against reads.
    """
    dirs, _, n_j = stencil_tables(dim)
    groups, *_ = face_tables_full(dim)
    K0, shells, faces = masks
    n_s = dirs.shape[0]

    # main: K0 * sum_s W_s r_s - sum_m shell_m * (sum_s A_{>m,s} r_s)
    acc_w = None
    acc_shell = [None] * (n_j - 1)
    for s in range(n_s):
        term = main_w(s) * reads[s]
        acc_w = term if acc_w is None else acc_w + term
        for m in range(n_j - 1):
            corr = main_tail(s, m)
            if corr is None:
                continue
            t2 = corr * reads[s]
            acc_shell[m] = t2 if acc_shell[m] is None else acc_shell[m] + t2
    dst = K0 * acc_w
    for m in range(n_j - 1):
        if acc_shell[m] is not None:
            dst = dst - shells[m] * acc_shell[m]

    # face corrections: - sum_G sigma_G * sum_j [S <= n-j] sum_s E r_s.
    # sigma_G already includes K0; [S <= n-j] restricted there equals
    # (1 - sum_{m<j} [S = n-m]).
    for g, G in enumerate(groups):
        sigma = faces[G[0]]
        for i in G[1:]:
            sigma = sigma * faces[i]
        acc_g = [None] * n_j
        for j in range(n_j):
            for s in range(n_s):
                w = face_w(g, j, s)
                if w is None:
                    continue
                t2 = w * reads[s]
                acc_g[j] = t2 if acc_g[j] is None else acc_g[j] + t2
        total = None
        for j in range(n_j):
            if acc_g[j] is None:
                continue
            term = acc_g[j]
            for m in range(j):
                term = term - shells[m] * acc_g[j]
            total = term if total is None else total + term
        if total is not None:
            dst = dst - sigma * total
    return dst


def _xla_accessors(A, E, dim, dtype):
    """Weight accessors for the XLA path ((C, 1, 1)-shaped factors)."""
    _, _, n_j = stencil_tables(dim)
    nzs = _structural_nonzero(dim)
    nzf = _face_nonzero_full(dim)

    def wk(arr):
        return arr.reshape(-1, 1, 1).astype(dtype)

    def main_w(s):
        # summed in j order, like the weights themselves (see
        # ordered_scatter_add): a reduce may pick its own order
        w = A[:, s, 0]
        for j in range(1, n_j):
            w = w + A[:, s, j]
        return wk(w)

    def main_tail(s, m):
        js = [j for j in range(m + 1, n_j) if nzs[s, j]]
        if not js:
            return None
        corr = A[:, s, js[0]]
        for j in js[1:]:
            corr = corr + A[:, s, j]
        return wk(corr)

    def face_w(g, j, s):
        if not nzf[g, j, s]:
            return None
        return wk(E[:, g, j, s])

    return main_w, main_tail, face_w


def p1_const_apply_xla(src2d, A, level: int, dim: int, pitch: int, E=None):
    """Constant-stencil apply in plain XLA (partial sums on interface
    rows).

    Reads are plain flat shifts (ends zero-filled, lane aliasing allowed):
    the full-scheme weights are pointwise exact, so every out-of-tet read
    carries a zero coefficient (see face_tables_full)."""
    if E is None:
        raise ValueError("pass E = face_weights_full(elmats, dim)")
    dirs, _, _ = stencil_tables(dim)
    reads = [
        flat.shift_read(src2d, tuple(int(x) for x in dirs[i]), pitch, dim)
        for i in range(dirs.shape[0])
    ]
    K0, shells, faces = _mask_arrays(level, dim, pitch)
    masks = (
        jnp.asarray(K0, dtype=src2d.dtype),
        tuple(jnp.asarray(s, dtype=src2d.dtype) for s in shells),
        tuple(jnp.asarray(f, dtype=src2d.dtype) for f in faces),
    )
    accessors = _xla_accessors(A, E, dim, src2d.dtype)
    return _combine(reads, *accessors, dim, masks)
