"""Constant-stencil P2 apply on the dense node grid.

Analog of the reference's generated P2 stencil kernels
(reference: src/constant_stencil_operator/P2generatedKernels/ — 1243 files
of vertex/edge-DoF stencil sweeps dispatched by P2ConstantOperator).

On the level-(L+1) node grid all P2 DoFs are nodes (functions/p2.py), so
the P2 elementwise apply collapses into ONE stencil over the node grid with
*parity-resolved* weights: node p couples to p + s with weight

    c_s(p) = sum over {(t,A,B): O_t(A) == p (mod 2), O_t(B) - O_t(A) = s,
                        base (p - O_t(A))/2 valid in class t} elm[t,A,B]

The base-validity constraints mirror the P1 fast path
(kernels/p1_const_stencil.py):

  * shell: S(base) <= n - margin_t  <=>  S(p) <= 2n - j,
    j = max(0, 2 margin_t - S(O_A)) in {0, 1, 2};
  * coordinate faces: base_i >= 0 fails only for p_i = 0 with O_A_i = 2 —
    inclusion-exclusion over G <= supp2(O_A) with sign (-1)^(|G|+1).

As in the P1 const stencil the full-scheme weights are pointwise exact, so
aliased reads carry exactly zero coefficients and shifted reads need no
masks. In 3D: 65 directions, 230 (parity, dir) interior weights.
"""

from __future__ import annotations

import functools
import itertools

import jax.numpy as jnp
import numpy as np

from ..indexing import flat, micro
from ..operators.p2_elementwise import p2_node_offsets
from .p1_const_stencil import ordered_scatter_add


def _par_index(par, dim: int) -> int:
    if dim == 2:
        return int(par[0]) * 2 + int(par[1])
    return int(par[0]) * 4 + int(par[1]) * 2 + int(par[2])


@functools.lru_cache(maxsize=None)
def p2_stencil_tables(dim: int):
    """Static scatter tables for the parity-resolved P2 stencil.

    Returns (dirs (n_s, dim) int, rows, cols, n_par, n_j) where the flat
    element-matrix entry rows[k] adds into weight slot cols[k] of the
    (n_par, n_s, n_j) tensor."""
    node_offs = p2_node_offsets(dim)
    margins = micro.base_margin(dim)
    T, nn = node_offs.shape[:2]
    dirset = sorted({
        tuple(int(x) for x in node_offs[t, B] - node_offs[t, A])
        for t in range(T) for A in range(nn) for B in range(nn)
    })
    key = {d: i for i, d in enumerate(dirset)}
    n_par = 1 << dim
    n_j = 3
    rows, cols = [], []
    for t in range(T):
        for A in range(nn):
            OA = node_offs[t, A]
            par = _par_index(tuple(int(x) % 2 for x in OA), dim)
            j = max(0, 2 * int(margins[t]) - int(OA.sum()))
            assert j < n_j
            for B in range(nn):
                s = key[tuple(int(x) for x in node_offs[t, B] - OA)]
                rows.append((t * nn + A) * nn + B)
                cols.append((par * len(dirset) + s) * n_j + j)
    dirs = np.asarray(dirset, dtype=np.int64)
    return (dirs, np.asarray(rows, dtype=np.int64),
            np.asarray(cols, dtype=np.int64), n_par, n_j)


def p2_stencil_weights(elmats: jnp.ndarray, dim: int) -> jnp.ndarray:
    """(C, T, nn, nn) -> (C, n_par, n_s, n_j) parity/shell weights."""
    dirs, rows, cols, n_par, n_j = p2_stencil_tables(dim)
    C = elmats.shape[0]
    flatm = elmats.reshape(C, -1)
    A = ordered_scatter_add(flatm[:, rows], cols,
                            n_par * dirs.shape[0] * n_j)
    return A.reshape(C, n_par, dirs.shape[0], n_j)


@functools.lru_cache(maxsize=None)
def p2_face_tables(dim: int):
    """Signed full-scheme face corrections over G <= {i: O_A_i == 2}."""
    node_offs = p2_node_offsets(dim)
    margins = micro.base_margin(dim)
    T, nn = node_offs.shape[:2]
    dirs, _, _, n_par, n_j = p2_stencil_tables(dim)
    key = {tuple(int(x) for x in d): i for i, d in enumerate(dirs)}
    groups = []
    for r in range(1, dim + 1):
        groups.extend(itertools.combinations(range(dim), r))
    gidx = {G: i for i, G in enumerate(groups)}
    rows, cols, signs = [], [], []
    n_s = dirs.shape[0]
    for t in range(T):
        for A in range(nn):
            OA = node_offs[t, A]
            par = _par_index(tuple(int(x) % 2 for x in OA), dim)
            j = max(0, 2 * int(margins[t]) - int(OA.sum()))
            supp2 = tuple(i for i in range(dim) if OA[i] == 2)
            if not supp2:
                continue
            for B in range(nn):
                s = key[tuple(int(x) for x in node_offs[t, B] - OA)]
                for r in range(1, len(supp2) + 1):
                    for G in itertools.combinations(supp2, r):
                        rows.append((t * nn + A) * nn + B)
                        cols.append(((gidx[G] * n_par + par) * n_s + s)
                                    * n_j + j)
                        signs.append(1.0 if (r % 2 == 1) else -1.0)
    return (tuple(groups), np.asarray(rows, dtype=np.int64),
            np.asarray(cols, dtype=np.int64),
            np.asarray(signs, dtype=np.float64))


def p2_face_weights(elmats: jnp.ndarray, dim: int) -> jnp.ndarray:
    """(C, n_g, n_par, n_s, n_j) signed face-correction weights."""
    groups, rows, cols, signs = p2_face_tables(dim)
    dirs, _, _, n_par, n_j = p2_stencil_tables(dim)
    C = elmats.shape[0]
    flatm = elmats.reshape(C, -1)
    E = ordered_scatter_add(
        flatm[:, rows] * jnp.asarray(signs, elmats.dtype), cols,
        len(groups) * n_par * dirs.shape[0] * n_j)
    return E.reshape(C, len(groups), n_par, dirs.shape[0], n_j)


@functools.lru_cache(maxsize=None)
def _nz_tables(dim: int):
    """Structural nonzero masks for main/face weight slots."""
    dirs, rows, cols, n_par, n_j = p2_stencil_tables(dim)
    n_s = dirs.shape[0]
    nzm = np.zeros(n_par * n_s * n_j, dtype=bool)
    nzm[cols] = True
    groups, _, fcols, _ = p2_face_tables(dim)
    nzf = np.zeros(len(groups) * n_par * n_s * n_j, dtype=bool)
    nzf[fcols] = True
    return (nzm.reshape(n_par, n_s, n_j),
            nzf.reshape(len(groups), n_par, n_s, n_j))


@functools.lru_cache(maxsize=None)
def _mask_arrays_p2(level: int, dim: int, pitch: int):
    """Static (M, lanes) masks on the node grid (numpy float32): parity
    masks, K0, shells S = 2n - m (m = 0, 1), face indicators p_i = 0."""
    n = 1 << level
    M = 2 * n + 1
    if dim == 3:
        y, z = flat.yz_maps(M, pitch)
        xs = np.arange(M)[:, None]
        ly, lz = y[None, :], z[None, :]
        in_z = lz < M
        ssum = xs + ly + lz
        coords = [np.broadcast_to(xs, (M, M * pitch)),
                  np.broadcast_to(ly, (M, M * pitch)),
                  np.broadcast_to(lz, (M, M * pitch))]
    else:
        xs = np.arange(M)[:, None]
        lz = np.arange(M)[None, :]
        in_z = lz >= 0
        ssum = xs + lz
        coords = [np.broadcast_to(xs, (M, M)),
                  np.broadcast_to(lz, (M, M))]
    K0 = ((ssum <= 2 * n) & in_z).astype(np.float32)
    shells = tuple(((ssum == 2 * n - m) & in_z).astype(np.float32)
                   for m in range(2))
    faces = tuple((c == 0).astype(np.float32) * K0 for c in coords)
    n_par = 1 << dim
    pars = []
    for p in range(n_par):
        bits = [(p >> (dim - 1 - i)) & 1 for i in range(dim)]
        m = np.ones_like(K0)
        for c, b in zip(coords, bits):
            m = m * (c % 2 == b)
        pars.append(m.astype(np.float32))
    return K0, shells, faces, tuple(pars)


def p2_const_apply_xla(src2d, A, E, level: int, dim: int, pitch: int):
    """Parity-stencil P2 apply in plain XLA (partial sums on interface
    rows). src2d: (C, M, lanes) node block."""
    dirs, _, _, n_par, n_j = p2_stencil_tables(dim)
    groups, *_ = p2_face_tables(dim)
    nzm, nzf = _nz_tables(dim)
    K0, shells, faces, pars = _mask_arrays_p2(level, dim, pitch)
    dt = src2d.dtype
    K0 = jnp.asarray(K0, dt)
    shells = tuple(jnp.asarray(s, dt) for s in shells)
    faces_j = tuple(jnp.asarray(f, dt) for f in faces)
    pars = tuple(jnp.asarray(p, dt) for p in pars)
    n_s = dirs.shape[0]
    reads = [flat.shift_read(src2d, tuple(int(x) for x in dirs[i]),
                             pitch, dim) for i in range(n_s)]

    def wk(a):
        return a.reshape(-1, 1, 1).astype(dt)

    acc_w = [None] * n_par
    acc_m = [[None, None] for _ in range(n_par)]
    for par in range(n_par):
        for s in range(n_s):
            if not nzm[par, s].any():
                continue
            w = A[:, par, s, :].sum(-1)
            term = wk(w) * reads[s]
            acc_w[par] = term if acc_w[par] is None else acc_w[par] + term
            for m in range(2):
                js = [j for j in range(m + 1, n_j) if nzm[par, s, j]]
                if not js:
                    continue
                corr = sum(A[:, par, s, j] for j in js)
                t2 = wk(corr) * reads[s]
                acc_m[par][m] = (t2 if acc_m[par][m] is None
                                 else acc_m[par][m] + t2)
    dst = jnp.zeros_like(src2d)
    for par in range(n_par):
        if acc_w[par] is None:
            continue
        piece = K0 * acc_w[par]
        for m in range(2):
            if acc_m[par][m] is not None:
                piece = piece - shells[m] * acc_m[par][m]
        dst = dst + pars[par] * piece

    # face corrections
    for g, G in enumerate(groups):
        sigma = faces_j[G[0]]
        for i in G[1:]:
            sigma = sigma * faces_j[i]
        corr = None
        for par in range(n_par):
            # slot with shell index j carries [S <= 2n - j]
            # = 1 - sum_{m<j} [S = 2n - m] inside the tet
            acc = [None, None, None]  # tot, sum_{j>=1}, sum_{j>=2}
            for s in range(n_s):
                for j in range(n_j):
                    if not nzf[g, par, s, j]:
                        continue
                    t3 = wk(E[:, g, par, s, j]) * reads[s]
                    for m in range(j + 1):
                        acc[m] = t3 if acc[m] is None else acc[m] + t3
            if acc[0] is None:
                continue
            piece = acc[0]
            for m in (1, 2):
                if acc[m] is not None:
                    piece = piece - shells[m - 1] * acc[m]
            piece = pars[par] * piece
            corr = piece if corr is None else corr + piece
        if corr is not None:
            dst = dst - sigma * corr
    return dst
