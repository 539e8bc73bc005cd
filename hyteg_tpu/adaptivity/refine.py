"""Red-green refinement of the macro mesh (host-side, numpy).

Reference: src/hyteg/adaptiverefinement/mesh.hpp:129-195 (K_Mesh::refineRG),
simplex factories. The reference refines the coarse simplicial macro-mesh
red-green (red = regular split into 4 triangles / 8 tetrahedra, green =
closure elements to avoid hanging nodes), then rebuilds storage +
re-balances. Here the refined mesh is a new MeshInfo from which a new
CellStorage is built (the rebuild *is* the migration/re-balancing step for
the flat storage); DoF fields move between storages with the batched point
locator (adaptivity/transfer.py).

The red child layout is exactly Bey's red refinement as derived in
indexing/micro.py — so refined macros nest with the parent's micro-grids.
Closure rules (Bey 1995): 2D — 1 marked edge: green bisection; >=2: red.
3D — 1 marked edge: green-2; 3 marked edges of one face: green-4; any other
pattern: promote to red and iterate (marks only grow => terminates).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from ..indexing import micro
from ..mesh.meshinfo import MeshInfo, boundary_facets


@dataclasses.dataclass
class RefinementResult:
    mesh: MeshInfo
    parent: np.ndarray      # (C_new,) parent element index in the old mesh
    is_green: np.ndarray    # (C_new,) bool — child of a green closure


def _edges_of(elements: np.ndarray, dim: int) -> np.ndarray:
    pairs = list(itertools.combinations(range(dim + 1), 2))
    return np.stack([elements[:, p] for p in pairs], axis=1)  # (C, E, 2)


def _red_children_3d(v, mids):
    """v: 4 vertex ids; mids: dict (i,j)->mid id. Bey red split (8 tets),
    children = micro classes at level 1 (indexing/micro.py derivation)."""
    # node at integer coords (x,y,z) of the doubled barycentric grid,
    # x+y+z <= 2: even-corner nodes are parent vertices, the rest midpoints
    vcoord = [np.array(c) for c in
              ((0, 0, 0), (2, 0, 0), (0, 2, 0), (0, 0, 2))]

    def node(x, y, z):
        c = (x, y, z)
        for ia in range(4):
            if tuple(vcoord[ia]) == c:
                return v[ia]
        for ia in range(4):
            for ib in range(ia + 1, 4):
                if tuple((vcoord[ia] + vcoord[ib]) // 2) == c:
                    return mids[(min(v[ia], v[ib]), max(v[ia], v[ib]))]
        raise AssertionError(c)

    children = []
    offs, marg = micro.TET_OFFSETS, micro.TET_BASE_MARGIN
    for t in range(6):
        m = int(marg[t])
        for base in itertools.product(range(2), repeat=3):
            if sum(base) <= 2 - m:
                verts = [node(*(np.array(base) + offs[t, k]))
                         for k in range(4)]
                children.append(verts)
    assert len(children) == 8
    return children


def _red_children_2d(v, mids):
    a, b, c = v
    mab = mids[(min(a, b), max(a, b))]
    mbc = mids[(min(b, c), max(b, c))]
    mca = mids[(min(c, a), max(c, a))]
    return [[a, mab, mca], [mab, b, mbc], [mca, mbc, c], [mab, mbc, mca]]


def refine_rg(mesh: MeshInfo, marked_elements) -> RefinementResult:
    """Red-green refinement of the marked macro elements."""
    dim = mesh.dim
    C = mesh.num_elements
    els = np.asarray(mesh.elements)
    marked = np.zeros(C, dtype=bool)
    marked[np.asarray(list(marked_elements), dtype=np.int64)] = True

    edges = _edges_of(els, dim)                      # (C, E, 2)
    ekeys = np.sort(edges, axis=2)

    def ekey(c, e):
        return (int(ekeys[c, e, 0]), int(ekeys[c, e, 1]))

    marked_edges: set = set()
    for c in np.where(marked)[0]:
        for e in range(edges.shape[1]):
            marked_edges.add(ekey(c, e))

    # closure iteration: promote disallowed green patterns to red
    pairs = list(itertools.combinations(range(dim + 1), 2))
    face_triples = list(itertools.combinations(range(dim + 1), 3))
    while True:
        changed = False
        for c in range(C):
            me = [e for e in range(len(pairs)) if ekey(c, e) in marked_edges]
            ne = len(me)
            if ne == 0 or ne == len(pairs):
                continue
            ok_green = False
            if ne == 1:
                ok_green = True
            elif dim == 3 and ne == 3:
                vs = set()
                for e in me:
                    vs.update(pairs[e])
                ok_green = len(vs) == 3  # the 3 edges of one face
            if not ok_green:
                for e in range(len(pairs)):
                    if ekey(c, e) not in marked_edges:
                        marked_edges.add(ekey(c, e))
                        changed = True
        if not changed:
            break

    # new vertices at marked-edge midpoints
    pts = list(np.asarray(mesh.points))
    flags = (np.asarray(mesh.vertex_boundary_flag)
             if mesh.vertex_boundary_flag is not None
             else np.zeros(mesh.num_vertices, dtype=np.int64))
    flags = list(flags)
    bfacets = {tuple(sorted(f)) for f in boundary_facets(els, dim)}

    def edge_on_boundary(a, b):
        if dim == 2:
            return (min(a, b), max(a, b)) in bfacets
        return any({a, b} <= set(f) for f in bfacets)

    mids: dict = {}
    for (a, b) in sorted(marked_edges):
        mids[(a, b)] = len(pts)
        pts.append((np.asarray(pts[a]) + np.asarray(pts[b])) / 2.0)
        if flags[a] == flags[b] and flags[a] != 0 and edge_on_boundary(a, b):
            flags.append(flags[a])
        else:
            flags.append(0)

    new_els, parent, is_green = [], [], []
    for c in range(C):
        v = [int(x) for x in els[c]]
        me = [e for e in range(len(pairs)) if ekey(c, e) in marked_edges]
        ne = len(me)
        if ne == 0:
            new_els.append(v)
            parent.append(c)
            is_green.append(False)
        elif ne == len(pairs):  # red
            kids = (_red_children_2d(v, mids) if dim == 2
                    else _red_children_3d(v, mids))
            for k in kids:
                new_els.append(k)
                parent.append(c)
                is_green.append(False)
        elif ne == 1:  # green bisection
            i, j = pairs[me[0]]
            m = mids[(min(v[i], v[j]), max(v[i], v[j]))]
            rest = [v[k] for k in range(dim + 1) if k not in (i, j)]
            new_els.append([v[i], m] + rest)
            new_els.append([m, v[j]] + rest)
            parent += [c, c]
            is_green += [True, True]
        else:  # 3D green-4: one face fully marked
            vs = set()
            for e in me:
                vs.update(pairs[e])
            (i, j, k) = sorted(vs)
            l = [x for x in range(4) if x not in vs][0]
            vi, vj, vk, vl = v[i], v[j], v[k], v[l]
            mij = mids[(min(vi, vj), max(vi, vj))]
            mik = mids[(min(vi, vk), max(vi, vk))]
            mjk = mids[(min(vj, vk), max(vj, vk))]
            for kid in ([mij, mik, mjk, vl], [vi, mij, mik, vl],
                        [mij, vj, mjk, vl], [mik, mjk, vk, vl]):
                new_els.append(kid)
                parent.append(c)
                is_green.append(True)

    new_mesh = MeshInfo(
        np.asarray(pts, dtype=np.float64),
        np.asarray(new_els, dtype=np.int64),
        dim,
        vertex_boundary_flag=np.asarray(flags, dtype=np.int64),
    )
    return RefinementResult(new_mesh, np.asarray(parent, dtype=np.int64),
                            np.asarray(is_green, dtype=bool))


def refine_uniform(mesh: MeshInfo, times: int = 1) -> MeshInfo:
    """Red-refine every element ``times`` times
    (reference: MeshInfo::refinedCoarseMesh)."""
    for _ in range(times):
        mesh = refine_rg(mesh, np.arange(mesh.num_elements)).mesh
    return mesh
