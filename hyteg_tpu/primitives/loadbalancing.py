"""Load balancers + primitive migration over the sharded macro-cell storage.

Equivalents of the reference's balancers
(reference: src/hyteg/primitivestorage/loadbalancing/SimpleBalancer.hpp:53-77
— roundRobin/roundRobinVolume/greedy/allPrimitivesOnRoot, and the SFC
balancer of adaptive refinement, src/hyteg/adaptiverefinement/mesh.hpp:195)
and of primitive migration for dynamic re-balancing
(reference: src/hyteg/primitivestorage/PrimitiveStorage.hpp:528
``migratePrimitives`` + MigrationInfo). Here "rank" = shard; migration is a
device-side gather that permutes per-cell DoF blocks from the old layout to
the new one."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..mesh.meshinfo import MeshInfo
from .storage import CellStorage


# -- partitioners (return shard assignment per cell) --------------------------


def morton_codes(points: np.ndarray, bits: int = 16) -> np.ndarray:
    """Morton (Z-order) codes of points normalized to the unit box.
    Delegates to the native setup core when available."""
    from .. import native

    if native.available():
        return native.morton_codes(points, bits)
    p = np.asarray(points, dtype=np.float64)
    lo, hi = p.min(axis=0), p.max(axis=0)
    q = ((p - lo) / np.where(hi - lo == 0, 1.0, hi - lo)
         * ((1 << bits) - 1)).astype(np.uint64)
    dim = p.shape[1]
    codes = np.zeros(len(p), dtype=np.uint64)
    for b in range(bits):
        for d in range(dim):
            codes |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                b * dim + d)
    return codes


def partition_sfc(centroids: np.ndarray, num_shards: int,
                  weights: np.ndarray | None = None) -> np.ndarray:
    """Space-filling-curve balancer: sort by Morton code, split into
    contiguous equal-weight chunks (communication locality)."""
    order = np.argsort(morton_codes(centroids), kind="stable")
    n = len(order)
    w = np.ones(n) if weights is None else np.asarray(weights, dtype=float)
    csum = np.cumsum(w[order])
    total = csum[-1]
    assignment = np.zeros(n, dtype=np.int64)
    # chunk boundaries at equal cumulative weight
    targets = total * (np.arange(1, num_shards + 1) / num_shards)
    bounds = np.searchsorted(csum, targets, side="left")
    start = 0
    for d, end in enumerate(bounds):
        end = max(int(end) + 1, start + 1) if d < num_shards - 1 else n
        end = min(end, n - (num_shards - 1 - d))  # leave >=1 cell per shard
        assignment[order[start:end]] = d
        start = end
    return assignment


def partition_greedy(num_shards: int, weights: np.ndarray) -> np.ndarray:
    """Greedy weighted bin packing: heaviest cell to the lightest shard
    (reference: loadbalancing::greedy / roundRobinVolume)."""
    w = np.asarray(weights, dtype=float)
    order = np.argsort(-w, kind="stable")
    loads = np.zeros(num_shards)
    counts = np.zeros(num_shards, dtype=np.int64)
    assignment = np.zeros(len(w), dtype=np.int64)
    n = len(w)
    for i, cell in enumerate(order):
        remaining = n - i
        # never leave a shard empty when cells run low
        need = counts == 0
        if need.any() and remaining <= int(need.sum()):
            d = int(np.argmax(need))
        else:
            d = int(np.argmin(loads))
        assignment[cell] = d
        loads[d] += w[cell]
        counts[d] += 1
    return assignment


def cell_volumes(mesh: MeshInfo) -> np.ndarray:
    from ..mesh.meshinfo import MeshInfo as _MI  # noqa: F401

    pts = mesh.points[mesh.elements][..., : mesh.dim]
    J = pts[:, 1:, :] - pts[:, :1, :]
    det = np.abs(np.linalg.det(J))
    return det / (6.0 if mesh.dim == 3 else 2.0)


def make_storage(mesh: MeshInfo, num_shards: int,
                 method: str = "sfc") -> CellStorage:
    """Build a CellStorage under a named balancer: 'round_robin',
    'contiguous', 'all_on_root', 'sfc', 'greedy_volume'."""
    if method in ("round_robin", "contiguous", "all_on_root"):
        return CellStorage(mesh, num_shards, partitioner=method)
    centroids = mesh.points[mesh.elements].mean(axis=1)
    if method == "sfc":
        a = partition_sfc(centroids, num_shards)
    elif method == "greedy_volume":
        a = partition_greedy(num_shards, cell_volumes(mesh))
    else:
        raise ValueError(f"unknown balancer {method}")
    return CellStorage(mesh, num_shards, assignment=a)


def interface_cut(storage: CellStorage, level: int) -> int:
    """Number of interface DoFs whose replicas span more than one shard —
    the communication volume a balancer should minimize."""
    maps = storage.p1_level_maps(level)
    D = maps.slot_gid.shape[0]
    G = maps.num_ifc
    seen = np.zeros((G + 1, D), dtype=bool)
    for d in range(D):
        seen[maps.slot_gid[d], d] = True
    return int((seen[:G].sum(axis=1) > 1).sum())


# -- migration ----------------------------------------------------------------


@dataclasses.dataclass
class MigrationInfo:
    """Old-layout -> new-layout cell permutation
    (reference: PrimitiveStorage MigrationInfo)."""

    src_slot: np.ndarray   # (C_new,) int: old slot per new slot; -1 = padding
    old_storage: CellStorage
    new_storage: CellStorage

    def migrate_cellwise(self, u_old: jnp.ndarray) -> jnp.ndarray:
        """Permute any per-cell-leading-axis block array (C_old, ...) into
        the new layout (C_new, ...); padded cells read slot 0 and are
        zero-masked."""
        idx = jnp.asarray(np.maximum(self.src_slot, 0))
        out = jnp.take(u_old, idx, axis=0)
        mask = jnp.asarray(
            (self.src_slot >= 0).astype(np.float32), dtype=u_old.dtype)
        return out * mask.reshape((-1,) + (1,) * (u_old.ndim - 1))


def migrate(old: CellStorage, new: CellStorage) -> MigrationInfo:
    """Plan a migration between two storages over the same mesh/topology."""
    assert old.topo.num_cells == new.topo.num_cells, "different meshes"
    old_slot_of_cell = np.full(old.topo.num_cells, -1, dtype=np.int64)
    for slot in range(old.num_cells):
        if old.cell_valid[slot]:
            old_slot_of_cell[old.cell_global_index[slot]] = slot
    src = np.full(new.num_cells, -1, dtype=np.int64)
    for slot in range(new.num_cells):
        if new.cell_valid[slot]:
            src[slot] = old_slot_of_cell[new.cell_global_index[slot]]
    return MigrationInfo(src_slot=src, old_storage=old, new_storage=new)


def rebalance(storage: CellStorage, method: str = "sfc") -> MigrationInfo:
    """Re-balance a live storage under a new balancer (the reference's
    distributed re-balancing: DistributedBalancer.cpp:51)."""
    new = make_storage(storage.mesh, storage.num_shards, method)
    return migrate(storage, new)
