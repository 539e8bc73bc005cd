"""P1 (vertex-DoF) function space on sharded macro-cell blocks.

Redesign of the reference's VertexDoFFunction
(reference: src/hyteg/p1functionspace/VertexDoFFunction.hpp:58-486).
DoF values live in dense masked *flat* blocks ``(C, N, N*pitch)`` in 3D
(lane = y*pitch + z; see indexing/flat.py) and ``(C, N, N)`` in 2D, one
block per macro-cell, interface DoFs replicated across adjacent cells
(invariant: replicas equal; padding lanes z >= N stay zero). The
halo-exchange of the reference
(communicate / communicateAdditively) becomes two index-map exchanges:

  * ``exchange_add``  — replicas <- sum of replicas (additive communication,
    reference: VertexDoFAdditivePackInfo.hpp)
  * ``exchange_rep``  — replicas <- owner value (sync / consistency)

Both are segment-sum/gather over precomputed slot maps + an optional
``psum`` over the device mesh axis. All ops take a ``P1ShardData`` pytree of
the device-local maps so the same code runs (a) single-device with static
constants and (b) inside shard_map with the maps sharded over the mesh.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import BoundaryCondition, DoFType, FLAG_INNER
from ..indexing import micro
from ..primitives.storage import CellStorage, P1LevelMaps


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class P1ShardData:
    """Device-local slot maps and cell data (all jnp arrays; pytree).

    The optional ``nbr_*`` tables enable the neighbor-wise exchange
    (O(local interface) ppermutes instead of an O(global interface) psum;
    reference analog: src/hyteg/communication/PackInfo.hpp:43-183 —
    precomputed per-neighbor pack lists).  ``nbr_perms`` holds one
    ppermute pair list per edge-coloring round (static metadata)."""

    slot_flat: jnp.ndarray      # (S,) int32; OOB value for padded slots
    slot_gid: jnp.ndarray       # (S,) int32; == num_ifc for padded slots
    slot_rep: jnp.ndarray       # (S,) bool — global representative slot
    slot_inv_mult: jnp.ndarray  # (S,) float — 1/replica count (0 padded)
    slot_doftype: jnp.ndarray   # (S,) int32 — DoFType under the function's BC
    cell_valid: jnp.ndarray     # (C_loc,) bool
    cell_vertices: jnp.ndarray  # (C_loc, nv, 3) float
    bc: BoundaryCondition | None = None  # static (pytree aux)
    nbr_slot_lid: jnp.ndarray | None = None  # (S,) int32 local gid id
    nbr_pack: jnp.ndarray | None = None      # (R, M) int32 send lids
    nbr_recv: jnp.ndarray | None = None      # (R, M) int32 recv lids
    nbr_num_local: int = 0                   # static: L_max (dump = L_max)
    nbr_perms: tuple = ()                    # static: R ppermute pair lists
    # interior/interface overlap tables (reference analog: the
    # startCommunication/endCommunication split of
    # src/hyteg/communication/BufferedCommunication.hpp:92-100):
    ovl_cells: jnp.ndarray | None = None     # (C_loc,) cell permutation,
    #                                          interface-incident first
    ovl_slot_flat: jnp.ndarray | None = None  # (S,) flat idx into the
    #                                           permuted first-K subblock
    ovl_slot_lid: jnp.ndarray | None = None  # (S,) lid for cross-device
    #                                          gids, else L_max
    ovl_k: int = 0                           # static: interface cell count

    def tree_flatten(self):
        children = [
            self.slot_flat, self.slot_gid, self.slot_rep, self.slot_inv_mult,
            self.slot_doftype, self.cell_valid, self.cell_vertices,
        ]
        has_nbr = self.nbr_pack is not None
        if has_nbr:
            children += [self.nbr_slot_lid, self.nbr_pack, self.nbr_recv]
        has_ovl = self.ovl_cells is not None
        if has_ovl:
            children += [self.ovl_cells, self.ovl_slot_flat,
                         self.ovl_slot_lid]
        return tuple(children), (self.bc, has_nbr, self.nbr_num_local,
                                 self.nbr_perms, has_ovl, self.ovl_k)

    @classmethod
    def tree_unflatten(cls, aux, children):
        bc, has_nbr, n_local, perms, has_ovl, ovl_k = (
            aux if len(aux) == 6 else aux + (False, 0))
        base = children[:7]
        kw = {}
        i = 7
        if has_nbr:
            kw.update(nbr_slot_lid=children[i], nbr_pack=children[i + 1],
                      nbr_recv=children[i + 2], nbr_num_local=n_local,
                      nbr_perms=perms)
            i += 3
        if has_ovl:
            kw.update(ovl_cells=children[i], ovl_slot_flat=children[i + 1],
                      ovl_slot_lid=children[i + 2], ovl_k=ovl_k)
        return cls(*base, bc=bc, **kw)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class P1Function:
    """User-facing handle: per-cell DoF blocks + static space/BC."""

    cells: jnp.ndarray  # (C_loc, N, N*pitch) in 3D, (C_loc, N, N) in 2D
    space: "P1Space" = dataclasses.field(metadata=dict(static=True))
    bc: BoundaryCondition = dataclasses.field(metadata=dict(static=True))

    def tree_flatten(self):
        return (self.cells,), (self.space, self.bc)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    # -- vector-space ops (reference: VertexDoFFunction assign/add/dot) ------

    def copy(self) -> "P1Function":
        return P1Function(self.cells, self.space, self.bc)

    def _like(self, cells) -> "P1Function":
        return P1Function(cells, self.space, self.bc)

    def _sd(self):
        return self.space.shard_data(0, self.bc)

    def assign(self, scalars, functions, flag: DoFType = DoFType.ALL) -> "P1Function":
        new = sum(s * f.cells for s, f in zip(scalars, functions))
        if flag == DoFType.ALL:
            return self._like(new)
        return self._like(
            self.space.restore_rows(new, self.cells, flag, self._sd())
        )

    def add_scaled(self, scalars, functions, flag: DoFType = DoFType.ALL) -> "P1Function":
        new = self.cells + sum(s * f.cells for s, f in zip(scalars, functions))
        if flag == DoFType.ALL:
            return self._like(new)
        return self._like(
            self.space.restore_rows(new, self.cells, flag, self._sd())
        )

    def interpolate(self, expr, flag: DoFType = DoFType.ALL) -> "P1Function":
        return self._like(
            self.space.interpolate(expr, self.cells, flag, self._sd())
        )

    def dot_global(self, other: "P1Function", flag: DoFType = DoFType.ALL):
        return self.space.dot(self.cells, other.cells, flag, self._sd())

    def sum_global(self, flag: DoFType = DoFType.ALL):
        return self.space.dof_sum(self.cells, flag, self._sd())

    def max_global(self, flag: DoFType = DoFType.ALL):
        return self.space.dof_max(self.cells, flag, self._sd())

    def norm(self, flag: DoFType = DoFType.ALL):
        return jnp.sqrt(self.dot_global(self, flag))


class P1Space:
    """Binds (storage, level): static masks, maps, and core kernels.

    All numeric methods are pure jax functions of (arrays, shard-data);
    static per-level info (masks, sizes) is captured as constants.
    """

    def __init__(self, storage: CellStorage, level: int, dtype=jnp.float32,
                 pitch: int | None = None):
        self.storage = storage
        self.level = level
        self.dtype = dtype
        self.dim = storage.dim
        self.N = (1 << level) + 1
        # lane pitch of the flat 3D layout; GMG stacks share pitch = N_max
        # across levels so grid transfers are pure stride-2 slicing
        self.pitch = self.N if (pitch is None or self.dim == 2) else int(pitch)
        assert self.pitch >= self.N
        self.maps: P1LevelMaps = storage.p1_level_maps(
            level, self.pitch if self.dim == 3 else None
        )
        self.n = self.N - 1
        self.C_loc = storage.cells_per_shard
        self._sd_cache: dict[Any, P1ShardData] = {}

    # -- static helpers ------------------------------------------------------

    @property
    def lanes(self) -> int:
        """Size of the minor (lane) axis of a block."""
        return self.N * self.pitch if self.dim == 3 else self.N

    @property
    def block_shape(self):
        return (self.C_loc, self.N, self.lanes)

    @property
    def block_size(self):
        return self.C_loc * self.N * self.lanes

    @functools.cached_property
    def vertex_mask(self) -> np.ndarray:
        """Flat (N, lanes) bool mask of valid micro-vertices."""
        return micro.vertex_mask_flat(self.level, self.dim, self.pitch)

    @functools.cached_property
    def interior_mask(self) -> np.ndarray:
        return micro.interior_mask_flat(self.level, self.dim, self.pitch)

    def to_grid(self, u):
        """(C, N, lanes) -> (C, N, N, pitch) grid view (3D; identity in 2D).
        Cheap when sliced immediately; avoid materializing it."""
        if self.dim == 2:
            return u
        return u.reshape(u.shape[:-1] + (self.N, self.pitch))

    def from_grid(self, g):
        if self.dim == 2:
            return g
        return g.reshape(g.shape[:-2] + (self.N * self.pitch,))

    def cell_valid(self, shard: int = 0) -> np.ndarray:
        lo = shard * self.C_loc
        return self.storage.cell_valid[lo : lo + self.C_loc]

    def cell_vertices(self, shard: int = 0) -> np.ndarray:
        lo = shard * self.C_loc
        return self.storage.cell_vertices[lo : lo + self.C_loc]

    def num_global_dofs(self) -> int:
        return self.maps.num_global_dofs

    # -- shard data ----------------------------------------------------------

    @functools.cached_property
    def slot_rep_mask(self) -> np.ndarray:
        """(D, S) bool — slot is the global representative of its DoF."""
        m = self.maps
        out = np.zeros(m.slot_flat.shape, dtype=bool)
        out[m.ifc_rep_dev, m.ifc_rep_slot] = True
        return out

    @functools.cached_property
    def slot_inv_mult(self) -> np.ndarray:
        """(D, S) float — 1 / replica count (0 on padded slots)."""
        m = self.maps
        inv = np.zeros(m.slot_flat.shape, dtype=np.float64)
        valid = m.slot_gid < m.num_ifc
        inv[valid] = 1.0 / m.ifc_mult[m.slot_gid[valid]]
        return inv

    def slot_doftype_np(self, bc: BoundaryCondition) -> np.ndarray:
        """(D, S) int32 DoFType per interface slot under the given BC."""
        flags = self.maps.slot_meshflag
        out = np.zeros(flags.shape, dtype=np.int32)
        for f in np.unique(flags):
            out[flags == f] = int(bc.doftype_of(int(f)))
        return out

    #: module-wide switch for the dense structured exchange fast path
    use_dense_exchange: bool = True

    @functools.cached_property
    def dense_ifc(self):
        from .ifc_dense import build_dense_ifc

        if self.storage.num_shards != 1:
            return None
        return build_dense_ifc(self.storage, self.level, self.pitch)

    def _dense_ok(self, sd: P1ShardData, axis_name) -> bool:
        return (
            P1Space.use_dense_exchange
            and axis_name is None
            and self.storage.num_shards == 1
            and sd.bc is not None
            and self.dtype == jnp.float32  # DenseIfc constants are f32
            and not isinstance(sd.slot_flat, jax.core.Tracer)
            and self.dense_ifc is not None
        )

    def resolve_sd(self, sd_or_bc=None, shard: int = 0) -> P1ShardData:
        """Accept a P1ShardData (traced path), a BoundaryCondition (static
        path), or None (default all-Dirichlet BC)."""
        if isinstance(sd_or_bc, P1ShardData):
            return sd_or_bc
        bc = sd_or_bc or BoundaryCondition.all_dirichlet()
        return self.shard_data(shard, bc)

    def shard_data(self, shard: int, bc: BoundaryCondition) -> P1ShardData:
        key = (shard, bc)
        if key not in self._sd_cache:
            m = self.maps
            self._sd_cache[key] = P1ShardData(
                slot_flat=jnp.asarray(m.slot_flat[shard]),
                slot_gid=jnp.asarray(m.slot_gid[shard]),
                slot_rep=jnp.asarray(self.slot_rep_mask[shard]),
                slot_inv_mult=jnp.asarray(
                    self.slot_inv_mult[shard], dtype=self.dtype
                ),
                slot_doftype=jnp.asarray(self.slot_doftype_np(bc)[shard]),
                cell_valid=jnp.asarray(self.cell_valid(shard)),
                cell_vertices=jnp.asarray(self.cell_vertices(shard)),
                bc=bc,
            )
        return self._sd_cache[key]

    def global_shard_data(self, bc: BoundaryCondition) -> P1ShardData:
        """Single-device view of the WHOLE multi-shard storage: slot maps
        re-based onto the all-gathered (C_total, N...) block. This is the
        agglomeration analog (reference: AgglomerationWrapper.hpp:75) — the
        coarse level is gathered and solved redundantly on every device,
        instead of on a rank subset (the gather is one collective, and the
        solve itself needs no communication).
        """
        key = ("global", bc)
        if key not in self._sd_cache:
            m = self.maps
            D = m.slot_flat.shape[0]
            blk = self.block_size
            pad = m.slot_gid == m.num_ifc
            flat = m.slot_flat.astype(np.int64) + (
                np.arange(D, dtype=np.int64)[:, None] * blk)
            flat[pad] = D * blk  # global OOB
            self._sd_cache[key] = P1ShardData(
                slot_flat=jnp.asarray(flat.reshape(-1), dtype=jnp.int32),
                slot_gid=jnp.asarray(m.slot_gid.reshape(-1)),
                slot_rep=jnp.asarray(self.slot_rep_mask.reshape(-1)),
                slot_inv_mult=jnp.asarray(
                    self.slot_inv_mult.reshape(-1), dtype=self.dtype),
                slot_doftype=jnp.asarray(
                    self.slot_doftype_np(bc).reshape(-1)),
                cell_valid=jnp.asarray(self.storage.cell_valid),
                cell_vertices=jnp.asarray(self.storage.cell_vertices,
                                          dtype=self.dtype),
                bc=bc,
            )
        return self._sd_cache[key]

    @functools.cached_property
    def _nbr_tables(self):
        """Neighbor-wise exchange tables (host precompute, per level).

        Returns (slot_lid (D, S), L_max, pack (D, R, M), recv (D, R, M),
        perms) where perms[r] is the ppermute pair list of round r (one
        partial matching of the neighbor graph per round, greedy edge
        coloring).  Pack/recv entries are LOCAL-gid ids; L_max is the
        dump bucket for padding."""
        from collections import defaultdict

        m = self.maps
        D, S = m.slot_gid.shape
        slot_lid = np.full((D, S), 0, dtype=np.int64)
        loc_gids = []
        for d in range(D):
            gids = np.asarray(m.slot_gid[d])
            valid = gids < m.num_ifc
            uniq, inv = np.unique(gids[valid], return_inverse=True)
            loc_gids.append(uniq)
            lid = np.full(S, -1, dtype=np.int64)
            lid[valid] = inv
            slot_lid[d] = lid
        L_max = max((len(u) for u in loc_gids), default=0)
        slot_lid[slot_lid < 0] = L_max  # dump bucket

        sharers = defaultdict(list)
        for d in range(D):
            for g in loc_gids[d]:
                sharers[int(g)].append(d)
        pair_g = defaultdict(list)
        for g, devs in sharers.items():
            for i in range(len(devs)):
                for j in range(i + 1, len(devs)):
                    pair_g[(devs[i], devs[j])].append(g)

        colors = {}
        used = defaultdict(set)
        for e in sorted(pair_g):
            c = 0
            while c in used[e[0]] or c in used[e[1]]:
                c += 1
            colors[e] = c
            used[e[0]].add(c)
            used[e[1]].add(c)
        R = (max(colors.values()) + 1) if colors else 0
        M = max((len(v) for v in pair_g.values()), default=1)
        pack = np.full((D, max(R, 1), M), L_max, dtype=np.int64)
        recv = np.full((D, max(R, 1), M), L_max, dtype=np.int64)
        perms: list[list] = [[] for _ in range(max(R, 1))]
        g2l = [{int(g): i for i, g in enumerate(loc_gids[d])}
               for d in range(D)]
        for (d, e), gs in pair_g.items():
            c = colors[(d, e)]
            for k, g in enumerate(sorted(gs)):
                pack[d, c, k] = g2l[d][g]
                pack[e, c, k] = g2l[e][g]
                recv[d, c, k] = g2l[d][g]
                recv[e, c, k] = g2l[e][g]
            perms[c] += [(d, e), (e, d)]
        return (slot_lid.astype(np.int32), int(L_max),
                pack.astype(np.int32), recv.astype(np.int32),
                tuple(tuple(sorted(p)) for p in perms))

    @functools.cached_property
    def _ovl_tables(self):
        """Interface/interior cell split for comm/compute overlap.

        Per device: a permutation of local cells putting every cell
        incident to a cross-device interface node first, plus slot
        tables restricted to those cells so the neighbor exchange can
        start from the phase-A (interface) partial apply alone.  All
        local contributions to a cross-device node come from interface
        cells by construction, so the packed buffers are complete
        before the interior sweep runs (reference:
        BufferedCommunication.hpp:92-100 start/end split)."""
        from collections import defaultdict

        m = self.maps
        D, S = m.slot_gid.shape
        slot_lid, L_max, _, _, _ = self._nbr_tables
        C_loc = self.C_loc
        cell_sz = self.block_size // C_loc

        # cross-device gids: shared by >= 2 devices
        sharers = defaultdict(set)
        for d in range(D):
            gids = np.asarray(m.slot_gid[d])
            for g in np.unique(gids[gids < m.num_ifc]):
                sharers[int(g)].add(d)
        cross = {g for g, devs in sharers.items() if len(devs) >= 2}

        flat = np.asarray(m.slot_flat)
        gid = np.asarray(m.slot_gid)
        is_cross = np.isin(gid, np.fromiter(cross, dtype=np.int64)
                           if cross else np.empty(0, np.int64))
        valid = gid < m.num_ifc
        ovl_cells = np.zeros((D, C_loc), dtype=np.int32)
        inv = np.zeros((D, C_loc), dtype=np.int64)
        kd = np.zeros(D, dtype=np.int64)
        for d in range(D):
            cs = np.unique(flat[d][is_cross[d] & valid[d]] // cell_sz)
            rest = np.setdiff1d(np.arange(C_loc), cs)
            order = np.concatenate([cs, rest]).astype(np.int32)
            ovl_cells[d] = order
            inv[d, order] = np.arange(C_loc)
            kd[d] = len(cs)
        K = int(max(kd.max(), 1))

        ovl_flat = np.full((D, S), K * cell_sz, dtype=np.int64)
        ovl_lid = np.full((D, S), L_max, dtype=np.int64)
        for d in range(D):
            sel = is_cross[d] & valid[d]
            c = flat[d][sel] // cell_sz
            o = flat[d][sel] % cell_sz
            ovl_flat[d, sel] = inv[d, c] * cell_sz + o
            ovl_lid[d, sel] = slot_lid[d][sel]
        return (ovl_cells, ovl_flat.astype(np.int32),
                ovl_lid.astype(np.int32), K)

    def stacked_shard_data(self, bc: BoundaryCondition,
                           neighbor: bool = True):
        """All-shard (D, ...) numpy pytree for feeding shard_map.

        ``neighbor=True`` attaches the pack-list tables so exchanges run
        neighbor-wise (ppermute, O(local interface)) instead of through
        the global psum fallback."""
        m = self.maps
        nbr = {}
        if neighbor and self.storage.num_shards > 1:
            slot_lid, L_max, pack, recv, perms = self._nbr_tables
            ovl_cells, ovl_flat, ovl_lid, K = self._ovl_tables
            nbr = dict(nbr_slot_lid=slot_lid, nbr_pack=pack, nbr_recv=recv,
                       nbr_num_local=L_max, nbr_perms=perms,
                       ovl_cells=ovl_cells, ovl_slot_flat=ovl_flat,
                       ovl_slot_lid=ovl_lid, ovl_k=K)
        return P1ShardData(
            slot_flat=np.asarray(m.slot_flat),
            slot_gid=np.asarray(m.slot_gid),
            slot_rep=np.asarray(self.slot_rep_mask),
            slot_inv_mult=np.asarray(self.slot_inv_mult, dtype=np.float32),
            slot_doftype=np.asarray(self.slot_doftype_np(bc)),
            cell_valid=self.storage.cell_valid.reshape(
                self.storage.num_shards, self.C_loc
            ),
            cell_vertices=self.storage.cell_vertices.reshape(
                self.storage.num_shards, self.C_loc, self.dim + 1, 3
            ).astype(np.float32),
            bc=bc,
            **nbr,
        )

    # -- exchanges (the halo-communication analog) ---------------------------

    def _exchange_nbr(self, u, sd: P1ShardData, axis_name, vals) -> jnp.ndarray:
        """Neighbor-wise additive exchange: local segment-sum, then one
        ppermute per edge-coloring round with per-pair pack lists —
        per-apply comm volume O(local interface), independent of the
        global interface size (reference: PackInfo.hpp:43-183,
        BufferedCommunication.hpp:92-119)."""
        flat = u.reshape(-1)
        L = sd.nbr_num_local
        lsum0 = jax.ops.segment_sum(vals, sd.nbr_slot_lid,
                                    num_segments=L + 1)
        lsum0 = lsum0.at[L].set(0.0)  # dump bucket collects padded slots
        acc = lsum0
        for r, perm in enumerate(sd.nbr_perms):
            if not perm:
                continue
            buf = lsum0[sd.nbr_pack[r]]
            rv = jax.lax.ppermute(buf, axis_name, perm)
            acc = acc.at[sd.nbr_recv[r]].add(rv)
        flat = flat.at[sd.slot_flat].set(acc[sd.nbr_slot_lid], mode="drop")
        return flat.reshape(u.shape)

    def _exchange_nbr_start(self, y_ifc, sd: P1ShardData,
                            axis_name) -> jnp.ndarray:
        """Start the additive exchange from the phase-A (interface-cell)
        partial apply: pack complete cross-device local sums and run the
        ppermute rounds.  Returns the received accumulator (L+1,); the
        interior sweep is data-independent of it, so XLA's scheduler can
        overlap the collectives with the interior compute."""
        flat = y_ifc.reshape(-1)
        L = sd.nbr_num_local
        vals = flat[jnp.minimum(sd.ovl_slot_flat, flat.shape[0] - 1)]
        lsum = jax.ops.segment_sum(vals, sd.ovl_slot_lid,
                                   num_segments=L + 1)
        lsum = lsum.at[L].set(0.0)
        acc_recv = jnp.zeros_like(lsum)
        for r, perm in enumerate(sd.nbr_perms):
            if not perm:
                continue
            buf = lsum[sd.nbr_pack[r]]
            rv = jax.lax.ppermute(buf, axis_name, perm)
            acc_recv = acc_recv.at[sd.nbr_recv[r]].add(rv)
        return acc_recv

    def _exchange_nbr_finish(self, u, acc_recv, sd: P1ShardData) -> jnp.ndarray:
        """Finish: full local sums + the received cross-device partials,
        scattered back to every replica slot."""
        flat = u.reshape(-1)
        L = sd.nbr_num_local
        vals = flat[jnp.minimum(sd.slot_flat, flat.shape[0] - 1)]
        lsum = jax.ops.segment_sum(vals, sd.nbr_slot_lid,
                                   num_segments=L + 1)
        acc = lsum + acc_recv
        acc = acc.at[L].set(0.0)
        flat = flat.at[sd.slot_flat].set(acc[sd.nbr_slot_lid], mode="drop")
        return flat.reshape(u.shape)

    def exchange_add(self, u, sd=None, axis_name=None) -> jnp.ndarray:
        """Replicas <- sum over replicas (additive halo exchange)."""
        sd = self.resolve_sd(sd)
        if self._dense_ok(sd, axis_name):
            return self.dense_ifc.exchange_add(u)
        flat = u.reshape(-1)
        vals = flat[jnp.minimum(sd.slot_flat, flat.shape[0] - 1)]
        if axis_name is not None and sd.nbr_pack is not None:
            return self._exchange_nbr(u, sd, axis_name, vals)
        g = jax.ops.segment_sum(
            vals, sd.slot_gid, num_segments=self.maps.num_ifc + 1
        )
        if axis_name is not None:
            g = jax.lax.psum(g, axis_name)
        flat = flat.at[sd.slot_flat].set(g[sd.slot_gid], mode="drop")
        return flat.reshape(u.shape)

    def exchange_rep(self, u, sd=None, axis_name=None) -> jnp.ndarray:
        """Replicas <- representative's value (consistency sync)."""
        sd = self.resolve_sd(sd)
        if self._dense_ok(sd, axis_name):
            return self.dense_ifc.exchange_rep(u)
        flat = u.reshape(-1)
        vals = flat[jnp.minimum(sd.slot_flat, flat.shape[0] - 1)]
        if axis_name is not None and sd.nbr_pack is not None:
            return self._exchange_nbr(u, sd, axis_name,
                                      jnp.where(sd.slot_rep, vals, 0))
        g = jax.ops.segment_sum(
            jnp.where(sd.slot_rep, vals, 0),
            sd.slot_gid,
            num_segments=self.maps.num_ifc + 1,
        )
        if axis_name is not None:
            g = jax.lax.psum(g, axis_name)
        flat = flat.at[sd.slot_flat].set(g[sd.slot_gid], mode="drop")
        return flat.reshape(u.shape)

    # -- reductions ----------------------------------------------------------

    def _interior_weight(self, sd: P1ShardData) -> jnp.ndarray:
        w = jnp.asarray(self.interior_mask, dtype=self.dtype)
        cv = sd.cell_valid.astype(self.dtype)
        return cv.reshape(-1, 1, 1) * w[None]

    def _slot_in_flag(self, sd: P1ShardData, flag: DoFType) -> jnp.ndarray:
        return (sd.slot_doftype & int(flag)) != 0

    def dot(self, u, v, flag: DoFType = DoFType.ALL, sd: P1ShardData | None = None,
            axis_name=None):
        """Global dot product counting every DoF once
        (reference: VertexDoFFunction::dotGlobal)."""
        sd = self.resolve_sd(sd)
        if self._dense_ok(sd, axis_name):
            acc = jnp.asarray(0.0, dtype=self.dtype)
            if flag & DoFType.INNER:
                acc = acc + jnp.sum(u * v * self._interior_weight(sd))
            return acc + self.dense_ifc.dot_ifc(u, v, flag, sd.bc)
        acc = jnp.asarray(0.0, dtype=self.dtype)
        if flag & DoFType.INNER:
            acc = acc + jnp.sum(u * v * self._interior_weight(sd))
        sel = sd.slot_rep & self._slot_in_flag(sd, flag)
        uf, vf = u.reshape(-1), v.reshape(-1)
        idx = jnp.minimum(sd.slot_flat, uf.shape[0] - 1)
        acc = acc + jnp.sum(jnp.where(sel, uf[idx] * vf[idx], 0))
        if axis_name is not None:
            acc = jax.lax.psum(acc, axis_name)
        return acc

    def dof_sum(self, u, flag: DoFType = DoFType.ALL, sd=None, axis_name=None):
        return self.dot(u, jnp.ones_like(u), flag, sd, axis_name)

    def unique_weight(self, sd=None) -> jnp.ndarray:
        """(C, N...) weights so that sum(w * u) counts every global DoF once
        (interior: 1; interface replicas: 1/multiplicity; padding: 0).
        Used by histogram-style reductions (e.g. radial profiles)."""
        sd = self.resolve_sd(sd)
        w = self._interior_weight(sd).reshape(-1)
        w = w.at[sd.slot_flat].set(sd.slot_inv_mult, mode="drop")
        return w.reshape(self.block_shape)

    def dof_max(self, u, flag: DoFType = DoFType.ALL, sd=None, axis_name=None):
        sd = self.resolve_sd(sd)
        neg = jnp.asarray(-jnp.inf, dtype=u.dtype)
        acc = neg
        if flag & DoFType.INNER:
            w = self._interior_weight(sd) > 0
            acc = jnp.max(jnp.where(w, u, neg))
        sel = sd.slot_rep & self._slot_in_flag(sd, flag)
        uf = u.reshape(-1)
        idx = jnp.minimum(sd.slot_flat, uf.shape[0] - 1)
        acc = jnp.maximum(acc, jnp.max(jnp.where(sel, uf[idx], neg)))
        if axis_name is not None:
            acc = jax.lax.pmax(acc, axis_name)
        return acc

    # -- row-restricted updates ---------------------------------------------

    def restore_rows(self, new, old, flag: DoFType, sd=None) -> jnp.ndarray:
        """Keep ``new`` on rows whose DoFType is in ``flag``; restore ``old``
        elsewhere. Interior rows are INNER; interface rows use slot maps."""
        sd = self.resolve_sd(sd)
        if flag == DoFType.ALL:
            return new
        if self._dense_ok(sd, None):
            base = new if (flag & DoFType.INNER) else old
            return self.dense_ifc.restore_rows(base, new, old, flag, sd.bc)
        sel = self._slot_in_flag(sd, flag)
        newf, oldf = new.reshape(-1), old.reshape(-1)
        idx = jnp.minimum(sd.slot_flat, newf.shape[0] - 1)
        vals = jnp.where(sel, newf[idx], oldf[idx])
        out = new if (flag & DoFType.INNER) else old
        outf = out.reshape(-1).at[sd.slot_flat].set(vals, mode="drop")
        return outf.reshape(new.shape)

    # -- interpolation -------------------------------------------------------

    @functools.cached_property
    def _ref_coords(self) -> np.ndarray:
        """(N, lanes, dim) reference coordinates (barycentric index / n);
        zeros on 3D padding lanes (so expressions evaluate at v0 there —
        finite garbage, masked by vertex_mask downstream)."""
        axes = [np.arange(self.N)] * self.dim
        grids = np.meshgrid(*axes, indexing="ij")
        ref = np.stack(grids, axis=-1) / self.n
        if self.dim == 3:
            from ..indexing import flat
            ref = flat.flatten_field(ref, self.pitch, ncomp=1)
        return ref

    def coords_from(self, cell_vertices) -> jnp.ndarray:
        """(C, N, lanes, 3) physical coordinates of every micro-vertex."""
        verts = cell_vertices
        v0 = verts[:, 0]
        J = verts[:, 1:] - verts[:, :1]  # (C, dim, 3)
        ref = jnp.asarray(self._ref_coords, dtype=self.dtype)
        return v0.reshape(-1, 1, 1, 3) + jnp.einsum("xld,cde->cxle", ref, J)

    def coords(self, shard: int = 0) -> jnp.ndarray:
        return self.coords_from(jnp.asarray(self.cell_vertices(shard)))

    def interpolate(self, expr, old, flag: DoFType, sd=None,
                    axis_name=None) -> jnp.ndarray:
        """Evaluate ``expr`` (constant or callable of coords (..., 3)) on rows
        in ``flag``; replicas are forced consistent via the representative."""
        sd = self.resolve_sd(sd)
        if callable(expr):
            vals = expr(self.coords_from(sd.cell_vertices))
            vals = jnp.asarray(vals, dtype=self.dtype)
            # replicas may differ in the last ulp (each cell evaluates at its
            # own affine image of the point) -> force owner's value. This is
            # only correct when every replica of a DoF is visible: single
            # shard, or inside shard_map (axis_name set). A lone shard of a
            # multi-shard storage must NOT rep-sync — gids whose representative
            # lives on another shard would read a zero segment-sum and zero
            # out the local replicas.
            if axis_name is not None or self.storage.num_shards == 1:
                vals = self.exchange_rep(vals, sd, axis_name)
        else:
            vals = jnp.full(self.block_shape, expr, dtype=self.dtype)
        vals = vals * jnp.asarray(self.vertex_mask[None], dtype=self.dtype)
        if flag == DoFType.ALL:
            return vals
        return self.restore_rows(vals, old, flag, sd)

    def zeros(self) -> jnp.ndarray:
        return jnp.zeros(self.block_shape, dtype=self.dtype)

    def function(self, bc: BoundaryCondition | None = None) -> P1Function:
        return P1Function(self.zeros(), self, bc or BoundaryCondition.all_dirichlet())

    # -- global enumeration (reference: VertexDoFFunction::enumerate) --------

    @functools.cached_property
    def _interior_pack(self) -> np.ndarray:
        """(N...,) int64: lexicographic index among cell-interior positions,
        -1 elsewhere."""
        imask = self.interior_mask
        pack = np.full(imask.shape, -1, dtype=np.int64)
        pack[imask] = np.arange(int(imask.sum()))
        return pack

    def global_ids_grid(self, shard: int = 0) -> np.ndarray:
        """(C, N, N, N) / (C, N, N) grid view of global_ids for spatial
        (x, y, z) indexing (host-side; sparse assembly, tests)."""
        g = self.global_ids(shard)
        if self.dim == 2:
            return g
        from ..indexing import flat

        return flat.unflatten_field(g, self.N, self.pitch)

    def global_ids(self, shard: int = 0) -> np.ndarray:
        """(C, N, lanes) int64 global DoF id per position in the canonical
        flat block layout; -1 outside the macro-simplex and on padding
        cells. Host-side (numpy); used for sparse assembly (toMatrix
        analog) and equivalence tests."""
        m = self.maps
        out = np.full(self.block_shape, -1, dtype=np.int64)
        flat = out.reshape(-1)
        sf, sg = m.slot_flat[shard], m.slot_gid[shard]
        ok = (sf < flat.shape[0]) & (sg < m.num_ifc)
        flat[sf[ok]] = sg[ok]
        lo = shard * self.C_loc
        interior = m.num_interior_per_cell
        pack = self._interior_pack
        for c in range(self.C_loc):
            if not self.storage.cell_valid[lo + c]:
                out[c] = -1
                continue
            gci = self.storage.cell_global_index[lo + c]
            sel = pack >= 0
            out[c][sel] = m.num_ifc + gci * interior + pack[sel]
        return out
