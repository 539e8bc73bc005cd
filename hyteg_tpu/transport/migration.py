"""Cross-shard particle migration (SyncNextNeighbors analog).

Reference: src/convection_particles/mpi/SyncNextNeighbors.{h,cpp} —
particles that left their rank's subdomain are packed per neighbor rank
and exchanged p2p.  The protocol here is collective and
fixed-shape: each shard packs its emigrants into one (D, M) slot matrix
ordered by destination shard and a single ``all_to_all`` over the mesh
axis delivers them; arrivals are compacted into inactive local slots.
Slot capacities are static (jit-friendly); an overflow counter reports
dropped particles instead of silently resizing (the caller picks M).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .particles import ParticleSet


def _pack_by_dest(ps: ParticleSet, dest: jnp.ndarray, D: int, M: int):
    """Build (D, M, ...) send slots: row d holds the first M active
    particles with dest == d (inactive padding elsewhere).  Returns
    (slots pytree, stay_mask, overflow_count)."""
    P = ps.capacity
    leaving = ps.active & (dest >= 0)

    # rank of each particle within its destination bucket
    onehot = (dest[None, :] == jnp.arange(D)[:, None]) & leaving[None, :]
    rank = jnp.cumsum(onehot, axis=1) - 1          # (D, P)
    keep = onehot & (rank < M)
    overflow = jnp.sum(onehot & (rank >= M))
    # scatter particle indices into slots
    slot_idx = jnp.where(keep, rank, M)            # (D, P), M = dump
    src = jnp.broadcast_to(jnp.arange(P)[None, :], (D, P))
    idx = jnp.full((D, M + 1), P, dtype=jnp.int32)  # P = "no particle"
    idx = idx.at[jnp.arange(D)[:, None], slot_idx].set(
        jnp.where(keep, src, P), mode="drop")
    idx = idx[:, :M]                               # (D, M)
    valid = idx < P
    gidx = jnp.minimum(idx, P - 1)

    def gather(col):
        g = col[gidx]
        shape = (D, M) + (1,) * (col.ndim - 1)
        return jnp.where(valid.reshape(shape), g, 0)

    slots = jax.tree.map(gather, ps)
    slots = dataclasses.replace(slots, active=valid)
    stay = ps.active & ~leaving
    return slots, stay, overflow


def migrate(ps: ParticleSet, owner_shard: jnp.ndarray, axis_name: str,
            D: int, M: int | None = None):
    """Exchange particles between shards (call inside shard_map).

    owner_shard: (P,) destination shard of each particle (from the owner
    lookup); particles owned locally keep their slot.  Returns the
    updated local set and the number of particles dropped to slot
    overflow (0 in healthy runs)."""
    M = M or max(1, ps.capacity // max(1, D))
    me = jax.lax.axis_index(axis_name)
    dest = jnp.where(ps.active & (owner_shard != me), owner_shard, -1)
    slots, stay, overflow = _pack_by_dest(ps, dest, D, M)

    # row d of the send slots goes to shard d; row j of the result came
    # from shard j
    recv = jax.tree.map(
        lambda a: jax.lax.all_to_all(a, axis_name, split_axis=0,
                                     concat_axis=0).reshape(
            (D * M,) + a.shape[2:]),
        slots)

    # compact arrivals into inactive local slots
    stay_set = dataclasses.replace(ps, active=stay)
    free_rank = jnp.cumsum(~stay) - 1              # rank among free slots
    arr_rank = jnp.cumsum(recv.active) - 1         # rank among arrivals
    P = ps.capacity
    # free slot index for each arrival rank
    free_idx = jnp.full((P + 1,), P, dtype=jnp.int32)
    free_idx = free_idx.at[jnp.where(~stay, free_rank, P)].set(
        jnp.arange(P), mode="drop")
    # ranks beyond P land on the sentinel slot P (counted as lost below);
    # clamping to P-1 would silently overwrite the last free slot when
    # more particles arrive than the local set has capacity for
    tgt = jnp.where(recv.active,
                    free_idx[jnp.minimum(arr_rank, P)], P)  # (D*M,)
    lost = jnp.sum(recv.active & (tgt >= P))

    def place(local_col, recv_col):
        return local_col.at[tgt].set(recv_col, mode="drop")

    merged = jax.tree.map(place, stay_set, recv)
    act = stay.at[tgt].set(recv.active, mode="drop")
    merged = dataclasses.replace(merged, active=act)
    return merged, overflow + lost
