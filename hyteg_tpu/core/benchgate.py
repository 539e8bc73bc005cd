"""On-device correctness gates for benchmarks.

Round-3 lesson: a benchmark that only times can post 30 GDoF/s from a
wrong kernel or a diverging solver (the committed level-6 residual table
grew x2.11/cycle).  Every bench now proves correctness on the SAME
device/shapes it times, and refuses to print numbers otherwise
(reference analog: the ApplyBenchmark family is backed by the
operator-vs-PETSc apply tests, tests/hyteg/Petsc/P1PetscApplyTest.cpp).
"""

from __future__ import annotations

import numpy as np


class BenchGateError(RuntimeError):
    """A benchmark correctness gate failed; no numbers may be printed."""


def gate_close(a, b, what: str, rtol: float = 1e-5) -> None:
    """Assert two on-device results agree to f32 stencil tolerance."""
    a = np.asarray(a)
    b = np.asarray(b)
    denom = max(float(np.abs(a).max()), 1e-30)
    err = float(np.abs(a - b).max()) / denom
    if not np.isfinite(err) or err > rtol:
        raise BenchGateError(
            f"gate failed: {what}: rel err {err:.3e} > {rtol:.1e}")


def gate_box_apply(op, u) -> None:
    """Kernel-vs-XLA equivalence of the box stencil apply, on device at
    the exact benchmarked shapes: on a GPU ``apply_raw`` runs the Triton
    kernel (lane tiles, row chunks and clamped edge reads are all
    exercised), and ``_apply_xla`` is its independent reference."""
    gate_close(op.apply_raw(u), op._apply_xla(u),
               f"box apply kernel-vs-xla at {op.domain.block_shape}")


def gate_residuals(rns, what: str, max_rate: float = 0.5,
                   min_cycles: int = 3, floor_rel: float = 1e-6) -> None:
    """Assert a residual history converges over the WHOLE pre-floor
    window: monotone decrease and a mean reduction factor below
    ``max_rate`` until the residual reaches ``floor_rel`` of its start
    (the f32 round-off floor). A solver stalling above the floor after a
    few good cycles fails the gate (round-4 review: the old 3-cycle
    window would have let that through)."""
    rns = [float(r) for r in rns]
    if len(rns) < min_cycles + 1:
        raise BenchGateError(f"gate failed: {what}: too few cycles {rns}")
    if not all(np.isfinite(rns)):
        raise BenchGateError(f"gate failed: {what}: non-finite {rns}")
    floor = floor_rel * rns[0]
    end = len(rns) - 1
    for i, r in enumerate(rns):
        if r <= floor:
            end = i
            break
    end = max(end, min_cycles)
    window = rns[: end + 1]
    for a, b in zip(window, window[1:]):
        if b >= a and a > floor:
            raise BenchGateError(
                f"gate failed: {what}: residuals not decreasing before "
                f"the round-off floor {rns}")
    rate = (window[-1] / window[0]) ** (1.0 / (len(window) - 1))
    if rate > max_rate:
        raise BenchGateError(
            f"gate failed: {what}: mean rate {rate:.3f} > {max_rate}")


def gate_positive_time(dt: float, what: str) -> float:
    """Non-positive marginal times are a measurement failure, not a
    clamp-to-epsilon (round 3 committed a 0.0 ms -> 2.1e9 GDoF/s row)."""
    if not (dt > 0.0) or not np.isfinite(dt):
        raise BenchGateError(
            f"gate failed: {what}: non-positive marginal time {dt!r}; "
            "re-measure with longer chains (auto_time)")
    return dt
