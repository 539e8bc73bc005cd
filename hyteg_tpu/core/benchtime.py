"""Robust on-device timing for benchmarks.

Per-call wall-clock timing of an asynchronously dispatched op measures
dispatch and host round-trip latency as much as kernel time, and a small
kernel takes less time than either.  The robust methodology is the
reference's (repeated apply inside the timed region, reference:
apps/benchmarks/ApplyBenchmark/ApplyBenchmark.cpp:95-104) done the XLA
way:

  * run the op chained L times inside ONE jitted ``lax.scan``,
  * force completion by fetching a result-dependent scalar to the host,
  * measure at two lengths L1 < L2 and report the MARGINAL time per
    iteration ((t2 - t1)/(L2 - L1) removes fetch latency, dispatch cost
    and any loop-invariant prologue),
  * size L2 so the marginal window is much longer than the host's timing
    jitter; chains too short for that give non-positive marginal times.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp


def _chain(step: Callable, length: int, unroll: bool = False):
    """jit(x -> scalar) running ``step`` ``length`` times, chained.

    scan-based by default: compile time is O(1) in length (an unrolled
    1000-chain is not compilable)."""

    def run(x):
        if unroll:
            y = x
            for _ in range(length):
                y = step(y)
        else:
            y, _ = jax.lax.scan(lambda c, _: (step(c), None), x, None,
                                length=length)
        leaves = jax.tree_util.tree_leaves(y)
        return sum(jnp.sum(l) for l in leaves)

    return jax.jit(run)


def _best_time(fn, x, repeats: int) -> float:
    float(fn(x))  # warm / compile
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(fn(x))  # scalar fetch = true completion barrier
        best = min(best, time.perf_counter() - t0)
    return best


def marginal_time(step: Callable, x, l1: int = 8, l2: int = 32,
                  repeats: int = 3) -> float:
    """Marginal seconds per application of ``step`` (pytree -> pytree of the
    same structure), measured as (t(l2) - t(l1)) / (l2 - l1)."""
    t1 = _best_time(_chain(step, l1), x, repeats)
    t2 = _best_time(_chain(step, l2), x, repeats)
    return max((t2 - t1) / (l2 - l1), 1e-12)


def eager_marginal_time(step: Callable, x, k1: int = 3, k2: int = 12,
                        repeats: int = 3) -> float:
    """Marginal time per step for EXPENSIVE jitted steps (much longer
    than the dispatch cost, e.g. whole V-cycles): launch k eager
    iterations (async dispatch queues them), block once at the end, and
    take the marginal between two counts. Avoids compiling scan-wrapped
    chains of an already slow-to-compile program."""
    jstep = jax.jit(step)

    def run(k):
        y = x
        for _ in range(k):
            y = jstep(y)
        jax.tree_util.tree_leaves(y)[0].block_until_ready()

    run(1)  # compile
    best1 = best2 = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(k1)
        best1 = min(best1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        run(k2)
        best2 = min(best2, time.perf_counter() - t0)
    return (best2 - best1) / (k2 - k1)


def auto_time(step: Callable, x, repeats: int = 3,
              min_window_s: float = 0.25, max_len: int = 4096) -> float:
    """Marginal time with the chain length sized so the marginal window
    (t(l2) - t(l1)) is >= min_window_s — large against the host's timing
    jitter.  Two compiles total."""
    l1 = 16
    t1 = _best_time(_chain(step, l1), x, repeats)
    # estimate per-step cost from the first chain alone (includes the
    # dispatch floor, so it over-estimates => l2 errs small; the window check
    # below retries once with the measured marginal if needed)
    est = t1 / l1
    l2 = min(max_len, l1 + max(64, int(min_window_s / max(est, 1e-9))))
    t2 = _best_time(_chain(step, l2), x, repeats)
    if (t2 - t1) < 0.3 * min_window_s and l2 < max_len:
        marg = max((t2 - t1) / (l2 - l1), 1e-9)
        l3 = min(max_len, l1 + int(min_window_s / marg) + 1)
        if l3 > l2:
            t2, l2 = _best_time(_chain(step, l3), x, repeats), l3
    return (t2 - t1) / (l2 - l1)
