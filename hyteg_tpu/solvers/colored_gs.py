"""Colored Gauss-Seidel / SOR smoothers.

Reference: the generated colored GS/SOR kernels of
src/constant_stencil_operator/ (forward/backward sweeps per micro-grid).
Sequential sweeps don't map to data-parallel hardware; the classic parallel
substitute is
multi-color GS: every P1 stencil direction has at least one odd component,
so the 8 parity classes (x%2, y%2, z%2) are an exact coloring — updating
one color at a time is a true Gauss-Seidel sweep with 8 residual applies.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..indexing import micro


@functools.lru_cache(maxsize=None)
def parity_masks(level: int, dim: int, pitch: int | None = None):
    """Tuple of 2^dim float32 masks over the flat (N, lanes) block."""
    N = (1 << level) + 1
    pitch = N if (pitch is None or dim == 2) else pitch
    grids = np.meshgrid(*([np.arange(N)] * dim), indexing="ij")
    vm = micro.vertex_mask(level, dim)
    out = []
    for color in range(2**dim):
        bits = [(color >> d) & 1 for d in range(dim)]
        m = vm.copy()
        for g, bit in zip(grids, bits):
            m = m & (g % 2 == bit)
        if dim == 3:
            from ..indexing import flat

            m = flat.flatten_field(m, pitch)
        out.append(np.asarray(m, dtype=np.float32))
    return tuple(out)


def colored_gs_smooth(
    apply_fn: Callable,
    inv_diag: jnp.ndarray,
    b: jnp.ndarray,
    x: jnp.ndarray,
    level: int,
    dim: int,
    omega: float = 1.0,
    backward: bool = False,
    num_sweeps: int = 1,
    pitch: int | None = None,
) -> jnp.ndarray:
    """Multi-color GS/SOR sweep: omega = 1 -> GS, else SOR
    (reference: smooth_gs / smooth_sor capability)."""
    masks = parity_masks(level, dim, pitch)
    order = list(reversed(range(len(masks)))) if backward else list(range(len(masks)))

    def sweep(x):
        for c in order:
            m = jnp.asarray(masks[c])[None]
            x = x + omega * m * inv_diag * (b - apply_fn(x))
        return x

    for _ in range(num_sweeps):
        x = sweep(x)
    return x


def symmetric_colored_gs_smooth(apply_fn, inv_diag, b, x, level, dim,
                                omega: float = 1.0, num_sweeps: int = 1,
                                pitch: int | None = None):
    """Forward + backward sweep (reference: SymmetricGaussSeidelSmoother)."""
    for _ in range(num_sweeps):
        x = colored_gs_smooth(apply_fn, inv_diag, b, x, level, dim, omega, False,
                              pitch=pitch)
        x = colored_gs_smooth(apply_fn, inv_diag, b, x, level, dim, omega, True,
                              pitch=pitch)
    return x
