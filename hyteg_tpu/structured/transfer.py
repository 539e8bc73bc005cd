"""Grid transfers between nested BoxDomain levels.

FE-correct P1 transfers on the Kuhn-subdivided box grid (reference:
src/hyteg/gridtransferoperators/P1toP1LinearProlongation.hpp /
P1toP1LinearRestriction.hpp): a fine node of parity d in {0,1}^3 \\ {0}
is the midpoint of the coarse Kuhn-mesh EDGE in direction d (monotone
diagonals only — NOT trilinear interpolation). Both directions share one
15-direction stencil S with weight 1 at the center and 1/2 on the 14
monotone dirs:

    R = P^T:  r_c = decimate(S r_f)          (sample even positions)
    P:        u_f = S expand(u_c)            (zero-interleave then S)

Decimation/expansion run as one-hot band-matrix einsums over the two
minor axes (exact: HIGHEST-precision selection) plus a cheap major-axis
slice/interleave, which avoids strided ``[::2]`` slicing on the minor
axes; the 15-shift stencil is a pad/slice/add chain XLA fuses into one
pass.
"""

from __future__ import annotations

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np

from .box import BoxDomain

_DIRS14 = [d for d in itertools.product((-1, 0, 1), repeat=3)
           if d != (0, 0, 0) and (all(v >= 0 for v in d)
                                  or all(v <= 0 for v in d))]


def _to3(u, dims):
    X, Y, Z = dims
    return u.reshape(X, Y, Z)


def _to2(u3):
    X, Y, Z = u3.shape
    return u3.reshape(X, Y * Z)


def _shift3(u3, d):
    """out[p] = u3[p + d], zero-filled (3D)."""
    for ax, dv in enumerate(d):
        if dv == 0:
            continue
        pad_shape = list(u3.shape)
        pad_shape[ax] = abs(dv)
        z = jnp.zeros(pad_shape, u3.dtype)
        sl = [slice(None)] * 3
        if dv > 0:
            sl[ax] = slice(dv, None)
            u3 = jnp.concatenate([u3[tuple(sl)], z], axis=ax)
        else:
            sl[ax] = slice(0, dv)
            u3 = jnp.concatenate([z, u3[tuple(sl)]], axis=ax)
    return u3


def _stencil15(u3):
    """S u: center weight 1 + 1/2 on the 14 monotone directions."""
    acc = u3
    for d in _DIRS14:
        acc = acc + 0.5 * _shift3(u3, d)
    return acc


@functools.lru_cache(maxsize=None)
def _even_onehot(n_fine: int, n_coarse: int) -> np.ndarray:
    """(n_fine, n_coarse) one-hot: column v selects fine index 2v."""
    oh = np.zeros((n_fine, n_coarse), dtype=np.float32)
    oh[2 * np.arange(n_coarse), np.arange(n_coarse)] = 1.0
    return oh


_HI = jax.lax.Precision.HIGHEST


def _decimate(s3, coarse_dims):
    """(Xf, Yf, Zf) -> (Xc, Yc, Zc): even-position sampling."""
    Xc, Yc, Zc = coarse_dims
    s3 = s3[::2]  # major axis: contiguous block selection
    Dy = jnp.asarray(_even_onehot(s3.shape[1], Yc))
    Dz = jnp.asarray(_even_onehot(s3.shape[2], Zc))
    s3 = jnp.einsum("xyz,yv->xvz", s3, Dy, precision=_HI)
    return jnp.einsum("xvz,zw->xvw", s3, Dz, precision=_HI)


def _expand(u3, fine_dims):
    """(Xc, Yc, Zc) -> (Xf, Yf, Zf): values at even positions, 0 else."""
    Xf, Yf, Zf = fine_dims
    Xc, Yc, Zc = u3.shape
    # x: interleave with zero rows, then trim to Xf
    st = jnp.stack([u3, jnp.zeros_like(u3)], axis=1)
    e = st.reshape(2 * Xc, Yc, Zc)[:Xf]
    Ey = jnp.asarray(_even_onehot(Yf, Yc))
    Ez = jnp.asarray(_even_onehot(Zf, Zc))
    e = jnp.einsum("xvz,yv->xyz", e, Ey, precision=_HI)
    return jnp.einsum("xyw,zw->xyz", e, Ez, precision=_HI)


def prolongate(u_c: jnp.ndarray, coarse: BoxDomain, fine: BoxDomain):
    """Linear P1 prolongation, (X_c, L_c) -> (X_f, L_f)."""
    e = _expand(_to3(u_c, coarse.dims), fine.dims)
    return _to2(_stencil15(e))


def restrict(r_f: jnp.ndarray, fine: BoxDomain, coarse: BoxDomain):
    """P^T residual restriction, (X_f, L_f) -> (X_c, L_c)."""
    s = _stencil15(_to3(r_f, fine.dims))
    return _to2(_decimate(s, coarse.dims))
