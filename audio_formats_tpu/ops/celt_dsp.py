"""Device DSP for CELT synthesis (SURVEY.md §2: dopus row — "device: CELT
denormalize + IMDCT + OLA + deemphasis scan").

The IMDCT half-transform is a dense [blocksize, blocksize] matmul (the
basis is the closed form of the reference's pre-twiddle + DFT +
post-twiddle, models/celt.py:imdct_half), window overlap-add is unrolled
over the (static) block count, and deemphasis is a first-order linear
recurrence evaluated with an associative scan.  The pitch postfilter is
data-dependent IIR with per-stream lags and stays on the host
(models/celt.py:_postfilter); it sits between OLA and deemphasis, so the
batch path runs device IMDCT/OLA -> host postfilter -> device-or-host
deemphasis.

All tensors carry a leading [B] stream axis for the lockstep batch
scheduler.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models.celt import DEEMPH_COEFF, OVERLAP, imdct_half
from ..utils.tables import celt_tables as CT

_BASIS_CACHE = {}


def imdct_basis(blocksize: int) -> np.ndarray:
    """Real [blocksize, blocksize] matrix M with half = X @ M.T, equal to
    the reference IMDCT half transform (middle half of the 2N-point
    IMDCT)."""
    if blocksize not in _BASIS_CACHE:
        M = np.zeros((blocksize, blocksize), np.float32)
        for k in range(blocksize):
            e = np.zeros(blocksize)
            e[k] = 1.0
            M[:, k] = imdct_half(e, blocksize, 1.0)
        _BASIS_CACHE[blocksize] = M
    return _BASIS_CACHE[blocksize]


@functools.partial(jax.jit, static_argnames=("blocks", "blocksize"))
def celt_imdct_ola(coeffs, tail, blocks: int, blocksize: int, scale=1.0):
    """Batched CELT IMDCT + windowed overlap-add.

    coeffs: [B, frame] denormalized spectrum (frame = blocks*blocksize,
            short blocks interleaved as the bitstream defines)
    tail:   [B, OVERLAP//2] raw un-windowed tail carried from the previous
            frame
    Returns (out [B, frame] pre-postfilter samples, new_tail
    [B, OVERLAP//2]).
    """
    B = coeffs.shape[0]
    frame = blocks * blocksize
    M = jnp.asarray(imdct_basis(blocksize))
    w = jnp.asarray(CT.WINDOW.astype(np.float32))
    half_w = OVERLAP // 2

    # all blocks' IMDCTs in one matmul: X [B, blocks, blocksize]
    X = coeffs.reshape(B, blocksize, blocks).transpose(0, 2, 1) \
        if blocks > 1 else coeffs.reshape(B, 1, blocksize)
    halves = jnp.einsum("bjk,mk->bjm", X * scale, M,
                        precision=jax.lax.Precision.HIGHEST)

    buf = jnp.zeros((B, frame + half_w + blocksize), coeffs.dtype)
    buf = buf.at[:, :half_w].set(tail)
    for j in range(blocks):
        dst = j * blocksize
        buf = jax.lax.dynamic_update_slice(
            buf, halves[:, j], (0, dst + half_w))
        u = jnp.arange(half_w)
        b0 = buf[:, dst : dst + half_w]
        b1 = buf[:, dst + half_w : dst + OVERLAP][:, ::-1]
        lo = b0 * w[OVERLAP - 1 - u] - b1 * w[u]
        hi = (b0 * w[u] + b1 * w[OVERLAP - 1 - u])[:, ::-1]
        buf = buf.at[:, dst : dst + half_w].set(lo)
        buf = buf.at[:, dst + half_w : dst + OVERLAP].set(hi)
    return buf[:, :frame], buf[:, frame : frame + half_w]


@jax.jit
def deemphasis_scan(x, m0):
    """y[n] = x[n] + c*y[n-1] with y[-1]*c == m0 (the reference keeps the
    pre-multiplied memory, dopus.d:3696-3701): returns (y / 32768, new
    memory m = y[-1]*c).  x: [B, n], m0: [B]."""
    c = jnp.float32(DEEMPH_COEFF)
    # prefix of the linear recurrence y = x + c*y_prev via associative scan
    # on pairs (a, b): compose((a1,b1),(a2,b2)) = (a1*a2, b1*a2 + b2)
    B, n = x.shape
    a = jnp.full((B, n), c)
    b = x.astype(jnp.float32)

    def combine(l, r):
        return (l[0] * r[0], l[1] * r[0] + r[1])

    A, Y = jax.lax.associative_scan(combine, (a, b), axis=1)
    # Y[n] = sum x[k]*c^(n-k); add the carried memory term m0*c^n/c
    powc = A / c  # c^n for n>=... A[n] = c^(n+1)
    y = Y + m0[:, None] * powc
    m = y[:, -1] * c
    return y / jnp.float32(32768.0), m
