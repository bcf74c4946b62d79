"""Device-resident Vorbis window pipeline: IMDCT + lapped overlap-add.

The reference defers windowing to ``vorbis_finish_frame``
(stb_vorbis2.d:2606-2640): each packet's raw IMDCT output is mixed with the
carried right-half of the previous window over the lap region, the finished
region [left_start, right_start) is returned, and [right_start, right_end)
is saved as the next lap.  The host facade does this per packet in numpy
(models/vorbis.py:_finish_packet); this module runs the SAME chain for a
whole lockstep group on device, so with ``output="device"`` decoded Vorbis
PCM never leaves the device (the natural sink of a decode pipeline — parity
with the MP3/FLAC/QOA device-resident paths).

Formulation (no gathers, no dynamic shapes):

* Both block sizes' IMDCTs run as dense matmuls over all K*L stacked
  lane-channel windows; the per-window block size picks between them with a
  select.  The short matmul is ≤ (bs0/bs1)^2 of the long one's FLOPs, so
  running both everywhere costs a few percent and keeps shapes static.
* The per-packet lap chain is a ``lax.scan`` over the window's K packet
  slots carrying (lap[L, bs1/2], lap_len[B], had_prev[B]) — the exact state
  the facade carries in ``self._prev``.
* Window slopes are NOT computed on device: Vorbis laps only ever have
  width bs0/2 or bs1/2, and left_start only takes the values
  {0, (bs1-bs0)/4}, so every (slope, reverse-slope, shift) combination is a
  precomputed constant row selected per lane — bitwise the same weights the
  host path uses (ops/mdct.vorbis_slope).
* Variable offsets (left_start, right_start) come from tiny static sets, so
  every "shift" is a select over statically-rolled copies — never a gather.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import mdct as mdct_ops


@functools.lru_cache(maxsize=None)
def _weight_tables(bs0: int, bs1: int):
    """Constant slope rows, padded to bs1 and pre-rolled by each possible
    left_start: returns f32 array [2 (lapw: bs0/2, bs1/2), 2 (ls: 0, c),
    2 (fwd, rev), bs1]."""
    c = (bs1 - bs0) // 4
    out = np.zeros((2, 2, 2, bs1), np.float32)
    for wi, lw in enumerate((bs0 // 2, bs1 // 2)):
        s = mdct_ops.vorbis_slope(lw)
        fwd = np.zeros(bs1, np.float32)
        rev = np.zeros(bs1, np.float32)
        fwd[:lw] = s
        rev[:lw] = s[::-1]
        for li, ls in enumerate((0, c)):
            out[wi, li, 0] = np.roll(fwd, ls)
            out[wi, li, 1] = np.roll(rev, ls)
    return out


@functools.partial(jax.jit, static_argnames=("bs0", "bs1", "ch"))
def vorbis_window_chain(X, ls, rs, re, valid, lap, lap_len, had_prev,
                        *, bs0: int, bs1: int, ch: int):
    """Run K packets of a Vorbis lockstep group through IMDCT + lapped OLA.

    Args:
      X:        [K, L, bs1//2] f32 spectra (L = B*ch lane-channels,
                lane-major); short-block packets occupy [..., :bs0//2].
      ls/rs/re: [K, B] int32 per-packet left_start / right_start /
                right_end (models/vorbis.py:_packet_entropy geometry; the
                block size is implied: rs==bs0//2 and re==bs0 ⇔ short).
      valid:    [K, B] int32 — 0 slots leave the lane's carry untouched.
      lap:      [L, bs1//2] f32 carried previous-window right half.
      lap_len:  [B] int32 carried lap width (0, bs0//2 or bs1//2).
      had_prev: [B] int32 — 0 until the lane's first decoded packet (the
                facade's ``self._prev is None`` priming state).

    Returns (pcm [K, L, bs1] left-aligned at 0 and zero-padded past each
    packet's out_len = had_prev ? rs-ls : 0, lap', lap_len', had_prev').
    """
    K, L, _ = X.shape
    h0, h = bs0 // 2, bs1 // 2
    c = (bs1 - bs0) // 4
    r_ls = (3 * bs1 - bs0) // 4  # right_start of a long block w/ short next

    # --- IMDCT both sizes, select per window (short rows have zero tails,
    # but matmul cost is shape-, not content-, driven: run both, select)
    M1 = jnp.asarray(mdct_ops.imdct_matrix(bs1))
    y = jnp.dot(X.reshape(K * L, h), M1,
                precision=jax.lax.Precision.HIGHEST)
    if bs0 != bs1:
        M0 = jnp.asarray(mdct_ops.imdct_matrix(bs0))
        y0 = jnp.dot(X[..., :h0].reshape(K * L, h0), M0,
                     precision=jax.lax.Precision.HIGHEST)
        y0 = jnp.pad(y0, ((0, 0), (0, bs1 - bs0)))
        is_short = (rs == h0) & (re == bs0)          # [K, B]
        is_short = jnp.repeat(is_short, ch, axis=1)  # [K, L]
        y = jnp.where(is_short.reshape(K * L, 1), y0, y)
    y = y.reshape(K, L, bs1)

    W = jnp.asarray(_weight_tables(bs0, bs1))  # [2, 2, 2, bs1]
    t = jnp.arange(bs1)[None, :]               # [1, bs1]
    ih = jnp.arange(h)[None, :]

    def body(carry, xs):
        lap, lap_len, had_prev = carry
        yk, lsk, rsk, rek, vk = xs              # [L, bs1], [B]...
        lsr = jnp.repeat(lsk, ch)[:, None]      # [L, 1]
        rsr = jnp.repeat(rsk, ch)[:, None]
        rer = jnp.repeat(rek, ch)[:, None]
        vr = jnp.repeat(vk, ch)[:, None]
        lpr = jnp.repeat(lap_len, ch)[:, None]
        # current block length n: short ⇔ (rs==h0 and re==bs0)
        n_cur = jnp.where((rsr == h0) & (rer == bs0), bs0, bs1)

        # previous-window half, shifted right by left_start
        lap_pad = jnp.pad(lap, ((0, 0), (0, bs1 - h)))
        lap_sh = lap_pad if c == 0 else \
            jnp.where(lsr == c, jnp.roll(lap_pad, c, axis=1), lap_pad)

        # slope rows: select (lap width, left_start) variant per lane
        wi = (lpr == h).astype(jnp.int32) if h != h0 else \
            jnp.ones_like(lpr)
        li = (lsr == c).astype(jnp.int32) if c != 0 else \
            jnp.zeros_like(lsr)
        w_f = jnp.where(wi == 1, W[1, 0, 0], W[0, 0, 0])
        w_r = jnp.where(wi == 1, W[1, 0, 1], W[0, 0, 1])
        if c != 0:
            w_f = jnp.where(li == 1,
                            jnp.where(wi == 1, W[1, 1, 0], W[0, 1, 0]), w_f)
            w_r = jnp.where(li == 1,
                            jnp.where(wi == 1, W[1, 1, 1], W[0, 1, 1]), w_r)

        # lapped mix over [ls, ls+min(lap_len, n-ls)) (overlap_add contract)
        mix = (t >= lsr) & (t < lsr + lpr) & (t < n_cur)
        y_mix = jnp.where(mix, yk * w_f + lap_sh * w_r, yk)

        # new lap = y_mix[rs : re], left-aligned; rs from a 3-value set
        ypad = jnp.pad(y_mix, ((0, 0), (0, h)))
        cand = ypad[:, h : h + h]                       # rs == h (long-long)
        cand = jnp.where(rsr == h0, ypad[:, h0 : h0 + h], cand)
        if r_ls not in (h0, h):
            cand = jnp.where(rsr == r_ls, ypad[:, r_ls : r_ls + h], cand)
        new_w = rer - rsr                               # h0 or h
        lap_new = jnp.where(ih < new_w, cand, 0.0)

        # finished region [ls, rs) left-aligned; zero unless had_prev&valid
        out = y_mix if c == 0 else \
            jnp.where(lsr == c, ypad[:, c : c + bs1], y_mix)
        hpr = jnp.repeat(had_prev, ch)[:, None]
        out_len = jnp.where((hpr > 0) & (vr > 0), rsr - lsr, 0)
        out = jnp.where(t < out_len, out, 0.0)

        lap = jnp.where(vr > 0, lap_new, lap)
        lap_len = jnp.where(vk > 0, rek - rsk, lap_len)
        had_prev = jnp.where(vk > 0, 1, had_prev)
        return (lap, lap_len, had_prev), out

    (lap, lap_len, had_prev), pcm = jax.lax.scan(
        body, (lap, lap_len, had_prev), (y, ls, rs, re, valid))
    return pcm, lap, lap_len, had_prev
