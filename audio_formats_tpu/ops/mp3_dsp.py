"""MP3 Layer III device DSP: dequant → stereo → antialias → IMDCT → synthesis.

This is the flagship matmul pipeline.  Everything after the host's Huffman
stage is dense linear algebra over [batch, channel] lanes:

* **Requantize** — sign(q)·|q|^(4/3) scaled by host-computed per-coefficient
  gains (folds global_gain, scalefactors, preflag, subblock_gain and the
  mid/side 1/√2, exactly as minimp3 folds them into `scf`).
* **Stereo** — a general per-coefficient 2×2 mix (covers mid/side l±r and
  intensity kl/kr bands; host computes the four gain vectors since intensity
  band activation depends on which right-channel bands are all-zero —
  already known from the Huffman output).
* **Reorder** — host-computed permutation (short-block triple interleave),
  one gather.
* **Antialias** — 8 butterflies per band boundary, vectorized over bands,
  masked by the per-granule band count (31 long / none short / n-1 mixed).
* **IMDCT 36/12 + overlap-add** — per band a single [36]→[36] matrix over
  (18 coeffs ‖ 18 overlap): analytic ISO/IEC 11172-3 IMDCT composed with the
  window (normal/start/short/stop) and OLA state update.  All four window
  matrices are applied and selected per band (cheaper than gathers at this
  size), then frequency inversion (change-sign) applies a static mask.
* **Polyphase synthesis** — the 32-band filterbank as a 17-tap matrix FIR
  over granule slots: pcm_t = Σ_r W_r·S_{t−r}, with W extracted offline from
  the reference's linear synthesis flow (tools/gen_mp3_synth.py, verified to
  3.6e-14).  One [18, 17·32]×[17·32, 32] matmul per granule-lane.

Carried per-stream state: IMDCT overlap [C, 32, 18] and the last 16 subband
slot vectors S [C, 16, 32] (equivalent to minimp3's mdct_overlap + qmf_state,
minimp3.d:40-45).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

_TABLE_DIR = os.path.join(os.path.dirname(__file__), "..", "utils", "tables")

# Synthesis FIR [17, 32, 32] (see module docstring).
SYNTH_FIR = np.load(os.path.join(_TABLE_DIR, "mp3_synth_fir.npz"))["W"]

# Antialias butterfly coefficients from the spec's ci constants
# (ISO 11172-3 Table B.9 values; equals minimp3's g_aa within float rounding).
_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
AA_CS = (1.0 / np.sqrt(1.0 + _CI**2)).astype(np.float32)
AA_CA = (np.abs(_CI) / np.sqrt(1.0 + _CI**2)).astype(np.float32)

WIN_NORMAL, WIN_START, WIN_SHORT, WIN_STOP = 0, 1, 2, 3


def _imdct36_matrix() -> np.ndarray:
    n = np.arange(36)[:, None]
    k = np.arange(18)[None, :]
    return np.cos(np.pi / 72.0 * (2 * n + 1 + 18) * (2 * k + 1))


def _imdct12_matrix() -> np.ndarray:
    n = np.arange(12)[:, None]
    k = np.arange(6)[None, :]
    return np.cos(np.pi / 24.0 * (2 * n + 1 + 6) * (2 * k + 1))


def _long_window(kind: int) -> np.ndarray:
    n = np.arange(36)
    w = np.sin(np.pi / 36.0 * (n + 0.5))
    if kind == WIN_START:
        w[18:24] = 1.0
        w[24:30] = np.sin(np.pi / 12.0 * (np.arange(24, 30) - 18 + 0.5))
        w[30:] = 0.0
    elif kind == WIN_STOP:
        w[:6] = 0.0
        w[6:12] = np.sin(np.pi / 12.0 * (np.arange(6, 12) - 6 + 0.5))
        w[12:18] = 1.0
    return w


def _build_imdct_matrices() -> np.ndarray:
    """[4 window types, 36, 36] mapping (coeffs(18) ‖ overlap(18)) →
    (pcm(18) ‖ overlap'(18))."""
    out = np.zeros((4, 36, 36))
    c36 = _imdct36_matrix()
    for kind in (WIN_NORMAL, WIN_START, WIN_STOP):
        zw = c36 * _long_window(kind)[:, None]  # [36 out, 18 coeff]
        m = np.zeros((36, 36))
        m[:18, :18] = zw[:18].T
        m[18:, :18] = np.eye(18)  # overlap feeds straight into pcm
        m[:18, 18:] = zw[18:].T  # new overlap from coeff tail
        out[kind] = m
    # short: three 12-point IMDCTs at offsets 6, 12, 18 within the 36 frame;
    # coefficients arrive reordered as triples [s0,s1,s2] per frequency line.
    c12 = _imdct12_matrix() * np.sin(np.pi / 12.0 * (np.arange(12) + 0.5))[:, None]
    z = np.zeros((36, 18))
    for j in range(3):
        # window j uses coeffs [j::3]
        z[6 + 6 * j : 18 + 6 * j, j::3] += c12
    m = np.zeros((36, 36))
    m[:18, :18] = z[:18].T
    m[18:, :18] = np.eye(18)
    m[:18, 18:] = z[18:].T
    out[WIN_SHORT] = m
    return out


IMDCT_MATS = _build_imdct_matrices().astype(np.float32)

# frequency inversion (change-sign): odd time samples of odd bands flip
_SIGN = np.ones((32, 18), dtype=np.float32)
_SIGN[1::2, 1::2] = -1.0


@functools.partial(jax.jit, static_argnames=("nch", "ngr", "use_perm", "dequant", "use_mix"))
def mp3_frame_dsp(q, scale, mix, perm, aa_bands, wtype, overlap, shist,
                  nch: int, ngr: int, gr_active=None, use_perm: bool = True,
                  dequant: bool = True, use_mix: bool = True):
    """Decode the DSP half of one MP3 frame for a batch of streams.

    q:       [B, ngr, nch, 576] f32 — signed quantized Huffman values
    scale:   [B, ngr, nch, 576] f32 — per-coefficient requant gains
    mix:     [B, ngr, 4, 576]  f32 — stereo mix (a,b,c,d):
             l' = a·l + b·r, r' = c·l + d·r  (identity rows when mono)
    perm:    [B, ngr, nch, 576] i32 — short-block reorder permutation
    aa_bands:[B, ngr, nch]      i32 — antialias band-boundary count
    wtype:   [B, ngr, nch, 32]  i32 — per-band window type (0..3)
    overlap: [B, nch, 32, 18]   f32 — carried IMDCT OLA state
    shist:   [B, nch, 16, 32]   f32 — carried subband slot history
    gr_active: optional [B, ngr] bool — granules whose state commits (lanes
             with reservoir-underflow/ended frames freeze their state, as the
             reference skips decode entirely for such frames)

    ``ngr`` may cover several physical frames (the batch scheduler windows
    W frames per call: ngr = W · granules-per-frame).
    Returns (pcm [B, ngr·576·nch interleaved? no: [B, ngr, 18·32, nch]],
             overlap', shist').
    """
    B = q.shape[0]
    W = jnp.asarray(SYNTH_FIR)  # [17, 32, 32]
    mats = jnp.asarray(IMDCT_MATS)  # [4, 36, 36]
    sign = jnp.asarray(_SIGN)
    if gr_active is None:
        gr_active = jnp.ones((B, ngr), bool)
    if not use_perm:
        # placeholder: the reorder gather is compiled out; avoid shipping a
        # [B, ngr, nch, 576] identity tensor to the device every window
        perm = jnp.zeros((1, ngr, 1, 1), jnp.int32)
    if not dequant:
        # the host stage shipped sign(q)*|q|^(4/3)*gain already: scale is a
        # placeholder and never uploaded at full size
        scale = jnp.zeros((1, ngr, 1, 1), jnp.float32)
    if not use_mix:
        # identity stereo mix (mono windows): compiled out
        mix = jnp.zeros((1, ngr, 1, 1), jnp.float32)

    def granule_step(carry, xs):
        overlap, shist = carry
        q_g, scale_g, mix_g, perm_g, aa_g, wt_g, act_g = xs
        # 1. requantize (fused on host when dequant=False)
        if dequant:
            xg = (
                jnp.sign(q_g)
                * jnp.power(jnp.abs(q_g), jnp.float32(4.0 / 3.0))
                * scale_g
            )  # [B, nch, 576]
        else:
            xg = q_g
        # 2. stereo mix
        if nch == 2 and use_mix:
            l, r = xg[:, 0], xg[:, 1]
            a, b, c, d = (mix_g[:, i] for i in range(4))
            xg = jnp.stack([a * l + b * r, c * l + d * r], axis=1)
        # 3. reorder (skipped entirely for long-block-only windows)
        if use_perm:
            xg = jnp.take_along_axis(xg, perm_g, axis=-1)
        # 4. antialias
        xb = xg.reshape(B, nch, 32, 18)
        u = xb[:, :, 1:, :8]  # [B, nch, 31, 8]
        d_ = xb[:, :, :-1, 17:9:-1]
        nu = u * AA_CS - d_ * AA_CA
        nd = u * AA_CA + d_ * AA_CS
        bmask = (
            jnp.arange(31)[None, None, :, None]
            < aa_g[:, :, None, None]
        )
        u2 = jnp.where(bmask, nu, u)
        d2 = jnp.where(bmask, nd, d_)
        xb = xb.at[:, :, 1:, :8].set(u2)
        xb = xb.at[:, :, :-1, 17:9:-1].set(d2)
        # 5. IMDCT + OLA: per band select among the 4 window matrices
        inp = jnp.concatenate([xb, overlap], axis=-1)  # [B, nch, 32, 36]
        outs = jnp.einsum("bcki,wij->wbckj", inp, mats,
                          precision=jax.lax.Precision.HIGHEST)
        sel = wt_g[None, :, :, :, None] == jnp.arange(4)[
            :, None, None, None, None
        ]
        out = jnp.sum(jnp.where(sel, outs, 0.0), axis=0)  # [B, nch, 32, 36]
        grb = out[..., :18] * sign  # 6. frequency inversion
        new_overlap = out[..., 18:]
        # 7. synthesis FIR over slots
        S = jnp.swapaxes(grb, -1, -2)  # [B, nch, 18, 32]
        Sfull = jnp.concatenate([shist, S], axis=2)  # [B, nch, 34, 32]
        wins = jnp.stack(
            [Sfull[:, :, 16 - r : 34 - r, :] for r in range(17)], axis=3
        )  # [B, nch, 18, 17, 32]
        pcm = jnp.einsum(
            "bctrk,rjk->bctj", wins, W,
            precision=jax.lax.Precision.HIGHEST,
        )  # [B, nch, 18, 32]
        new_shist = Sfull[:, :, -16:, :]
        act = act_g[:, None, None, None]
        overlap = jnp.where(act, new_overlap, overlap)
        shist = jnp.where(act, new_shist, shist)
        return (overlap, shist), pcm.reshape(B, nch, 576)

    # scan over the granule axis: program size independent of the window
    xs = (
        jnp.swapaxes(q, 0, 1),
        jnp.swapaxes(scale, 0, 1),
        jnp.swapaxes(mix, 0, 1),
        jnp.swapaxes(perm, 0, 1),
        jnp.swapaxes(aa_bands, 0, 1),
        jnp.swapaxes(wtype, 0, 1),
        jnp.swapaxes(gr_active, 0, 1),
    )
    (overlap, shist), pcm_all = jax.lax.scan(
        granule_step, (overlap, shist), xs
    )
    return jnp.swapaxes(pcm_all, 0, 1), overlap, shist


# ---------------------------------------------------------------------------
# v2: scan-free window DSP.
#
# The per-granule scan in mp3_frame_dsp keeps every intermediate in device
# memory per step (memory-traffic-bound, one step per granule).  But the
# pipeline is *not* actually recurrent:
#
#   * the IMDCT+OLA matrix maps (coeffs ‖ overlap) -> (pcm ‖ overlap'), and
#     by construction overlap' = V(w_g)·c_g depends ONLY on the current
#     granule's coefficients (see _build_imdct_matrices: the overlap' columns
#     read the coeff rows alone).  Hence
#         pcm_g = U(w_g)·c_g + V(w_{g-1})·c_{g-1}
#     is fully parallel across granules, and
#   * the polyphase synthesis is a linear 17-tap FIR over the slot axis — a
#     convolution, not a recurrence.
#
# So the whole window collapses into batched matmuls + one conv, with carried
# state entering only at the window edges (prepended overlap / slot history).
#
# Contract difference vs v1: granule activity must be a per-lane PREFIX
# (n_act granules, then inactive).  The host scheduler guarantees this by
# compacting skipped frames (it already tracks per-frame flags); outputs at
# granule index >= n_act are garbage and must be discarded by the caller.
# ---------------------------------------------------------------------------

# [4, 18, 36] per window type: c(18) -> (pcm(18) ‖ overlap'(18))
UV_MATS = IMDCT_MATS[:, :18, :].copy()

# slot-layout frequency inversion: sign.T broadcast over granules
_SIGN_T = _SIGN.T.copy()  # [18, 32]

# synthesis FIR as a conv kernel: pcm[t] = Σ_m Sfull[t+m]·Wrev[m]
# Wrev[m, k_in, j_out] = SYNTH_FIR[16-m, j, k]
SYNTH_CONV_K = np.ascontiguousarray(
    SYNTH_FIR[::-1].transpose(0, 2, 1)
)  # [17, 32in, 32out]


def _build_synth_toeplitz() -> np.ndarray:
    """Granule-blocked Toeplitz form of the 17-tap synthesis FIR:
    pcm[g·18+t, j] = Σ_{u,k} Swin[g, u, k]·W_blk[u·32+k, t·32+j] where
    Swin[g] = slot window [g·18, g·18+34) of (shist ‖ S).  One big
    matmul replaces the conv (whose lowering on the previous accelerator
    materialized im2col)."""
    W_blk = np.zeros((34 * 32, 18 * 32), np.float32)
    for t in range(18):
        for u in range(t, t + 17):
            r = 16 + t - u
            W_blk[u * 32 : (u + 1) * 32, t * 32 : (t + 1) * 32] = (
                SYNTH_FIR[r].T
            )
    return W_blk


SYNTH_TOEPLITZ = _build_synth_toeplitz()  # [1088, 576]


@functools.partial(
    jax.jit, static_argnames=("nch", "ngr", "use_perm", "dequant", "use_mix")
)
def mp3_window_dsp(q, scale, mix, perm, aa_bands, wtype, overlap, shist,
                   n_act, nch: int, ngr: int, use_perm: bool = True,
                   dequant: bool = True, use_mix: bool = True):
    """Scan-free MP3 window DSP (see block comment above).

    Same tensor contract as mp3_frame_dsp except the per-granule activity
    mask is replaced by ``n_act`` [B] int32 — the number of leading active
    granules per lane (activity must be a prefix; the scheduler compacts).

    Returns (pcm [B, ngr, nch, 576], overlap', shist').
    """
    B = q.shape[0]
    mats = jnp.asarray(UV_MATS)  # [4, 18, 36]
    if use_perm is False:
        del perm
    if not dequant:
        del scale
        xg = q
    else:
        xg = jnp.sign(q) * jnp.power(jnp.abs(q), jnp.float32(4.0 / 3.0)) * scale
    # stereo mix [B, G, nch, 576]
    if nch == 2 and use_mix:
        l, r = xg[:, :, 0], xg[:, :, 1]
        a, b, c, d = (mix[:, :, i] for i in range(4))
        xg = jnp.stack([a * l + b * r, c * l + d * r], axis=2)
    if use_perm:
        xg = jnp.take_along_axis(xg, perm, axis=-1)
    # antialias, batched over all granules.  Scatter-free: rebuild the
    # 18-coeff axis from slices (an .at[].set scatter per step was
    # pathological on the previous accelerator)
    xb = xg.reshape(B, ngr, nch, 32, 18)
    top = xb[..., :8]                  # coeffs 0..7 of every band
    bot = xb[..., 17:9:-1]             # coeffs 17..10 (reversed)
    u = top[:, :, :, 1:, :]            # bands 1..31
    d_ = bot[:, :, :, :-1, :]          # bands 0..30
    nu = u * AA_CS - d_ * AA_CA
    nd = u * AA_CA + d_ * AA_CS
    bmask = (
        jnp.arange(31)[None, None, None, :, None]
        < aa_bands[:, :, :, None, None]
    )
    new_top = jnp.concatenate(
        [top[:, :, :, :1], jnp.where(bmask, nu, u)], axis=3
    )
    new_bot = jnp.concatenate(
        [jnp.where(bmask, nd, d_), bot[:, :, :, 31:]], axis=3
    )
    xb = jnp.concatenate(
        [new_top, xb[..., 8:10], new_bot[..., ::-1]], axis=-1
    )
    # IMDCT: per window type, MASK the coefficients and accumulate the
    # [18]→[36] matmul — four K=18 matmuls into one [.., 36] buffer.
    # (Computing all four types side by side and selecting after
    # materialized a [B,G,nch,32,4,36] intermediate — 1.8 GB at the
    # production window — for 4x the memory traffic.)  HIGHEST stays:
    # on the CPU backend Precision.HIGH broke the 4e-6
    # sharded==unsharded lattice contract (rel 2.1e-5).
    out = jnp.zeros(xb.shape[:4] + (36,), jnp.float32)
    for w in range(4):
        xw = jnp.where((wtype == w)[..., None], xb, 0.0)
        out = out + jnp.einsum(
            "bgcki,ij->bgckj", xw, mats[w],
            precision=jax.lax.Precision.HIGHEST,
        )
    Y = out[..., :18]   # U(w_g)·c_g
    OV = out[..., 18:]  # V(w_g)·c_g = overlap emitted by granule g
    # OLA: granule g adds the PREVIOUS granule's overlap (carried at g=0)
    ov_stack = jnp.concatenate(
        [overlap[:, None], OV], axis=1
    )  # [B, G+1, nch, 32, 18]
    grb = Y + ov_stack[:, :ngr]
    # new carried overlap = overlap emitted by the last ACTIVE granule
    idx = n_act.reshape(B, 1, 1, 1, 1).astype(jnp.int32)
    new_overlap = jnp.take_along_axis(ov_stack, idx, axis=1)[:, 0]
    # frequency inversion + to slot layout [B, nch, G*18, 32]
    # (a band-major formulation that folded the signs and the slot
    # relayout into split Toeplitz matrices was slower fused on the
    # previous accelerator: XLA's layout assignment already absorbs these
    # transposes into the dot operands, while the explicit prev-granule
    # concat added a real pass)
    S = jnp.swapaxes(grb, -1, -2) * _SIGN_T[None, None, None]
    S = jnp.swapaxes(S, 1, 2).reshape(B, nch, ngr * 18, 32)
    Sfull = jnp.concatenate([shist, S], axis=2)  # [B, nch, 16+18G, 32]
    # polyphase synthesis as ONE granule-blocked Toeplitz matmul: the
    # overlapping 34-slot windows come from two shifted reshapes (window g
    # = chunk g ‖ first 16 slots of chunk g+1), no im2col materialization
    pad = jnp.pad(Sfull, ((0, 0), (0, 0), (0, 2), (0, 0)))
    R = pad.reshape(B, nch, ngr + 1, 18, 32)
    Swin = jnp.concatenate([R[:, :, :ngr], R[:, :, 1:, :16]], axis=3)
    pcm = jnp.dot(
        Swin.reshape(B * nch * ngr, 34 * 32),
        jnp.asarray(SYNTH_TOEPLITZ),
        precision=jax.lax.Precision.HIGHEST,
    )
    pcm = pcm.reshape(B, nch, ngr, 18, 32)
    pcm = jnp.swapaxes(pcm, 1, 2).reshape(B, ngr, nch, 576)
    # new slot history = the 16 slots ending at slot 16 + 18*n_act
    base = 18 * n_act.reshape(B, 1, 1, 1).astype(jnp.int32)
    hidx = base + jnp.arange(16).reshape(1, 1, 16, 1)
    new_shist = jnp.take_along_axis(
        Sfull, jnp.broadcast_to(hidx, (B, nch, 16, 32)), axis=2
    )
    return pcm, new_overlap, new_shist


@functools.partial(jax.jit, static_argnames=("nch",))
def mp3_synth_slots(S, shist, nch: int):
    """Polyphase synthesis only — Layer I/II path (no IMDCT: L1/L2 are pure
    subband codecs, minimp3.d:449-486).

    S: [B, nch, T, 32] scf-applied subband slot vectors
    shist: [B, nch, 16, 32] carried slot history
    Returns (pcm [B, nch, T*32], shist').
    """
    W = jnp.asarray(SYNTH_FIR)
    B, _, T, _ = S.shape
    Sfull = jnp.concatenate([shist, S], axis=2)  # [B, nch, 16+T, 32]
    wins = jnp.stack(
        [Sfull[:, :, 16 - r : 16 - r + T, :] for r in range(17)], axis=3
    )  # [B, nch, T, 17, 32]
    pcm = jnp.einsum(
        "bctrk,rjk->bctj", wins, W, precision=jax.lax.Precision.HIGHEST
    )
    return pcm.reshape(B, nch, T * 32), Sfull[:, :, -16:, :]
