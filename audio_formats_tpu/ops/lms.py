"""QOA LMS predictor kernels — sequential int32 scans on device.

QOA ("Quite OK Audio") reconstructs each sample from a 4-tap sign-sign LMS
predictor plus a dequantized 3-bit residual (qoa.d:231-261).  The recurrence
is inherently sequential in time but embarrassingly parallel across
(streams × channels × frames) — QOA frame headers carry the LMS state
(qoa.d:413-455), so *decode* parallelizes across frames too.  These kernels
therefore run a `lax.scan` over time with a wide lane axis.

Bit-exactness: everything is int32 with two's-complement wraparound and
arithmetic right shifts, exactly as the reference's D `int` ops
(qoa_lms_predict qoa.d:231, qoa_lms_update qoa.d:241, qoa_div qoa.d:263).
The encoder's 64-bit squared-error accumulator (qoa.d:357-368) is emulated
with a (hi, lo) uint32 pair — |err| <= 65535 so err² fits u32 exactly.

Encoder search: the reference brute-forces all 16 scalefactors sequentially
per slice (qoa.d:345-383); here the 16 candidates run as a vector axis in
parallel, with first-index tie-breaking to match the reference's strict `<`
best-error update.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

QOA_SLICE_LEN = 20
QOA_SLICES_PER_FRAME = 256
QOA_FRAME_LEN = QOA_SLICE_LEN * QOA_SLICES_PER_FRAME  # 5120
QOA_LMS_LEN = 4

# Spec tables (qoa.d:150-215; defined by the QOA format spec, qoaformat.org:
# quant_tab maps residual -8..8 -> 3-bit code; scalefactor_tab[s] =
# round((s+1)^2.75); reciprocal_tab = ceil(2^16 / sf); dequant_tab[s][q] =
# round(sf * {0.75,-0.75,2.5,-2.5,4.5,-4.5,7,-7}[q])).
QUANT_TAB = np.array(
    [7, 7, 7, 5, 5, 3, 3, 1, 0, 0, 2, 2, 4, 4, 6, 6, 6], dtype=np.int32
)
SCALEFACTOR_TAB = np.round(
    np.power(np.arange(1, 17, dtype=np.float64), 2.75)
).astype(np.int32)
RECIPROCAL_TAB = ((1 << 16) + SCALEFACTOR_TAB - 1) // SCALEFACTOR_TAB
_DQT_BASE = np.array([0.75, -0.75, 2.5, -2.5, 4.5, -4.5, 7.0, -7.0])
DEQUANT_TAB = np.array(
    [
        [int(np.floor(sf * b + 0.5)) if sf * b > 0 else -int(np.floor(-sf * b + 0.5))
         for b in _DQT_BASE]
        for sf in SCALEFACTOR_TAB
    ],
    dtype=np.int32,
)


def _clamp_s16(v):
    return jnp.clip(v, -32768, 32767)


def _lms_predict(h, w):
    # (sum of weights*history) >> 13, int32 wraparound (qoa.d:231-238)
    return jnp.sum(h * w, axis=-1) >> 13


def _lms_update(h, w, sample, residual):
    """sign-sign LMS update (qoa.d:241-254). sample/residual: [...]; h/w [...,4]."""
    delta = (residual >> 4)[..., None]
    w = w + jnp.where(h < 0, -delta, delta)
    h = jnp.concatenate([h[..., 1:], sample[..., None]], axis=-1)
    return h, w


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

@jax.jit
def qoa_decode_scan(history, weights, dequantized):
    """Run the LMS decode recurrence.

    history, weights: [L, 4] int32 (from frame headers)
    dequantized:      [L, T] int32 (host-unpacked residuals, already through
                      DEQUANT_TAB — a pure table lookup)
    Returns reconstructed samples [L, T] int32 in s16 range.
    """

    def step(carry, r):
        h, w = carry
        p = _lms_predict(h, w)
        recon = _clamp_s16(p + r)
        h, w = _lms_update(h, w, recon, r)
        return (h, w), recon

    (_, _), out = jax.lax.scan(
        step, (history, weights), jnp.swapaxes(dequantized, 0, 1)
    )
    return jnp.swapaxes(out, 0, 1)


@jax.jit
def decode_slices(history, weights, scalefactors, codes):
    """Decode QOA slices: dequantize 3-bit codes then run the LMS scan.

    scalefactors: [L, S] int32; codes: [L, S, 20] int32 (0..7)
    Returns samples [L, S*20] int32.
    """
    # dequant via a 128-way compare+select over the 16x8 table instead of
    # a gather (a choice made for the previous accelerator; whether a
    # plain gather is faster on the GPU is not measured).  Inputs may
    # arrive as int8 (the batched scheduler ships compact payloads).
    idx = (
        scalefactors[..., None].astype(jnp.int32) * 8
        + codes.astype(jnp.int32)
    )  # [L, S, 20]
    flat = DEQUANT_TAB.reshape(-1)
    deq = jnp.zeros(idx.shape, jnp.int32)
    for k in range(flat.shape[0]):
        deq = deq + jnp.where(idx == k, np.int32(flat[k]), 0)
    L = codes.shape[0]
    return qoa_decode_scan(
        jnp.asarray(history), jnp.asarray(weights), deq.reshape(L, -1)
    )


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _sign(v):
    return (v > 0).astype(jnp.int32) - (v < 0).astype(jnp.int32)


@jax.jit
def qoa_encode_frame_scan(samples, history, weights, frame_len):
    """Encode one QOA frame worth of samples for L independent lanes.

    samples:   [L, 5120] int32 (s16 values; zero-padded past frame_len)
    history:   [L, 4] int32, weights: [L, 4] int32 — carried LMS state
    frame_len: scalar int32 OR per-lane [L] int32 (samples per channel in
               this frame, <= 5120) — per-lane lengths let the
               frame-parallel encoder batch every stream's final partial
               frame into the same lockstep call

    Returns (scalefactors [L, 256] i32, codes [L, 256, 20] i32,
             history' [L,4], weights' [L,4]).  The host packs codes into
    big-endian u64 slice words and discards slices past ceil(frame_len/20).
    """
    L = samples.shape[0]
    recip = jnp.asarray(RECIPROCAL_TAB)  # [16]
    frame_len = jnp.broadcast_to(jnp.asarray(frame_len, jnp.int32), (L,))

    samples_s = samples.reshape(L, QOA_SLICES_PER_FRAME, QOA_SLICE_LEN)
    samples_s = jnp.transpose(samples_s, (1, 0, 2))  # [S, L, 20]

    def slice_step(carry, inp):
        h, w = carry  # [L, 4]
        slice_samples, slice_index = inp  # [L, 20], scalar
        # number of active samples in this slice, per lane (qoa.d:335)
        slice_len = jnp.clip(frame_len - slice_index * QOA_SLICE_LEN, 0, 20)
        slice_active = (slice_len > 0)[:, None]  # [L, 1]

        # Trial state for all 16 scalefactors in parallel.
        h16 = jnp.broadcast_to(h[:, None, :], (L, 16, 4)).astype(jnp.int32)
        w16 = jnp.broadcast_to(w[:, None, :], (L, 16, 4)).astype(jnp.int32)
        err_hi = jnp.zeros((L, 16), jnp.uint32)
        err_lo = jnp.zeros((L, 16), jnp.uint32)
        codes = []
        for t in range(QOA_SLICE_LEN):  # static 20-step unroll
            active = (t < slice_len)[:, None]  # [L, 1]
            sample = slice_samples[:, t][:, None]  # [L, 1]
            predicted = _lms_predict(h16, w16)  # [L, 16]
            residual = sample - predicted
            # qoa_div (qoa.d:263-269): fixed-point reciprocal + round away
            n = (residual * recip[None, :] + (1 << 15)) >> 16
            n = n + _sign(residual) - _sign(n)
            clamped = jnp.clip(n, -8, 8)
            # QUANT_TAB[v+8] as a 17-way constant select instead of a
            # gather on the 5120-step critical path (the table is not
            # uniform enough for a closed form).
            quantized = jnp.zeros_like(clamped)
            for k in range(17):
                quantized = jnp.where(clamped == k - 8,
                                      np.int32(QUANT_TAB[k]), quantized)
            # DEQUANT_TAB[sf, code]: sf is the (static) candidate column,
            # so each code value selects a [16] column constant — an
            # 8-way select instead of a gather.
            dequantized = jnp.zeros_like(quantized)
            for k in range(8):
                dequantized = jnp.where(
                    quantized == k, DEQUANT_TAB[None, :, k], dequantized)
            recon = _clamp_s16(predicted + dequantized)
            e = (sample - recon).astype(jnp.int32)
            e2 = (e * e).astype(jnp.uint32)  # exact: |e| <= 65535
            new_lo = err_lo + e2
            new_hi = err_hi + (new_lo < err_lo).astype(jnp.uint32)
            nh, nw = _lms_update(h16, w16, recon, dequantized)
            err_lo = jnp.where(active, new_lo, err_lo)
            err_hi = jnp.where(active, new_hi, err_hi)
            h16 = jnp.where(active[..., None], nh, h16)
            w16 = jnp.where(active[..., None], nw, w16)
            codes.append(jnp.where(active, quantized, 0))
        codes = jnp.stack(codes, axis=-1)  # [L, 16, 20]

        # Best scalefactor: lexicographic (hi, lo) min, first index on ties
        # (matches reference strict `<`, qoa.d:376).
        mhi = jnp.min(err_hi, axis=1, keepdims=True)
        lo_masked = jnp.where(err_hi == mhi, err_lo, jnp.uint32(0xFFFFFFFF))
        mlo = jnp.min(lo_masked, axis=1, keepdims=True)
        best = jnp.argmax((err_hi == mhi) & (lo_masked == mlo), axis=1)  # [L]

        # select the winning candidate via one-hot mask + sum (no gather)
        onehot = (jnp.arange(16, dtype=jnp.int32)[None, :]
                  == best[:, None])[..., None]  # [L, 16, 1]
        best_codes = jnp.sum(jnp.where(onehot, codes, 0), axis=1)  # [L, 20]
        best_h = jnp.sum(jnp.where(onehot, h16, 0), axis=1)
        best_w = jnp.sum(jnp.where(onehot, w16, 0), axis=1)

        # Only commit state for active slices (past-end slices are dropped
        # by the host anyway, but the carried LMS state must stop advancing).
        h_out = jnp.where(slice_active, best_h, h)
        w_out = jnp.where(slice_active, best_w, w)
        return (h_out, w_out), (best.astype(jnp.int32), best_codes)

    (h_f, w_f), (sfs, codes) = jax.lax.scan(
        slice_step,
        (history, weights),
        (samples_s, jnp.arange(QOA_SLICES_PER_FRAME, dtype=jnp.int32)),
    )
    return (
        jnp.swapaxes(sfs, 0, 1),
        jnp.transpose(codes, (1, 0, 2)),
        h_f,
        w_f,
    )


@jax.jit
def qoa_encode_frame_words(samples, frame_len):
    """Fused frame-parallel QOA encode: scalefactor search + DEVICE-side
    slice-word packing.  Every lane starts from the encoder's initial LMS
    state {h=0, w=0,0,-2^13,2^14} (qoa.d:568-581) — the frame-parallel
    layout's contract, where each frame header carries that constant state
    — so no LMS state crosses the wire in either direction, and the only
    download is the packed words: 8 B/slice instead of the 84 B/slice of
    (codes [20]i32 + sf i32).

    samples: [L, 5120] int16/int32 (s16 values; int16 upload halves the
    wire).  frame_len: scalar or per-lane [L] int32.

    Returns (word_hi, word_lo) [L, 256] uint32: the big-endian u64 slice
    word (qoa.d:330-339: sf<<60 | codes at bits 57-3t) split at bit 32 —
    code t=9 straddles the boundary (bits 30..32), hence the >>2 / &3.
    """
    samples = samples.astype(jnp.int32)
    L = samples.shape[0]
    h0 = jnp.zeros((L, QOA_LMS_LEN), jnp.int32)
    w0 = jnp.tile(jnp.array([0, 0, -(1 << 13), 1 << 14], jnp.int32), (L, 1))
    sf, codes, _h, _w = qoa_encode_frame_scan(samples, h0, w0, frame_len)
    c = codes.astype(jnp.uint32)  # [L, 256, 20]
    hi = sf.astype(jnp.uint32) << 28
    for t in range(9):  # codes 0..8 live fully above bit 32
        hi = hi | (c[..., t] << (25 - 3 * t))
    hi = hi | (c[..., 9] >> 2)
    lo = (c[..., 9] & 3) << 30
    for t in range(10, 20):  # codes 10..19 live fully below bit 32
        lo = lo | (c[..., t] << (57 - 3 * t))
    return hi, lo
