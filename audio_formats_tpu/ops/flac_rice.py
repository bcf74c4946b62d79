"""Device-side FLAC frame entropy: subframe headers + partitioned-Rice
residual decode as a vectorized multi-lane FSM.

This is the wire-optimal FLAC path: the host ships RAW FRAME BYTES (the
compressed stream itself — h2d inflation == 1.0) plus a tiny per-frame
header index from the byte-level sync scan (host/src/af_host.cc
af_flac_sync_index); everything bit-granular — subframe headers, LPC
coefficients, warm-up samples, Rice partitions (drflac.d:1149-1242's hot
loop) — decodes on the accelerator.  Output feeds the existing device
LPC/stereo stages (ops/lpc.py) unchanged.

Design notes:
 * Lanes are FRAMES; channels decode as sequential phases inside the
   lane (subframe 1's position depends on subframe 0's length), each an
   independent sample-synchronous ``lax.scan`` — step s emits residual
   sample s for every lane, so outputs land at the scan's step index and
   no scatter ever happens (the same emission scheme as the MP3 FSM,
   ops/mp3_huff.huff_decode).
 * Frame rows are ~2 K words, far too wide for the MP3 FSM's O(W)
   compare-select window.  The bit cursor is monotone, so the scan
   rebases every K samples: one cheap ROW gather pulls two aligned
   64-word blocks around each lane's cursor into a [L, 128] buffer and
   the K-sample inner body runs compare-select windows on that.
 * Everything is masked arithmetic — no data-dependent control flow;
   corrupt lanes raise a sticky per-lane ``err`` flag and the scheduler
   demotes only those lanes to the host path (SURVEY §5 error lattice).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

#: fixed predictor coefficients (af_host.cc kFixedCoef)
_FIXED_COEF = np.array(
    [[0, 0, 0, 0], [1, 0, 0, 0], [2, -1, 0, 0], [3, -3, 1, 0],
     [4, -6, 4, -1]], np.int32)

#: words per gather block; two blocks = 4096-bit working window
BLK_W = 64
BLK_BITS = BLK_W * 32
#: samples decoded per rebase; worst-case sample cost is
#: crossing(10) + unary(<=64) + 1 + remainder(<=32) ~ 107 bits, so
#: 8 x 107 = 856 < BLK_BITS keeps the window valid for a whole body.
#: The block gathers were free on the previous accelerator, so a small K
#: costs nothing at runtime — it halves the unrolled scan body, and compile time /
#: executable size scale with that
K_SAMP = 8


def _u32(x):
    return x.astype(jnp.uint32)


def _sel3(buf, w0):
    """Words w0, w0+1, w0+2 of each lane's buffer (compare+select)."""
    W = buf.shape[1]
    d = jnp.arange(W, dtype=jnp.int32)[None, :] - w0[:, None]
    z = jnp.uint32(0)
    a = jnp.sum(jnp.where(d == 0, buf, z), axis=1, dtype=jnp.uint32)
    b = jnp.sum(jnp.where(d == 1, buf, z), axis=1, dtype=jnp.uint32)
    c = jnp.sum(jnp.where(d == 2, buf, z), axis=1, dtype=jnp.uint32)
    return a, b, c


def _shift64(a, b, o):
    return (a << o) | ((b >> (31 - o)) >> 1)


def _extract32(a, b, c, o, width):
    """bits [o, o+width) of the 96-bit window a‖b‖c; width in [0, 32]."""
    zero = jnp.zeros_like(a)
    for _ in range(2):
        big = o >= 32
        a, b, c = (jnp.where(big, b, a), jnp.where(big, c, b),
                   jnp.where(big, zero, c))
        o = o - jnp.where(big, 32, 0)
    hi = _shift64(a, b, _u32(o))
    w = width if isinstance(width, jnp.ndarray) else jnp.int32(width)
    w = _u32(w)
    val = hi >> ((jnp.uint32(32) - w) & jnp.uint32(31))
    return jnp.where(w > 0, val, jnp.uint32(0))


def _sext(v, n):
    """Sign-extend the n-bit value v (u32), n in [0, 32] -> i32."""
    n = jnp.asarray(n, jnp.int32)
    s = jnp.where(n > 0, jnp.uint32(1) << (_u32(n - 1) & jnp.uint32(31)),
                  jnp.uint32(0))
    return ((v ^ s) - s).astype(jnp.int32)


def _clz_window(a, b, c, o):
    """Unary run (count of 0-bits before the first 1) at bit offset o of
    the 96-bit window; q in [0, 63], flag q64 if no 1 in 64 bits."""
    zero = jnp.zeros_like(a)
    for _ in range(2):
        big = o >= 32
        a, b, c = (jnp.where(big, b, a), jnp.where(big, c, b),
                   jnp.where(big, zero, c))
        o = o - jnp.where(big, 32, 0)
    w1 = _shift64(a, b, _u32(o))
    w2 = _shift64(b, c, _u32(o))
    q1 = jax.lax.clz(w1)
    q2 = jax.lax.clz(w2)
    q = jnp.where(w1 != 0, q1.astype(jnp.int32),
                  32 + q2.astype(jnp.int32))
    q64 = (w1 == 0) & (w2 == 0)
    return jnp.where(q64, 63, q), q64


def _read(buf, pos, width):
    """bits [pos, pos+width) of the lane buffer (width <= 32)."""
    a, b, c = _sel3(buf, pos >> 5)
    return _extract32(a, b, c, pos & 31, width)


def _gather_window(blocks, pos, npool):
    """[L, 2*BLK_W] working window: the two aligned BLK_W-word blocks
    around each lane's bit cursor, via ROW gathers of the shared
    [NPOOL, BLK_W] frame pool."""
    blk = jnp.clip(pos >> jnp.int32(11), 0, npool - 2)
    w1 = jnp.take(blocks, blk, axis=0)
    w2 = jnp.take(blocks, blk + 1, axis=0)
    return jnp.concatenate([w1, w2], axis=1), blk << jnp.int32(11)


def _roll_right(x, amount, nbits):
    """Per-lane right-roll by a dynamic amount via binary decomposition
    (jnp.roll per bit — the scatter-free dynamic shift)."""
    n = x.shape[1]
    for k in range(nbits):
        step = 1 << k
        if step >= n:
            break
        x = jnp.where(((amount >> k) & 1)[:, None] == 1,
                      jnp.roll(x, step, axis=1), x)
    return x


def pool_blocks_needed(nbytes_each) -> int:
    """Blocks for a shared pool holding every frame at BLK-aligned
    offsets, plus two trailing zero blocks (overrun guard)."""
    blk_b = BLK_W * 4
    return sum(-(-int(nb) // blk_b) for nb in nbytes_each) + 2


def build_frame_pool(frames, NPOOL: int):
    """Host helper: ONE shared [nused, BLK_W] u32 BE pool with each raw
    frame at a BLK-aligned offset (upload == compressed bytes + <=255 B
    per-frame alignment).  frames: list of (view, byte_off, nbytes).
    Returns (pool, base_bits [L] int32 — each frame's first bit).

    The pool is EXACT-size (only the blocks actually used): upload it
    as-is so the wire carries just the compressed bytes, then zero-pad
    to the kernel's bucketed NPOOL shape ON DEVICE with ``pad_pool`` —
    NPOOL bucketing then costs compile variants nothing on the wire."""
    blk_b = BLK_W * 4
    need = sum(-(-int(nb) // blk_b) for _, _, nb in frames)
    nused = min(need, max(NPOOL - 2, 0))
    pool = np.zeros(nused * blk_b, np.uint8)
    base_bits = np.zeros(len(frames), np.int64)
    cur = 0
    for i, (view, off, nb) in enumerate(frames):
        nb = min(int(nb), (nused - cur) * blk_b)
        nb = max(nb, 0)
        pool[cur * blk_b : cur * blk_b + nb] = \
            np.frombuffer(view, np.uint8, nb, int(off))
        base_bits[i] = cur * blk_b * 8
        cur += -(-nb // blk_b)
    big = pool.view(">u4").astype(np.uint32)
    return big.reshape(nused, BLK_W), base_bits


def build_frame_pool_native(lib, lane_addrs, lanes, NPOOL: int):
    """C fast path of :func:`build_frame_pool` (af_flac_build_pool):
    frame copies + the BE-word byteswap run in one native pass instead
    of a per-frame numpy loop + whole-pool astype.  lane_addrs: uint64
    [B] base address per stream; lanes: the scheduler's per-frame
    tuples (bi, byte_off, nbytes, ...).  Bit-identical to the numpy
    builder (A/B in tests/test_flac_device_rice.py)."""
    from ..host import native as _native

    blk_b = BLK_W * 4
    n = len(lanes)
    ptrs = np.fromiter((lane_addrs[p[0]] for p in lanes), np.uint64, n)
    offs = np.fromiter((p[1] for p in lanes), np.int64, n)
    sizes = np.fromiter((p[2] for p in lanes), np.int64, n)
    need = int((-(-sizes // blk_b)).sum())
    nused = min(need, max(NPOOL - 2, 0))
    pool = np.zeros(nused * blk_b, np.uint8)
    base_bits = np.zeros(n, np.int64)
    _native.flac_build_pool(lib, ptrs, offs, sizes, blk_b, pool,
                            base_bits)
    return pool.view(np.uint32).reshape(nused, BLK_W), base_bits


@functools.partial(jax.jit, static_argnames=("NPOOL", "S"))
def gather_frame_pool(corpus_w, lane_src, cum_dst, zero_off,
                      NPOOL: int, S: int):
    """DEVICE-side :func:`build_frame_pool`: assemble the [NPOOL, BLK_W]
    BE-word pool by gathering each lane's frame bytes out of a
    device-resident corpus (every stream's raw bytes concatenated and
    uploaded ONCE per group), instead of memcpy-ing them into a host
    pool and re-uploading per window.  The host's per-window work drops
    to building two tiny index arrays; the corpus bytes cross the wire
    exactly once (h2d == compressed bytes, same as the host pool path,
    minus the per-window re-staging).

    corpus_w:  [Nw] u32 — the padded corpus viewed as LITTLE-endian
               words (a free numpy .view on the host, no byteswap
               pass); at least 2 trailing zero blocks.
    lane_src:  [S] i32 — absolute corpus BYTE offset of each lane's
               frame (pad lanes: zero_off).
    cum_dst:   [S+1] i32 — cumulative destination block counts
               (cum_dst[i] = first pool block of lane i; pad lanes
               repeat cum_dst[n_live]).
    zero_off:  i32 — byte offset of a guaranteed-zero block (corpus
               tail padding).

    Frames start at arbitrary byte offsets, so each output word k of a
    block gathers TWO adjacent LE corpus words and funnel-shifts:
    bytes[b..b+3] as a BE word == bswap32(lo >> 8r | hi << (32-8r))
    where b = 4q + r.  Beyond-frame-end tail bytes inside a lane's last
    block carry neighbouring corpus bytes rather than the host pool's
    zeros — the Rice FSM consumes only content-addressed bits < the
    frame's end, so decode results are identical (A/B-tested); blocks
    past cum_dst[-1] read the zero block, preserving the kernel's
    window-overrun guard contract."""
    blk_b = BLK_W * 4
    k = jnp.arange(NPOOL, dtype=jnp.int32)
    j = jnp.clip(
        jnp.searchsorted(cum_dst, k, side="right") - 1, 0, S - 1)
    live = k < cum_dst[S]
    src0 = jnp.where(
        live, lane_src[j] + (k - cum_dst[j]) * blk_b, zero_off)
    q0 = src0 >> 2                      # first LE word of the block
    r = (src0 & 3).astype(jnp.uint32)[:, None] << 3   # funnel shift bits
    idx = q0[:, None] + jnp.arange(BLK_W + 1, dtype=jnp.int32)[None, :]
    w = corpus_w[idx]                    # [NPOOL, BLK_W+1] u32 LE
    lo, hi = w[:, :BLK_W], w[:, 1:]
    # r == 0 guard: a uint32 shift by 32 is undefined
    le = jnp.where(r == 0, lo,
                   (lo >> r) | (hi << (jnp.uint32(32) - r)))
    return (((le & 0xFF) << 24) | ((le & 0xFF00) << 8)
            | ((le >> 8) & 0xFF00) | (le >> 24))


def gather_pool_meta(stream_base, lanes, S: int, zero_off: int):
    """Host prep for :func:`gather_frame_pool`: (lane_src [S] i32,
    cum_dst [S+1] i32, base_bits [n] i64) from the scheduler's lane
    tuples (bi, byte_off, nbytes, ...).  int32-safe only while the
    corpus stays under 2 GiB (checked by the caller at corpus build)."""
    blk_b = BLK_W * 4
    n = len(lanes)
    nblk = np.fromiter((-(-p[2] // blk_b) for p in lanes), np.int64, n)
    cum = np.zeros(S + 1, np.int32)
    cum[1 : n + 1] = np.cumsum(nblk)
    cum[n + 1 :] = cum[n]
    lane_src = np.full(S, zero_off, np.int32)
    lane_src[:n] = np.fromiter(
        (stream_base[p[0]] + p[1] for p in lanes), np.int64, n)
    base_bits = cum[:n].astype(np.int64) * (blk_b * 8)
    return lane_src, cum, base_bits


def pad_pool(pool_dev, NPOOL: int):
    """Zero-pad an uploaded exact-size pool to the kernel's [NPOOL,
    BLK_W] shape on device (the trailing zero blocks double as the
    window-overrun guard).  Runs outside jit as one tiny memset+copy."""
    n = pool_dev.shape[0]
    if n >= NPOOL:
        return pool_dev[:NPOOL]
    return jnp.pad(pool_dev, ((0, NPOOL - n), (0, 0)))


@functools.partial(
    jax.jit, static_argnames=("L", "NSAMP", "nch", "NPOOL"))
def flac_frame_entropy(blocks, start_bits, bs, bps0, chass,
                       L: int, NSAMP: int, nch: int, NPOOL: int):
    """Decode subframe headers + residuals for L frame lanes.

    blocks:     [NPOOL, BLK_W] u32 BE words — the SHARED frame pool
                (build_frame_pool): every lane's raw frame bytes at a
                BLK-aligned offset; the last two blocks must be zeros
                (window overrun guard).
    start_bits: [L] ABSOLUTE pool bit of subframe 0 (frame base bit +
                header length).
    bs:         [L] block size; bps0: [L] frame sample bits; chass: [L]
                channel assignment (af_flac_parse_frame meta[1]).

    Returns dict with residual [L, nch, NSAMP] i32 (warm-ups in
    [0, order) as af_flac_parse_frame), coeffs [L, nch, 32], order,
    shift, wasted, sub_bps [L, nch] i32, err [L] bool, end_bits [L] i32
    (ABSOLUTE cursor after the last subframe, pre byte-align).
    """
    pos = start_bits.astype(jnp.int32)
    err = jnp.zeros(L, bool)

    residuals = []
    coeffs_out = []
    order_out = []
    shift_out = []
    wasted_out = []
    bps_out = []

    max_pos = jnp.int32((NPOOL - 2) * BLK_BITS - 64)

    for ci in range(nch):
        # ---------------- subframe header phase (one window gather) ----
        buf, base = _gather_window(blocks, pos, NPOOL)
        lp = pos - base                       # local bit cursor

        sub_bps = bps0 + jnp.where(
            ((chass == 8) | (chass == 10)) & (ci == 1), 1,
            jnp.where((chass == 9) & (ci == 0), 1, 0))
        hdr = _read(buf, lp, 8).astype(jnp.int32)
        lp = lp + 8
        err = err | ((hdr & 0x80) != 0)   # pad bit must be zero
        t = (hdr & 0x7E) >> 1
        # wasted bits: unary(+1) when the flag bit is set
        a, b, c = _sel3(buf, lp >> 5)
        uq, q64 = _clz_window(a, b, c, lp & 31)
        has_w = (hdr & 1) == 1
        wasted = jnp.where(has_w, uq + 1, 0)
        err = err | (has_w & q64)
        lp = lp + jnp.where(has_w, uq + 1, 0)
        err = err | (wasted >= sub_bps)
        sub_bps = jnp.maximum(sub_bps - wasted, 1)

        is_const = t == 0
        is_verb = t == 1
        is_lpc = (t & 0x20) != 0
        is_fixed = ((t & 0x08) != 0) & ~is_lpc
        err = err | (~(is_const | is_verb | is_lpc | is_fixed))
        order = jnp.where(is_lpc, (t & 0x1F) + 1,
                          jnp.where(is_fixed, t & 0x07, 0))
        err = err | (is_fixed & (order > 4))

        # constant: one value
        cval = _sext(_read(buf, lp, sub_bps), sub_bps)
        lp = lp + jnp.where(is_const, sub_bps, 0)

        # warm-up samples (fixed/lpc; order <= 32) — fori keeps the
        # graph small (compile time + executable size; the loop itself
        # is 32 tiny masked reads)
        need_warm = is_lpc | is_fixed

        def _warm_body(i, st):
            warm, lp = st
            take = need_warm & (i < order)
            v = jnp.where(take, _sext(_read(buf, lp, sub_bps), sub_bps),
                          0)
            return warm.at[:, i].set(v), \
                lp + jnp.where(take, sub_bps, 0)

        warm, lp = jax.lax.fori_loop(
            0, 32, _warm_body, (jnp.zeros((L, 32), jnp.int32), lp))

        # LPC precision/shift/coeffs
        prec = _read(buf, lp, 4).astype(jnp.int32)
        err = err | (is_lpc & (prec == 15))
        prec = prec + 1
        lp = lp + jnp.where(is_lpc, 4, 0)
        shv = _sext(_read(buf, lp, 5), 5)
        shv = jnp.maximum(shv, 0)
        lp = lp + jnp.where(is_lpc, 5, 0)
        def _coef_body(j, st):
            cf, lp = st
            take = is_lpc & (j < order)
            v = jnp.where(take, _sext(_read(buf, lp, prec), prec), 0)
            return cf.at[:, j].set(v), lp + jnp.where(take, prec, 0)

        cf, lp = jax.lax.fori_loop(
            0, 32, _coef_body, (jnp.zeros((L, 32), jnp.int32), lp))
        fixed_cf = jnp.take(
            jnp.asarray(_FIXED_COEF), jnp.clip(order, 0, 4), axis=0)
        cf = jnp.where(is_fixed[:, None],
                       jnp.pad(fixed_cf, ((0, 0), (0, 28))), cf)
        shv = jnp.where(is_lpc, shv, 0)

        # residual coding method + partition order + first parameter
        has_res = is_lpc | is_fixed
        method = _read(buf, lp, 2).astype(jnp.int32)
        err = err | (has_res & (method > 1))
        lp = lp + jnp.where(has_res, 2, 0)
        pbits = jnp.where(method == 0, 4, 5)
        escape = (jnp.int32(1) << pbits) - 1
        po = _read(buf, lp, 4).astype(jnp.int32)
        lp = lp + jnp.where(has_res, 4, 0)
        base_n = bs >> po
        cnt0 = base_n - order
        err = err | (has_res & (cnt0 < 0))
        # first partition parameter
        pr = _read(buf, lp, pbits).astype(jnp.int32)
        lp = lp + jnp.where(has_res, pbits, 0)
        esc0 = has_res & (pr == escape)
        nb0 = _read(buf, lp, 5).astype(jnp.int32)
        lp = lp + jnp.where(esc0, 5, 0)

        # verbatim rides the scan as one raw-mode pseudo-partition
        mode = jnp.where(is_verb | esc0, 1, 0)       # 1 = raw n-bit
        kpar = jnp.where(is_verb, sub_bps, jnp.where(esc0, nb0, pr))
        cnt = jnp.where(is_verb, bs, cnt0)
        wcount = jnp.where(has_res, order, 0)        # scan sample offset
        n_scan = jnp.where(is_const | err, 0,
                           jnp.where(is_verb, bs, bs - order))
        pbits_l = jnp.where(has_res, pbits, 0)       # 0: no crossings

        pos = base + lp

        # ---------------- residual scan (K_SAMP per rebase) -----------
        nblk = -(-NSAMP // K_SAMP)

        def body(carry, s0):
            pos, mode, kpar, cnt, err = carry
            posc = jnp.clip(pos, 0, max_pos)
            buf, base = _gather_window(blocks, posc, NPOOL)
            lp = posc - base
            outs = []
            for j in range(K_SAMP):
                s = s0 * K_SAMP + j
                act = (s < n_scan) & ~err
                # partition crossing (count exhausted)
                cross = act & (cnt == 0) & (pbits_l > 0)
                pr = _read(buf, lp, pbits_l).astype(jnp.int32)
                lp = lp + jnp.where(cross, pbits_l, 0)
                esc = cross & (pr == escape)
                nb = _read(buf, lp, 5).astype(jnp.int32)
                lp = lp + jnp.where(esc, 5, 0)
                mode = jnp.where(cross, jnp.where(esc, 1, 0), mode)
                kpar = jnp.where(cross, jnp.where(esc, nb, pr), kpar)
                cnt = jnp.where(cross, base_n, cnt)
                # rice: unary + k remainder; raw: n-bit signed
                a, b, c = _sel3(buf, lp >> 5)
                sh = lp & 31
                q, q64 = _clz_window(a, b, c, sh)
                err = err | (act & (mode == 0) & q64)
                rice_off = lp + q + 1
                rem = _read(buf, rice_off, kpar)
                u = (_u32(q) << (_u32(kpar) & jnp.uint32(31))
                     ) | jnp.where(kpar > 0, rem, jnp.uint32(0))
                ui = u.astype(jnp.int32)
                vr = (ui >> 1) ^ -(ui & 1)
                raw = _extract32(a, b, c, sh, kpar)
                vw = _sext(raw, kpar)
                is_raw = mode == 1
                v = jnp.where(is_raw,
                              jnp.where(kpar > 0, vw, 0), vr)
                adv = jnp.where(is_raw, kpar, q + 1 + kpar)
                lp = lp + jnp.where(act, adv, 0)
                cnt = cnt - jnp.where(act & (pbits_l > 0), 1, 0)
                outs.append(jnp.where(act, v, 0))
            pos = base + lp
            return ((pos, mode, kpar, cnt, err),
                    jnp.stack(outs, axis=-1))

        (pos, mode, kpar, cnt, err), RS = jax.lax.scan(
            body, (pos, mode, kpar, cnt, err),
            jnp.arange(nblk, dtype=jnp.int32))
        rs = jnp.swapaxes(RS, 0, 1).reshape(L, nblk * K_SAMP)[:, :NSAMP]

        # assemble: [warm-ups | residuals] with the dynamic order offset
        # wcount = LPC order <= 32, so 6 roll stages suffice
        rs = _roll_right(rs, wcount, 6)
        iota = jnp.arange(NSAMP, dtype=jnp.int32)[None, :]
        warm_exp = jnp.pad(warm, ((0, 0), (0, NSAMP - 32))) \
            if NSAMP > 32 else warm[:, :NSAMP]
        res = jnp.where(iota < wcount[:, None], warm_exp, rs)
        res = jnp.where(is_const[:, None], cval[:, None], res)
        res = jnp.where(iota < bs[:, None], res, 0)

        residuals.append(res)
        coeffs_out.append(cf)
        # constant/verbatim report order == blocksize (pass-through LPC)
        order_out.append(jnp.where(is_const | is_verb, bs, order))
        shift_out.append(shv)
        wasted_out.append(wasted)
        bps_out.append(sub_bps)

    return {
        "residual": jnp.stack(residuals, axis=1),
        "coeffs": jnp.stack(coeffs_out, axis=1),
        "order": jnp.stack(order_out, axis=1),
        "shift": jnp.stack(shift_out, axis=1),
        "wasted": jnp.stack(wasted_out, axis=1),
        "sub_bps": jnp.stack(bps_out, axis=1),
        "err": err,
        "end_bits": pos,
    }
