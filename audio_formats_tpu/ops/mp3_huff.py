"""Device-side MP3 Layer III Huffman stage — entropy decode ON the device.

Parity target: the big-values / count1 loops of minimp3's L3_huffman
(minimp3.d:748-883), mirrored bit-exactly against this repo's C host stage
(af_host.cc:af_mp3_huffman), which tests A/B against the Python reference.

Why on device: it shrinks the host→device upload.  Shipping the
dequantized spectrum costs ~350 KB per audio-second
(f32, stereo); shipping the raw Huffman bit regions costs the compressed
size (~20 KB/s) plus ~100 B/lane of side info.  The host then shrinks to
header walk + reservoir splice + scalefactor decode, and the serial bit
work runs as a *vectorized multi-lane FSM*: every granule-channel is an
independent bitstream (part_23_length gives each its own region), so a
batch window yields tens of thousands of lanes advancing in lockstep.

Design constraints (chosen for the previous accelerator, where element
gathers were slow; whether a plain gather is faster on the GPU is not
measured yet):
* NO per-lane table gathers anywhere.
* Word access uses a one-hot select over the lane's word row
  (compare+select).
* Table lookup uses INTERVAL SUMS: each codeword of a Huffman table owns
  one interval of the left-aligned 19-bit peek space (prefix codes tile
  it), so (code_length, x, y) are piecewise-constant in
  key = code_table_id·2^19 + peek and evaluate as
      Σ_r (key ≥ start_r) · Δ_r
  — pure compare/multiply-add across lanes.  The 32 spec tables dedupe to
  15 distinct non-empty code tables (the two linbits families share
  codes); the per-window set of PRESENT tables is a static jit argument,
  so typical windows sum over a few hundred breakpoints only.
* Per-sfb gains arrive as int16 quarter-exponents (gain = 2^(e/4) exactly —
  see af_host.cc:mp3_scalefactors_q) and expand to 576 coefficients with a
  0/1 band matrix matmul (exact in f32).
* The short-block reorder (minimp3.d:984-1000) is a permutation from a
  small static pattern set — applied as a permutation MATMUL (exact: each
  output is 1.0·input), never a gather.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.tables import mp3_tables as T

LANE_WORDS = 132  # must match af_host.cc AF_MP3_LANE_WORDS
N_PATTERNS = 48   # kind(0..2)*16 + sr_idx_my(0..8)


# --------------------------------------------------------------- code tables
def _build_code_tables():
    """Dedupe the 32 big-values tables into distinct code tables and build
    interval breakpoints (start19, length, x*16+y) for each."""
    code_id = np.zeros(34, np.int32)
    lin = np.zeros(34, np.int32)
    lin[:32] = np.asarray(T.LINBITS, np.int32)
    distinct = []  # list of breakpoint arrays (start, len, xy)
    keymap = {}
    for t in range(32):
        codes = T.HUFF_TABLES[t]
        key = tuple(map(tuple, codes)) if codes else ()
        if key not in keymap:
            if not codes:
                bps = np.array([[0, 0, 0]], np.int64)  # empty: len 0, v 0
            else:
                rows = []
                for code, ln, x, y in codes:
                    rows.append((code << (19 - ln), ln, x * 16 + y))
                rows.sort()
                # completeness: intervals must tile [0, 2^19) — guarantees
                # the interval-sum decode never needs a gap sentinel
                pos = 0
                for start, ln, xy in rows:
                    assert start == pos, f"table {t}: gap at {pos}"
                    pos += 1 << (19 - ln)
                assert pos == 1 << 19, f"table {t}: incomplete"
                bps = np.array(rows, np.int64)
            keymap[key] = len(distinct)
            distinct.append(bps)
        code_id[t] = keymap[key]
    # count1 tables: 6-bit space, ids appended after the big tables
    c1 = []
    for codes in (T.COUNT1_A, T.COUNT1_B):
        rows = sorted((code << (6 - ln), ln, v) for code, ln, v in codes)
        pos = 0
        for s, ln, v in rows:
            assert s == pos
            pos += 1 << (6 - ln)
        assert pos == 64
        c1.append(np.array(rows, np.int64))
    return code_id, lin, distinct, c1


CODE_ID, LINBITS_TAB, CODE_TABLES, COUNT1_TABLES = _build_code_tables()


def _breakpoints_for(cids):
    """Concatenate the breakpoint sets of the given code-table ids over the
    key space key = rank(cid)·2^19 + peek and convert values to deltas
    (Σ_r (key ≥ s_r)·Δ_r reproduces the piecewise-constant table).

    (code_length, xy) PACK into one value ln + (xy << 5): both components
    are non-negative at every breakpoint and ln < 32, so the packed delta
    sum telescopes to the packed value exactly — ONE interval sum per step
    instead of two (the sum is the R-linear dominant cost of the FSM)."""
    starts, packs = [], []
    for rank, cid in enumerate(cids):
        bps = CODE_TABLES[cid]
        starts.append(bps[:, 0] + (rank << 19))
        packs.append(bps[:, 1] + (bps[:, 2] << 5))
    starts = np.concatenate(starts)
    packs = np.concatenate(packs).astype(np.int32)
    d_pack = np.diff(packs, prepend=0).astype(np.int32)
    return starts.astype(np.int32), d_pack


def _build_count1_breakpoints():
    """count1 deltas, packed as ln + (vmask << 3) (ln <= 6, vmask <= 15)."""
    starts, packs = [], []
    for rank, bps in enumerate(COUNT1_TABLES):
        starts.append(bps[:, 0] + (rank << 6))
        packs.append(bps[:, 1] + (bps[:, 2] << 3))
    starts = np.concatenate(starts).astype(np.int32)
    packs = np.concatenate(packs).astype(np.int32)
    return starts, np.diff(packs, prepend=0).astype(np.int32)


C1_STARTS, C1_DPACK = _build_count1_breakpoints()


# ------------------------------------------------------------------ patterns
def _sfb_widths(pattern: int):
    """Band widths for pattern = kind*16 + sr_idx_my (af_host.cc layout)."""
    kind, sr_my = divmod(pattern, 16)
    if sr_my > 8:
        return None
    sr = sr_my - (sr_my != 0)  # collapsed index (mp3_side_info)

    def _pad(a, stride):
        a = np.asarray(a, np.int32)
        full = 8 * stride
        if a.size < full:  # tables are zero-terminated; pad the flat tail
            a = np.concatenate([a, np.zeros(full - a.size, np.int32)])
        return a.reshape(8, stride)

    L = _pad(T.SCF_LONG, 23)
    S = _pad(T.SCF_SHORT, 40)
    M = _pad(T.SCF_MIXED, 40)
    if kind == 0:
        tab, n_long, n_short = L[sr], 22, 0
    elif kind == 1:
        tab, n_long, n_short = S[sr], 0, 39
    elif kind == 2:
        tab, n_long, n_short = M[sr], (8 if sr_my >= 6 else 6), 30
    else:
        return None
    nb = n_long + n_short
    widths = [int(x) for x in tab[:nb]]
    # zero-terminated tables may end earlier
    while widths and widths[-1] == 0:
        widths.pop()
    return widths, n_long, n_short, kind, sr_my


def _build_patterns():
    band_idx = np.full((N_PATTERNS, 576), 39, np.int32)
    band_of_pair = np.full((N_PATTERNS, 288), 39, np.int32)
    total_w = np.zeros(N_PATTERNS, np.int32)
    perm = np.tile(np.arange(576, dtype=np.int32), (N_PATTERNS, 1))
    for p in range(N_PATTERNS):
        info = _sfb_widths(p)
        if info is None:
            continue
        widths, n_long, n_short, kind, sr_my = info
        pos = 0
        for b, w in enumerate(widths):
            band_idx[p, pos : pos + w] = b
            pos += w
        total_w[p] = pos
        band_of_pair[p] = band_idx[p, ::2][:288]
        if n_short:
            # reorder permutation (models/mp3.py _reorder_perm_full;
            # minimp3.d:984-1000): new[i] = old[perm[i]]
            n_long_bands = 0
            if kind == 2:
                n_long_bands = 4 if sr_my == 2 else 2
            pm = np.arange(576, dtype=np.int32)
            src = n_long_bands * 18
            dst = src
            sfb = widths[n_long:] + [0, 0, 0]
            i = 0
            while sfb[i]:
                ln = sfb[i]
                stop = False
                for j in range(ln):
                    if dst + 3 > 576 or src + 2 * ln + j >= 576:
                        stop = True
                        break
                    pm[dst] = src + j
                    pm[dst + 1] = src + ln + j
                    pm[dst + 2] = src + 2 * ln + j
                    dst += 3
                if stop:
                    break
                src += 3 * ln
                i += 3
            perm[p] = pm
    return band_idx, band_of_pair, total_w, perm


BAND_IDX, BAND_OF_PAIR, TOTAL_W, PERM = _build_patterns()

#: patterns whose reorder permutation is not the identity
SHORT_PATTERNS = tuple(
    int(p) for p in range(N_PATTERNS)
    if not np.array_equal(PERM[p], np.arange(576))
)


def _band_matrix(p: int) -> np.ndarray:
    """[40 band, 576 pos] 0/1 matrix: scf @ E expands per-band values to
    per-position (each column one-hot ⇒ the f32 matmul is exact)."""
    e = np.zeros((40, 576), np.float32)
    e[np.clip(BAND_IDX[p], 0, 39), np.arange(576)] = 1.0
    return e


# ------------------------------------------------------------- bit plumbing
def _u32(x):
    return x.astype(jnp.uint32)


def _sel3(rows, w0):
    """One-hot select words w0, w0+1, w0+2 from each lane's row (NO gather:
    compare+select over the row axis)."""
    W = rows.shape[1]
    d = jnp.arange(W, dtype=jnp.int32)[None, :] - w0[:, None]
    z = jnp.uint32(0)
    a = jnp.sum(jnp.where(d == 0, rows, z), axis=1, dtype=jnp.uint32)
    b = jnp.sum(jnp.where(d == 1, rows, z), axis=1, dtype=jnp.uint32)
    c = jnp.sum(jnp.where(d == 2, rows, z), axis=1, dtype=jnp.uint32)
    return a, b, c


def _shift64(a, b, o):
    """Left-align bit offset o (0..31) of the 64-bit window a‖b; returns the
    32 bits starting at o."""
    return (a << o) | ((b >> (31 - o)) >> 1)


def _extract(a, b, c, o, width):
    """bits [o, o+width) of the 96-bit window a‖b‖c, o in [0, 96-width),
    width in [0, 19]; returns 0 when width == 0."""
    zero = jnp.zeros_like(a)
    for _ in range(2):  # normalize o into [0, 32) by sliding the window
        big = o >= 32
        a, b, c = (jnp.where(big, b, a), jnp.where(big, c, b),
                   jnp.where(big, zero, c))
        o = o - jnp.where(big, 32, 0)
    hi = _shift64(a, b, o.astype(jnp.uint32))
    w = width.astype(jnp.uint32) if hasattr(width, "astype") \
        else jnp.uint32(width)
    val = hi >> ((jnp.uint32(32) - w) & jnp.uint32(31))
    return jnp.where(w > 0, val, jnp.uint32(0))


_SUM_CHUNK = 64  # reduction chunk: a [L, R] compare intermediate past a
# fusion threshold is materialized to device memory; chunking the reduction
# through a fori_loop keeps every [L, 64] slab fused (a Python-unrolled
# chunk loop is re-fused into the materialized form).  The value was tuned
# on the previous accelerator and is not re-measured on the GPU.


def _interval_sum(key, starts, d_pack):
    """ONE packed sum: Σ_r (key >= s_r)·Δ_r, telescoping to the packed
    (ln, payload) value — this sum is the FSM's dominant cost term.
    Bit-exact regardless of chunking: integer additions in chunk order."""
    R = starts.shape[0]
    if R <= _SUM_CHUNK:
        ge = key[:, None] >= starts[None, :]
        return jnp.sum(jnp.where(ge, d_pack[None, :], 0), axis=1)
    n_chunks = -(-R // _SUM_CHUNK)
    pad = n_chunks * _SUM_CHUNK - R
    if pad:  # ZERO deltas make any taken pad breakpoint a no-op (the
        # large start value alone would not: a key == INT32_MAX takes it)
        starts = jnp.concatenate(
            [starts, jnp.full(pad, 0x7FFFFFFF, starts.dtype)])
        d_pack = jnp.concatenate([d_pack, jnp.zeros(pad, d_pack.dtype)])
    sr = starts.reshape(n_chunks, _SUM_CHUNK)
    dr = d_pack.reshape(n_chunks, _SUM_CHUNK)

    def body(c, acc):
        ge = key[:, None] >= sr[c][None, :]
        return acc + jnp.sum(jnp.where(ge, dr[c][None, :], 0), axis=1)

    return jax.lax.fori_loop(0, n_chunks, body, jnp.zeros_like(key))


# --------------------------------------------------------------- the decoder
R_BUCKETS = (64, 128, 256, 384, 512, 640, 768, 1024, 1536)
_BP_CACHE = {}


def breakpoints_for_window(cids):
    """Host-side: concatenated breakpoint arrays for the window's distinct
    code tables, padded to a static R bucket (so the compiled program is
    reused across windows with different table sets — the breakpoints are
    RUNTIME data, only their padded length is static).  Returns
    (starts i32[R], d_pack i32[R], rank_of_table i32[32])."""
    key = tuple(sorted(cids))
    hit = _BP_CACHE.get(key)
    if hit is not None:
        return hit
    starts_np, dpack_np = _breakpoints_for(key)
    R = next((r for r in R_BUCKETS if starts_np.size <= r), starts_np.size)
    pad = R - starts_np.size
    starts_np = np.concatenate(
        [starts_np, np.full(pad, np.int32(0x7FFFFFFF), np.int32)])
    # (pad entries carry ZERO deltas — that, not the large start value,
    # is what keeps a taken pad breakpoint harmless)
    dpack_np = np.concatenate([dpack_np, np.zeros(pad, np.int32)])
    rank_of = np.zeros(len(CODE_TABLES), np.int32)
    for r, c in enumerate(key):
        rank_of[c] = r
    out = (starts_np, dpack_np, rank_of[CODE_ID[:32]])
    _BP_CACHE[key] = out
    return out


@functools.partial(
    jax.jit,
    static_argnames=("pats", "W", "NBIG", "NC1"),
)
def huff_decode(rows, bit_start, bit_limit, bv, bnd0, bnd1,
                rank0, rank1, rank2, lin0, lin1, lin2, c1tab, pattern,
                starts, d_pack,
                pats: tuple, W: int, NBIG: int, NC1: int):
    """Decode big-values + count1 for L independent lanes (jit wrapper
    over ``_huff_core`` — see it for the argument contract)."""
    return _huff_core(rows, bit_start, bit_limit, bv, bnd0, bnd1,
                      rank0, rank1, rank2, lin0, lin1, lin2, c1tab,
                      pattern, starts, d_pack,
                      pats=pats, W=W, NBIG=NBIG, NC1=NC1)


def _huff_core(rows, bit_start, bit_limit, bv, bnd0, bnd1,
               rank0, rank1, rank2, lin0, lin1, lin2, c1tab, pattern,
               starts, d_pack,
               pats: tuple, W: int, NBIG: int, NC1: int):
    """Decode big-values + count1 for L independent lanes.

    rows:      [L, >=W] uint32 big-endian words (lane bit regions)
    bit_start: [L] first Huffman bit;  bit_limit: [L] one past the region
    bv:        [L] big_values (pairs); bnd0/bnd1: [L] region band bounds
    rank0..2:  [L] per-region code-table RANK within this window's
               breakpoint set (host maps table id -> rank)
    lin0..2:   [L] per-region linbits; c1tab: [L] count1 table (0/1)
    pattern:   [L] sfb pattern id (kind*16 + sr_idx_my)
    starts/d_pack: [R] window breakpoint arrays (runtime data, padded
               to a static R bucket by breakpoints_for_window; values
               pack ln + (xy << 5))
    pats:      static tuple of pattern ids present (sample-rate-dependent,
               so the variant count stays tiny)
    W, NBIG, NC1: static row width / big-value steps / count1 steps

    Returns (q [L, 576] int32, err [L] bool).
    """
    L = rows.shape[0]
    rows = _u32(rows[:, :W])

    bop = {p: jnp.asarray(BAND_OF_PAIR[p]) for p in pats}
    tw = jnp.zeros(L, jnp.int32)
    for p in pats:
        tw = tw + jnp.where(pattern == p, np.int32(TOTAL_W[p]), 0)

    max_pos = jnp.int32((W - 3) * 32)

    def big_step(carry, i):
        pos, err = carry
        active = i < bv
        band = jnp.zeros(L, jnp.int32)
        for p in pats:
            band = band + jnp.where(pattern == p, bop[p][i], 0)
        in1 = band >= bnd0
        in2 = band >= bnd1
        rank = jnp.where(in2, rank2, jnp.where(in1, rank1, rank0))
        linb = jnp.where(in2, lin2, jnp.where(in1, lin1, lin0))
        w0 = (pos >> 5).astype(jnp.int32)
        a, b, c = _sel3(rows, w0)
        sh = _u32(pos) & jnp.uint32(31)
        peek = _shift64(a, b, sh) >> jnp.uint32(13)
        key = (_u32(rank) << jnp.uint32(19)) | peek
        pk = _interval_sum(key.astype(jnp.int32), starts, d_pack)
        ln = pk & 31
        xy = pk >> 5
        x = xy >> 4
        y = xy & 15
        lx = jnp.where(x == 15, linb, 0)
        o = sh.astype(jnp.int32) + ln
        xlin = _extract(a, b, c, o, lx).astype(jnp.int32)
        xv = x + xlin
        o = o + lx
        px = (xv != 0).astype(jnp.int32)
        xneg = (_extract(a, b, c, o, px) == 1) & (px == 1)
        o = o + px
        ly = jnp.where(y == 15, linb, 0)
        ylin = _extract(a, b, c, o, ly).astype(jnp.int32)
        yv = y + ylin
        o = o + ly
        py = (yv != 0).astype(jnp.int32)
        yneg = (_extract(a, b, c, o, py) == 1) & (py == 1)
        o = o + py
        adv = o - sh.astype(jnp.int32)
        pos = jnp.minimum(pos + jnp.where(active, adv, 0), max_pos)
        # complete tables have no gaps: ln==0 only on the empty table
        # (x=y=0, consumes nothing) — that is minimp3's table-0 behavior
        # i16 outputs: |value| <= 15 + 2^13 (linbits) = 8207, and the
        # narrower stacked [NBIG, L] planes halve the assembly traffic
        outx = jnp.where(active, jnp.where(xneg, -xv, xv), 0) \
            .astype(jnp.int16)
        outy = jnp.where(active, jnp.where(yneg, -yv, yv), 0) \
            .astype(jnp.int16)
        return (pos, err), (outx, outy)

    pos0 = bit_start.astype(jnp.int32)
    err0 = jnp.zeros(L, bool)
    # unroll: the scan body is small relative to per-iteration loop
    # overhead (x4 chosen on the previous accelerator)
    (pos, err), (X, Y) = jax.lax.scan(
        big_step, (pos0, err0), jnp.arange(NBIG, dtype=jnp.int32),
        unroll=4,
    )
    qb = jnp.stack([X, Y], axis=-1)          # [NBIG, L, 2]
    qb = jnp.swapaxes(qb, 0, 1).reshape(L, NBIG * 2)
    if NBIG * 2 < 576:
        qb = jnp.pad(qb, ((0, 0), (0, 576 - NBIG * 2)))

    # ---- count1 ----
    c1_starts = jnp.asarray(C1_STARTS)
    c1_dpack = jnp.asarray(C1_DPACK)

    def c1_step(carry, j):
        pos, stopped = carry
        s0 = 2 * bv + 4 * j
        act = (~stopped) & (s0 <= 572)
        w0 = (pos >> 5).astype(jnp.int32)
        a, b, c = _sel3(rows, w0)
        sh = _u32(pos) & jnp.uint32(31)
        peek = _shift64(a, b, sh) >> jnp.uint32(26)
        key = (c1tab << 6) | peek.astype(jnp.int32)
        pk = _interval_sum(key, c1_starts, c1_dpack)
        ln = pk & 7
        vmask = pk >> 3
        newpos = pos + ln
        bit_ok = newpos <= bit_limit
        act = act & bit_ok
        p0ok = act & (s0 < tw)
        p1ok = act & (s0 + 2 < tw)
        o = sh.astype(jnp.int32) + ln
        outs = []
        for s in range(4):
            pv = p0ok if s < 2 else p1ok
            hasbit = ((vmask >> (3 - s)) & 1) == 1
            take = pv & hasbit
            sbit = _extract(a, b, c, o, take.astype(jnp.int32))
            outs.append(jnp.where(
                take, jnp.where(sbit == 1, -1, 1), 0).astype(jnp.int8))
            o = o + take.astype(jnp.int32)
        pos = jnp.minimum(
            jnp.where(act, pos + (o - sh.astype(jnp.int32)), pos), max_pos
        )
        stopped = stopped | (~bit_ok) | (s0 + 2 >= tw)
        # four SEPARATE [L] planes: a per-step [L, 4] stack padded its
        # writes 32x on the previous accelerator's tiling
        return (pos, stopped), tuple(outs)

    (pos, stopped), C1 = jax.lax.scan(
        c1_step, (pos, jnp.zeros(L, bool)),
        jnp.arange(NC1, dtype=jnp.int32),
        unroll=4,
    )
    # interleave the 4 planes once: [L, NC1, 4] -> [L, NC1*4]
    c1 = jnp.stack([o.T for o in C1], axis=-1).reshape(L, NC1 * 4)
    if NC1 * 4 < 576:
        c1 = jnp.pad(c1, ((0, 0), (0, 576 - NC1 * 4)))
    # place count1 output at sample offset 2·bv: binary-decomposed roll
    # (a per-lane dynamic roll would be a gather)
    off = (2 * bv) % 576
    for k in range(10):
        step = 1 << k
        if step >= 576:
            break
        c1 = jnp.where(
            ((off >> k) & 1)[:, None] == 1,
            jnp.roll(c1, step, axis=1),
            c1,
        )
    iota = jnp.arange(576, dtype=jnp.int32)[None, :]
    q = jnp.where(iota < (2 * bv)[:, None],
                  qb.astype(jnp.int32), c1.astype(jnp.int32))
    return q, err


@functools.partial(jax.jit, static_argnames=("pats",))
def dequant(q, scfq, pattern, pats: tuple):
    """sign(q)·|q|^{4/3}·2^(scf_e/4) with the per-sfb exponents expanded to
    per-position via exact 0/1 band matmuls (one per present pattern)."""
    L = q.shape[0]
    e = scfq.astype(jnp.float32)  # [L, 40] quarter-exponents
    epos = jnp.zeros((L, 576), jnp.float32)
    for p in pats:
        m = (pattern == p).astype(jnp.float32)[:, None]
        # exact at any precision (integer operands below 2^11), HIGHEST
        # like every other f32 matmul of the decode path
        epos = epos + jnp.matmul(e * m, jnp.asarray(_band_matrix(p)),
                                 precision=jax.lax.Precision.HIGHEST)
    gain = jnp.exp2(epos * 0.25)
    xf = q.astype(jnp.float32)
    mag = jnp.abs(xf)
    p43 = mag * jnp.cbrt(mag)
    return jnp.sign(xf) * p43 * gain


@functools.partial(jax.jit, static_argnames=("spats",))
def reorder_short(xq, pattern, spats: tuple):
    """Apply the short-block reorder for the present short patterns as
    STATIC column permutations + select (exact, two passes over [L, 576]
    per pattern) instead of a per-lane dynamic gather or an f32-HIGHEST
    [576,576] permutation matmul per pattern."""
    for p in spats:
        xq = jnp.where((pattern == p)[:, None],
                       jnp.take(xq, jnp.asarray(PERM[p]), axis=1), xq)
    return xq


#: n_long_bands per pattern (mixed: 2, or 4 at sr_idx_my==2; short: 0)
_NLB = np.zeros(N_PATTERNS, np.int32)
for _p in range(N_PATTERNS):
    _k, _s = divmod(_p, 16)
    if _k == 2 and _s <= 8:
        _NLB[_p] = 4 if _s == 2 else 2

WIN_NORMAL, WIN_START, WIN_SHORT, WIN_STOP = 0, 1, 2, 3


#: MPEG-1 intensity pan table (minimp3.d:930-940; models/mp3.py
#: _pan_gains), f32 of the same literals so the device mix is bit-equal
_PAN1 = np.array([0.0, 1.0, 0.21132487, 0.78867513, 0.36602540,
                  0.63397460, 0.5, 0.5, 0.63397460, 0.36602540,
                  0.78867513, 0.21132487, 1.0, 0.0], np.float32)

#: MPEG-2 pan gains 2^(-(((ipos+1)>>1) << sh)/4) precomputed in f64 then
#: cast — identical to the host's float(2.0**..) → np.float32 chain
_PAN2 = np.stack([
    np.array([np.float32(2.0 ** (-(((i + 1) >> 1) << sh) / 4.0))
              for i in range(64)], np.float32)
    for sh in range(2)
])


def _layout_info(p: int):
    widths, n_long, n_short, _kind, _sr = _sfb_widths(p)
    return n_long + n_short, len(widths), (3 if n_short else 1), n_long


def _intensity_abcd(q_r, pat_l, is_ms, t_ist, t_ms, sh, ist, *,
                    pats: tuple, mpeg1: bool):
    """Per-band stereo mix vectors [BG, 4, 40] (l' = a·l + b·r,
    r' = c·l + d·r): the device build of models/mp3.py _stereo_mix
    (minimp3.d:963-1000).  The only content-dependence — the last
    band with nonzero right-channel spectra — reduces to one one-hot
    band matmul per layout pattern; everything else is side info."""
    BG = q_r.shape[0]
    idx = jnp.arange(40, dtype=jnp.int32)[None, :]
    mb = jnp.full((BG, 3), -1, jnp.int32)
    cond_w = jnp.zeros((BG, 40), bool)
    ist_f = ist
    default_pos = jnp.int32(3 if mpeg1 else 0)
    for p in pats:
        n_sfb, n_real, max_blocks, n_long = _layout_info(p)
        sel = pat_l == p
        E = jnp.asarray(_band_matrix(p))            # [40, 576] one-hot
        # HIGHEST precision: a reduced-precision default (bf16 or TF32
        # passes) must not touch these 0/1 counts
        nz_p = jnp.matmul(
            (q_r != 0).astype(jnp.float32), E.T,
            precision=jax.lax.Precision.HIGHEST) > 0
        nzi = jnp.where(nz_p & (idx < n_sfb), idx, -1)
        if max_blocks == 3:
            mb_p = jnp.stack(
                [jnp.max(jnp.where(idx % 3 == j, nzi, -1), axis=1)
                 for j in range(3)], axis=1)
            if n_long:  # mixed blocks: collapse to the global max
                mb_p = jnp.tile(jnp.max(mb_p, axis=1)[:, None], (1, 3))
        else:
            mb_p = jnp.tile(jnp.max(nzi, axis=1)[:, None], (1, 3))
        ist_p = ist
        for i in range(max_blocks):
            # top-band default/copy-down fixups (minimp3.d:969-974)
            itop = n_sfb - max_blocks + i
            prev = itop - max_blocks
            val = jnp.where(mb_p[:, i] >= prev, default_pos,
                            ist_p[:, prev])
            ist_p = ist_p.at[:, itop].set(
                jnp.where(sel, val, ist_p[:, itop]))
        mb = jnp.where(sel[:, None], mb_p, mb)
        cond_w = jnp.where(sel[:, None], idx < n_real, cond_w)
        ist_f = jnp.where(sel[:, None], ist_p, ist_f)
    mb_band = mb[:, np.arange(40) % 3]
    max_pos = 7 if mpeg1 else 64
    cond = (idx > mb_band) & (ist_f < max_pos) & cond_w
    if mpeg1:
        pan = jnp.asarray(_PAN1)
        ic = jnp.clip(ist_f, 0, 6)
        kl = pan[2 * ic]
        kr = pan[2 * ic + 1]
    else:
        pan2 = jnp.asarray(_PAN2)
        kv = pan2[sh[:, None], jnp.clip(ist_f, 0, 63)]
        odd = (ist_f & 1) == 1
        kl = jnp.where(odd, kv, jnp.float32(1.0))
        kr = jnp.where(odd, jnp.float32(1.0), kv)
    s = jnp.where(t_ms, jnp.float32(1.41421356),
                  jnp.float32(1.0))[:, None]
    one = jnp.ones((BG, 40), jnp.float32)
    zero = jnp.zeros((BG, 40), jnp.float32)
    ti = t_ist[:, None]
    im = is_ms[:, None]
    msb = t_ms[:, None] & cond_w   # ms fallback only over real bands
    a = jnp.where(ti, jnp.where(cond, kl * s, one), one)
    b = jnp.where(ti, jnp.where(cond, zero, jnp.where(msb, one, zero)),
                  jnp.where(im, one, zero))
    c = jnp.where(ti, jnp.where(cond, kr * s, jnp.where(msb, one, zero)),
                  jnp.where(im, one, zero))
    d = jnp.where(ti, jnp.where(cond, zero, jnp.where(msb, -one, one)),
                  jnp.where(im, -one, one))
    return jnp.stack([a, b, c, d], axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("pats", "spats", "W", "NBIG", "NC1",
                     "B", "G", "nch", "mpeg1"),
)
def packed_device_stage(bits, meta16, scfq, starts, d_pack,
                        pats: tuple, spats: tuple,
                        W: int, NBIG: int, NC1: int,
                        B: int, G: int, nch: int,
                        ist=None, mpeg1: bool = True):
    """The full device entropy stage for one batch window: Huffman FSM →
    dequant → short-block reorder → mid/side mix → window-type/antialias
    metadata — everything mp3_window_dsp needs, built on device from
    ~100 bytes of side info per lane.

    bits:   [L, W] uint32 lane bit rows (L = B·G·nch)
    meta16: [L, 15] int16 — bit_start, bit_limit, big_values, bnd0, bnd1,
            rank0, rank1, rank2, lin0, lin1, lin2, count1_table, pattern,
            ms_flag, block_type
    scfq:   [L, 40] int16 quarter-exponent gains
    starts/d_pack: the window's breakpoint arrays
            (breakpoints_for_window)

    Returns (xq [B, G, nch, 576] f32, aa [B, G, nch] i32,
             wt [B, G, nch, 32] i32).
    """
    L = B * G * nch
    cols = [meta16[:, i].astype(jnp.int32) for i in range(15)]
    (bit_start, bit_limit, bv, bnd0, bnd1, rank0, rank1, rank2,
     lin0, lin1, lin2, c1tab, pattern, ms, btype) = cols
    # (a bv-sorted segmented FSM — per-half static scan lengths with a
    # device sort/unsort — was built and A/B'd here: zero net gain, the
    # half-L scans scale sub-linearly and the gathers eat the saved
    # steps, so it was removed)
    q, _err = _huff_core(bits, bit_start, bit_limit, bv, bnd0, bnd1,
                         rank0, rank1, rank2, lin0, lin1, lin2,
                         c1tab, pattern, starts, d_pack,
                         pats=pats, W=W, NBIG=NBIG, NC1=NC1)
    xq = dequant(q, scfq, pattern, pats=pats)
    if nch == 2 and ist is not None:
        # intensity windows: the general per-coefficient 2x2 mix replaces
        # the MS butterfly, applied PRE-reorder (the host mix coordinates,
        # models/mp3.py:979; mix-then-perm as ops/mp3_dsp.py)
        BG = B * G
        pat_l = pattern.reshape(B, G, nch)[:, :, 0].reshape(BG)
        fl = ms.reshape(B, G, nch)[:, :, 0].reshape(BG)
        abcd = _intensity_abcd(
            q.reshape(B, G, nch, 576)[:, :, 1].reshape(BG, 576),
            pat_l, (fl & 1) == 1, (fl & 2) == 2, (fl & 4) == 4,
            (fl >> 3) & 1, ist, pats=pats, mpeg1=mpeg1)
        exp = jnp.zeros((BG, 4, 576), jnp.float32)
        for p in pats:
            # constant-index gather: bit-exact per-band -> per-coefficient
            # expansion (a default-precision matmul could round the pan
            # gains)
            idx = jnp.asarray(np.clip(BAND_IDX[p], 0, 39))
            exp = jnp.where((pat_l == p)[:, None, None],
                            jnp.take(abcd, idx, axis=2), exp)
        xq2 = xq.reshape(B, G, nch, 576)
        l = xq2[:, :, 0].reshape(BG, 576)
        r = xq2[:, :, 1].reshape(BG, 576)
        xq = jnp.stack(
            [exp[:, 0] * l + exp[:, 1] * r,
             exp[:, 2] * l + exp[:, 3] * r], axis=1).reshape(L, 576)
    if spats:
        xq = reorder_short(xq, pattern, spats=spats)
    xq = xq.reshape(B, G, nch, 576)
    if nch == 2 and ist is None:
        # col 13 carries stereo-mode bits; bit 0 is the mid/side flag
        msf = ((ms.reshape(B, G, nch)[:, :, 0] & 1) == 1)[:, :, None]
        l, r = xq[:, :, 0], xq[:, :, 1]
        xq = jnp.where(
            msf[:, :, None],
            jnp.stack([l + r, l - r], axis=2),
            xq,
        )
    # window types / antialias band counts from the pattern + block type
    is_short = jnp.zeros(L, bool)
    nlb = jnp.zeros(L, jnp.int32)
    for p in pats:
        sel = pattern == p
        kind = p // 16
        if kind in (1, 2):
            is_short = is_short | sel
            nlb = nlb + jnp.where(sel, np.int32(_NLB[p]), 0)
    base_wt = jnp.where(
        btype == 3, WIN_STOP, jnp.where(btype == 1, WIN_START, WIN_NORMAL)
    )
    band = jnp.arange(32, dtype=jnp.int32)[None, :]
    wt = jnp.where(
        is_short[:, None],
        jnp.where(band < nlb[:, None], WIN_NORMAL, WIN_SHORT),
        base_wt[:, None],
    )
    aa = jnp.where(is_short, nlb - 1, 31)
    return xq, aa.reshape(B, G, nch), wt.reshape(B, G, nch, 32)


# ------------------------------------------------------------ blob window
# Every host->device transfer pays a fixed cost, so the scheduler packs a
# whole window's payload into ONE uint32 blob (bits rows ‖ meta ‖ scf ‖
# breakpoints) and runs entropy+DSP as ONE fused jitted call: one upload,
# one execute per window.

def blob_layout(L: int, Wb: int, R: int, Lb: int = 0, Wext: int = 0,
                IST: bool = False, nch: int = 2, PB: bool = False):
    """Static u32 offsets for the window blob.

    With Lb > 0 the bit rows ship SPLIT: a tight [L, Wb] plane plus an
    overflow plane [Lb, Wext] holding words Wb.. of only the lanes whose
    bit region overflows Wb (per-lane row index rides meta col 15; row 0
    is all-zero for non-overflowing lanes).  The bit reservoir makes lane
    sizes heavy-tailed, so padding every lane to the window max (the
    Lb == 0 layout) uploads ~4x the real payload; the split plane cuts
    h2d traffic to near the compressed size.

    With PB (pooled bits) the blob carries NO bit plane at all: the lane
    bit rows ship as ONE exact-size u32 pool in a separate upload (each
    lane's span_words, concatenated in lane order; per-lane span rides
    meta col 15, so the device reconstructs every offset with a cumsum —
    zero extra wire) and the device rebuilds the padded rows with row
    gathers + a binary word-roll.  Wire cost = exactly the copied
    maindata bytes; the FLAC device-Rice path's pad-on-device trick
    (flac_rice.pad_pool) keeps NPOOLW compile buckets off the wire.

    IST windows carry one extra plane: per-granule right-channel
    intensity positions ([L/nch, 40] i16) for the device pan mix —
    windows without intensity frames pay nothing."""
    n_bits = 0 if PB else L * Wb
    n_ovf = 0 if PB else Lb * Wext
    n_meta = L * 8           # 16 int16 columns = 8 u32 per lane
    n_scf = L * 20           # 40 int16 = 20 u32
    n_ist = (L // nch) * 20 if IST else 0
    n_bp = R * 2             # (start, packed delta) per breakpoint
    total = n_bits + n_ovf + n_meta + n_scf + n_ist + n_bp
    return n_bits, n_ovf, n_meta, n_scf, n_ist, n_bp, total


#: overflow-plane row buckets (static jit arg -> keep the set tiny);
#: row indices ride an int16 meta column, so the top bucket is 32768
OVF_BUCKETS = (2048, 8192, 32768)


def pool_bucket(n_words: int) -> int:
    """Static kernel bucket for a pooled bit plane (x2 geometric: the
    bucket never rides the wire — the exact-size pool is padded to it on
    device, so coarseness costs a memset, not upload)."""
    b = 1 << 14
    while b < n_words + 16:
        b <<= 1
    return b


def pad_pool_words(pool_dev, NPOOLW: int):
    """Zero-pad an uploaded exact-size u32 pool to the kernel's bucketed
    length on device (one tiny memset+copy outside jit; the tail zeros
    double as the row-gather overrun guard)."""
    n = pool_dev.shape[0]
    if n >= NPOOLW:
        return pool_dev[:NPOOLW]
    return jnp.pad(pool_dev, (0, NPOOLW - n))


def _roll_left_words(x, amount, nbits: int = 4):
    """Per-lane LEFT roll of the word axis by a dynamic amount in
    [0, 2^nbits) via binary decomposition (scatter/gather-free)."""
    n = x.shape[1]
    for k in range(nbits):
        step = 1 << k
        if step >= n:
            break
        x = jnp.where(((amount >> k) & 1)[:, None] == 1,
                      jnp.roll(x, -step, axis=1), x)
    return x


def _rows_from_pool(pool, span, L: int, row_w: int):
    """Rebuild the padded [L, row_w] u32 lane rows from the pooled bit
    plane: per-lane word offsets are the exclusive cumsum of span (the
    host packs lanes in the same order), rows come from aligned 16-word
    ROW gathers of the pool + a binary word-roll, and words >= span are
    zeroed — reproducing the C stage's zero row tail exactly."""
    npool_rows = pool.shape[0] // 16
    pool_rows = pool[: npool_rows * 16].reshape(npool_rows, 16)
    offs = jnp.cumsum(span) - span
    nrw = (row_w + 15) // 16 + 1
    idx = (offs >> 4)[:, None] + jnp.arange(nrw, dtype=jnp.int32)[None, :]
    g = jnp.take(pool_rows, jnp.clip(idx, 0, npool_rows - 1), axis=0)
    g = _roll_left_words(g.reshape(L, nrw * 16), offs & 15)
    iw = jnp.arange(row_w, dtype=jnp.int32)[None, :]
    return jnp.where(iw < span[:, None], g[:, :row_w], jnp.uint32(0))


#: static scan-length buckets: the big-values scan runs max(bv) steps
#: and count1 the remaining-region steps; windows of typical music need
#: far fewer than the spec maxima (NBIG=288, NC1=144).  Fine granularity:
#: every step saved is a full-window step; the compile cache persists on
#: disk
NBIG_BUCKETS = (64, 96, 128, 160, 192, 224, 256, 288)
NC1_BUCKETS = (24, 48, 72, 96, 120, 144)


def scan_buckets(bv, tw):
    """Pick (NBIG, NC1) for a window from per-lane big_values and total
    region widths (both known host-side; zero for inactive lanes)."""
    bmax = int(bv.max()) if bv.size else 0
    nbig = next(n for n in NBIG_BUCKETS if bmax <= n)
    c1 = np.maximum(0, (np.minimum(tw, 576) - 2 * bv + 3) // 4) + 1
    cmax = int(c1.max()) if c1.size else 0
    nc1 = next((n for n in NC1_BUCKETS if cmax <= n), 144)
    return nbig, nc1


def bits_plan(lanew, mw_max: int, L: int, lane_words: int):
    """Pick the cheapest bit-plane layout for a window.

    lanew: [L] per-lane span in words (0 for inactive lanes)
    Returns (Ws, Lb, Wext): plain [L, Ws] rows when Lb == 0, else the
    split layout (blob_layout) with overflow rows bucketed to Lb.
    Minimizes uploaded words over the static bucket grid."""
    # the overflow plane only needs to reach the window's max bucket,
    # not the absolute LANE_WORDS ceiling
    wtop = next(w for w in (16, 24, 32, 48, 64, 96, lane_words)
                if mw_max <= w)
    plans = [(L * wtop, wtop, 0, 0)]
    for ws in (16, 24, 32, 40, 48, 64, 96):
        if mw_max <= ws:
            break
        nov = int(np.count_nonzero(lanew > ws))
        for lb in OVF_BUCKETS:
            if nov + 1 <= lb:
                plans.append(
                    (L * ws + lb * (wtop - ws), ws, lb, wtop - ws))
                break
    _, ws, lb, wext = min(plans)
    return ws, lb, wext


@functools.partial(
    jax.jit,
    static_argnames=("pats", "spats", "L", "Wb", "R", "B", "G", "nch",
                     "Lb", "Wext", "NBIG", "NC1", "IST", "MPEG1", "PW"),
)
def packed_window_blob(blob, overlap, shist, n_act,
                       pats: tuple, spats: tuple,
                       L: int, Wb: int, R: int, B: int, G: int, nch: int,
                       Lb: int = 0, Wext: int = 0,
                       NBIG: int = 288, NC1: int = 144,
                       IST: bool = False, MPEG1: bool = True,
                       pool=None, PW: int = 0):
    """One-shot MP3 window: unpack the blob, run the Huffman FSM + dequant
    + reorder + stereo mix (MS butterfly, or the general intensity 2x2
    when IST), then the scan-free window DSP.  Returns
    (pcm [B,G,nch,576], overlap', shist').

    With Lb > 0 the full bit rows are rebuilt on device from the split
    upload (see blob_layout): a row gather stitches each overflowing
    lane's tail plane back on — one [L, Wext]-element gather per window,
    far cheaper than shipping the padding over the link."""
    from . import mp3_dsp

    n_bits, n_ovf, n_meta, n_scf, n_ist, n_bp, _ = blob_layout(
        L, Wb, R, Lb, Wext, IST, nch, PB=PW > 0)
    o = 0
    if not PW:
        bits = blob[o : o + n_bits].reshape(L, Wb)
        o += n_bits
        if Lb:
            ovf = blob[o : o + n_ovf].reshape(Lb, Wext)
            o += n_ovf
    meta16 = jax.lax.bitcast_convert_type(
        blob[o : o + n_meta].reshape(L, 8), jnp.int16
    ).reshape(L, 16)
    o += n_meta
    scfq = jax.lax.bitcast_convert_type(
        blob[o : o + n_scf].reshape(L, 20), jnp.int16
    ).reshape(L, 40)
    o += n_scf
    ist = None
    if IST:
        ist = jax.lax.bitcast_convert_type(
            blob[o : o + n_ist].reshape(L // nch, 20), jnp.int16
        ).reshape(L // nch, 40).astype(jnp.int32)
        o += n_ist
    bp = jax.lax.bitcast_convert_type(
        blob[o : o + n_bp].reshape(R, 2, 1), jnp.int32
    ).reshape(R, 2)
    starts, d_pack = bp[:, 0], bp[:, 1]
    if PW:
        # pooled bit plane (exact wire): rows rebuilt from per-lane
        # spans (meta col 15) — the 4-word zero tail contract holds
        # because span <= Wb and words >= span are zero-masked
        bits = _rows_from_pool(
            pool, meta16[:, 15].astype(jnp.int32), L, Wb + 4)
    else:
        if Lb:
            idx = meta16[:, 15].astype(jnp.int32)
            bits = jnp.concatenate(
                [bits, jnp.take(ovf, idx, axis=0)], axis=1)
        # 4 zero words of tail: peeks past a lane's span read
        # deterministic zeros, and max_pos=(W-3)*32 can never clamp
        # below a bit_limit ending inside the widest bucket's last words
        bits = jnp.concatenate(
            [bits, jnp.zeros((L, 4), blob.dtype)], axis=1)
    xq, aa, wt = packed_device_stage(
        bits, meta16[:, :15], scfq, starts, d_pack,
        pats=pats, spats=spats, W=Wb + (Wext if Lb else 0) + 4,
        NBIG=NBIG, NC1=NC1,
        B=B, G=G, nch=nch, ist=ist, mpeg1=MPEG1,
    )
    ph_f = jnp.zeros((1, G, 1, 1), jnp.float32)
    ph_i = jnp.zeros((1, G, 1, 1), jnp.int32)
    return mp3_dsp.mp3_window_dsp(
        xq, ph_f, ph_f, ph_i, aa, wt, overlap, shist, n_act,
        nch=nch, ngr=G, use_perm=False, dequant=False, use_mix=False,
    )
