#!/usr/bin/env python3
"""Benchmark: batched MP3+FLAC decode throughput on one GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "detail": {...}}

Configuration: batch 1024 streams — 512 MP3 (stereo, CBR, varied spectra
incl. short-block transients) + 512 FLAC (stereo mid/side, 16-bit, LPC,
block 4096) — all 1024 byte-streams pairwise distinct (distinct content
families x distinct slice offsets/lengths at frame boundaries).

Metric: decoded-audio seconds per wall second (realtime x), END-TO-END from
host-resident compressed bytes to DEVICE-RESIDENT PCM (decoded audio feeds
models on the same card).  The wall time covers probe, the C host entropy
stage, all host->device uploads, and every device kernel, synced via
element fetch at the end.

detail carries the device (platform, kind, count, and the card's name and
power limit from nvidia-smi), the per-stage split (host ms / upload bytes /
enqueue ms / device windows), the measured host<->device bandwidths, the
full-download (output="numpy") rate, and the device-DSP-only ceiling.  The
run fails, rather than printing a number, when JAX has no GPU, when a row
fails, or when any lane group raised and was demoted.
"""

import json
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
#: generated fixtures are cached here (gitignored), never outside the checkout
CACHE_DIR = os.path.join(_REPO, ".cache")
CORPUS_VERSION = "v4"
CORPUS_PATH = os.path.join(CACHE_DIR, f"bench_corpus_{CORPUS_VERSION}.pkl")


# --------------------------------------------------------------- fixtures
def _mp3_master(rng, seconds, channels=2):
    """One 'master' MP3 with varied spectra: tonal frames, dense frames,
    quiet frames, and periodic short-block (transient) granules."""
    from golden import mp3_ref

    n_gr = max(2, int(seconds * 44100 / 576) // 2 * 2)
    frames = []
    for i in range(0, n_gr, 2):
        grs = []
        for g in (i, i + 1):
            q = np.zeros(576, dtype=np.int64)
            kind = (g // 8) % 3
            if kind == 0:  # tonal: few strong partials
                idx = rng.choice(300, size=25, replace=False)
                q[idx] = rng.integers(-60, 61, size=25)
            elif kind == 1:  # dense spectrum
                idx = rng.choice(480, size=90, replace=False)
                q[idx] = rng.integers(-12, 13, size=90)
            else:  # quiet tail
                idx = rng.choice(200, size=12, replace=False)
                q[idx] = rng.integers(-4, 5, size=12)
            gr = {"q": q}
            if (g // 2) % 9 == 4:
                gr["block_type"] = 2  # short blocks (transient)
            grs.append([dict(gr) for _ in range(channels)])
        frames.append(grs)
    return mp3_ref.build_mp3(frames, channels=channels)


def _mp3_frame_offsets(data):
    """Byte offsets of every frame header (golden builder emits no padding, but
    scan real headers to stay robust)."""
    offs = []
    off = 0
    n = len(data)
    while off + 4 <= n:
        h = data[off : off + 4]
        if h[0] != 0xFF or (h[1] & 0xE0) != 0xE0:
            break
        kbps = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
                256, 320][(h[2] >> 4) & 15]
        sr = [44100, 48000, 32000][(h[2] >> 2) & 3]
        fb = 1152 * kbps * 125 // sr
        if h[2] & 0x2:
            fb += 1
        if fb <= 4:
            break
        offs.append(off)
        off += fb
    offs.append(off)
    return offs


def _flac_master(rng, seconds):
    """One FLAC master: stereo mid/side 16-bit, mixed tonal+noise content."""
    from golden import flac_ref

    frames = int(seconds * 44100)
    t = np.arange(frames)[:, None]
    f0 = rng.uniform(80, 800)
    amp = rng.uniform(4000, 16000)
    noise = rng.uniform(100, 1500)
    x = np.clip(
        np.round(
            amp * np.sin(2 * np.pi * f0 * t * [1.0, 1.003] / 44100.0)
            + 0.35 * amp * np.sin(2 * np.pi * 2.7 * f0 * t * [1.0, 0.99] / 44100.0)
            + noise * rng.standard_normal((frames, 2))
        ),
        -32768, 32767,
    ).astype(np.int64)
    return flac_ref.build_flac(x, 44100, 16, block_size=4096,
                               stereo_mode="mid_side",
                               modes=["lpc8", "lpc8"])


def _flac_frame_offsets(data):
    """Byte offsets of every frame of a golden-builder FLAC stream (a
    CRC8-validated sync scan past the metadata blocks)."""
    from golden.flac_ref import _crc8

    pos = 4  # skip all metadata blocks to the first frame
    while True:
        hdr = data[pos : pos + 4]
        last = hdr[0] & 0x80
        size = int.from_bytes(hdr[1:4], "big")
        pos += 4 + size
        if last:
            break
    offs = []
    i = pos
    n = len(data)
    while i + 8 <= n:
        # 14-bit sync + golden-builder header shape (blocksize code 7,
        # sr-from-streaminfo), validated by the header CRC8
        if (data[i] == 0xFF and (data[i + 1] & 0xFC) == 0xF8
                and (data[i + 2] >> 4) == 7):
            # header: 4 fixed bytes ‖ utf8 frame index ‖ 16-bit (bs-1) ‖ crc8
            j = i + 4
            fb = data[j]
            ext = 0 if fb < 0x80 else (
                1 if fb >> 5 == 0b110 else 2 if fb >> 4 == 0b1110 else
                3 if fb >> 3 == 0b11110 else 4 if fb >> 2 == 0b111110 else
                5 if fb >> 1 == 0b1111110 else 6)
            j += 1 + ext + 2
            if j < n and _crc8(data[i:j]) == data[j]:
                offs.append(i)
                i += 16
                continue
        i += 1
    return offs


def _flac_prefix(data, n_frames_keep, block_size=4096, offs=None):
    """Cut a FLAC stream to its first n frames and patch STREAMINFO's
    36-bit total-samples field to match.  ``offs``: the stream's frame
    offsets, when already known."""
    body_off = 8  # 4 ('fLaC') + 4 (STREAMINFO block header)
    if offs is None:
        offs = _flac_frame_offsets(data)
    if len(offs) <= n_frames_keep:
        return data
    cut = offs[n_frames_keep]
    total = n_frames_keep * block_size
    si = bytearray(data[body_off : body_off + 18])
    w = int.from_bytes(si, "big")
    shift = 18 * 8 - 108 - 36
    w &= ~(((1 << 36) - 1) << shift)
    w |= (total & ((1 << 36) - 1)) << shift
    si = w.to_bytes(18, "big")
    return data[:body_off] + si + data[body_off + 18 : cut]


def _corpus_master(job):
    """One corpus master (a pool task): (kind, seed, seconds) -> (bytes,
    frame offsets).  Each master draws from its own child seed, so the
    corpus is the same whatever the number of workers."""
    kind, seed, seconds = job
    rng = np.random.default_rng(seed)
    if kind == "mp3":
        data = _mp3_master(rng, seconds)
        return data, _mp3_frame_offsets(data)
    data = _flac_master(rng, seconds)
    return data, _flac_frame_offsets(data)


def build_corpus(n_mp3, n_flac, rng_seed=7):
    """Returns (mp3, mp3_secs, flac, flac_secs, flac_1w) — flac_1w are
    12-frame (one scheduler window) prefixes of each FLAC lane.  The
    masters are generated by the pure-Python golden encoders, in a pool of
    worker processes (numpy only, no JAX); the result is cached in
    CACHE_DIR."""
    if os.path.exists(CORPUS_PATH):
        with open(CORPUS_PATH, "rb") as f:
            c = pickle.load(f)
        if c["n_mp3"] >= n_mp3 and c["n_flac"] >= n_flac:
            return (c["mp3"][:n_mp3], c["mp3_secs"][:n_mp3],
                    c["flac"][:n_flac], c["flac_secs"][:n_flac],
                    c["flac_1w"][:n_flac])
    import multiprocessing

    t0 = time.time()
    # MP3: 24 masters x ~18 s, lanes are (master, start, len) frame slices —
    # every lane a distinct byte stream AND distinct decode content (slices
    # start mid-stream: the bit reservoir warms up exactly like minimp3's
    # seek preroll).  FLAC: 96 distinct masters (varied f0/amplitude/noise,
    # 6–10 s), lanes are prefix slices of distinct frame counts with
    # STREAMINFO patched.
    n_mm = min(24, max(1, n_mp3))
    n_fm = min(96, max(1, n_flac))
    seeds = np.random.SeedSequence(rng_seed).spawn(n_mm + n_fm)
    jobs = [("mp3", seeds[i], 18.0) for i in range(n_mm)] + [
        ("flac", seeds[n_mm + i], 6.0 + (i % 5)) for i in range(n_fm)]
    workers = max(1, min(16, os.cpu_count() or 1, len(jobs)))
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        built = pool.map(_corpus_master, jobs, chunksize=1)
    masters, fmasters = built[:n_mm], built[n_mm:]
    mp3, mp3_secs = [], []
    k = 0
    while len(mp3) < n_mp3:
        m, offs = masters[k % len(masters)]
        n_frames = len(offs) - 1
        v = k // len(masters)
        start = (v * 211) % max(1, n_frames // 3)
        length = n_frames - start - (v * 53) % max(1, n_frames // 4)
        length = max(40, length)
        mp3.append(m[offs[start] : offs[min(n_frames, start + length)]])
        mp3_secs.append((min(n_frames, start + length) - start)
                        * 1152 / 44100.0)
        k += 1
    flac, flac_secs, flac_1w = [], [], []
    k = 0
    while len(flac) < n_flac:
        mi = k % len(fmasters)
        v = k // len(fmasters)
        m, offs = fmasters[mi]
        nfr = int((6.0 + mi % 5) * 44100) // 4096
        keep = max(8, nfr - v * 7)
        lane = _flac_prefix(m, keep, offs=offs)
        flac.append(lane)
        flac_secs.append(min(keep, nfr + 1) * 4096 / 44100.0)
        # a lane is a prefix of its master, so its first window is too
        flac_1w.append(lane if keep <= 12 else
                       _flac_prefix(m, 12, offs=offs))
        k += 1
    c = {"n_mp3": n_mp3, "n_flac": n_flac, "mp3": mp3, "mp3_secs": mp3_secs,
         "flac": flac, "flac_secs": flac_secs, "flac_1w": flac_1w}
    os.makedirs(CACHE_DIR, exist_ok=True)
    with open(CORPUS_PATH + ".tmp", "wb") as f:
        pickle.dump(c, f)
    os.replace(CORPUS_PATH + ".tmp", CORPUS_PATH)
    print(f"# corpus built: {time.time()-t0:.0f}s on {workers} workers",
          file=sys.stderr)
    return mp3, mp3_secs, flac, flac_secs, flac_1w


# --------------------------------------------------------------- diagnostics
def bench_device_resident_mp3(mp3_streams, B=512, reps=6):
    """Full MP3 decode throughput with window payloads RESIDENT on device:
    Huffman FSM + dequant + reorder + MS mix + window DSP, chained through
    the carried state.  This is the device's decode rate — what a
    training loop over a device-cached compressed dataset sees — measured
    on REAL corpus windows (the end-to-end number also pays the host
    stage and the transfers)."""
    import jax
    import jax.numpy as jnp

    from audio_formats_tpu import models
    from audio_formats_tpu.host import native as _native
    from audio_formats_tpu.io.source import MemorySource
    from audio_formats_tpu.ops import mp3_huff

    lib = _native.get_lib()
    pool = list(mp3_streams)
    while len(pool) < B:          # 512 distinct contents, repeated lanes:
        pool += list(mp3_streams)  # device rate depends on shape, not values
    decs = [models.probe_all(MemorySource(m)) for m in pool[:B]]
    B = len(decs)
    W, ngr, nch = 24, 2, 2
    G, NL, LW = W * ngr, W * ngr * nch, _native.LANE_WORDS
    bits = np.empty((B, NL, LW), np.uint32)
    meta = np.zeros((B, NL, 16), np.int32)
    scfq = np.zeros((B, NL, 40), np.int16)
    aa_c = np.zeros((G, nch), np.int32)
    wt_c = np.zeros((G, nch, 32), np.int32)
    flags = np.zeros(W, np.uint8)
    states = []
    for d in decs:
        states.append((np.zeros(511, np.uint8), np.zeros(1, np.int32),
                       d._ist_pos))
    n_act = np.zeros(B, np.int32)
    mw_max = 16
    t_parse0 = time.perf_counter()
    for bi, d in enumerate(decs):
        n, off, mw, _ = _native.mp3_parse_window_packed(
            lib, d._view, d._offset, d._hdr0, W, ngr, nch, states[bi],
            bits[bi], meta[bi], scfq[bi], aa_c, wt_c, flags)
        n_act[bi] = n * ngr
        mw_max = max(mw_max, mw)
    t_parse = time.perf_counter() - t_parse0
    Wb = next(w for w in (16, 32, 64, LW) if mw_max <= w)
    live = meta[:, :, 2] > 0
    # content-sized scan buckets — the production scheduler's plan
    # (batch.py uses scan_buckets too; spec maxima would pay 288+144
    # steps where this corpus needs far fewer)
    nbig_b, nc1_b = mp3_huff.scan_buckets(
        meta[:, :, 3][live], mp3_huff.TOTAL_W[meta[:, :, 10][live]])
    pats = tuple(sorted(int(p) for p in np.unique(meta[:, :, 10][live])))
    cids = {int(mp3_huff.CODE_ID[t])
            for t in np.unique(meta[:, :, 6:9][live])}
    starts, d_pack, rank_of = mp3_huff.breakpoints_for_window(cids)
    spats = tuple(p for p in pats if p in mp3_huff.SHORT_PATTERNS)
    L, R = B * NL, starts.size
    tabs = meta[:, :, 6:9]
    meta16 = np.concatenate([
        meta[:, :, [1, 2, 3, 4, 5]], rank_of[tabs],
        mp3_huff.LINBITS_TAB[tabs], meta[:, :, [9, 10, 11, 12]],
        np.zeros((B, NL, 1), meta.dtype),
    ], axis=2).astype(np.int16).reshape(L, 16)
    n_bits, _, n_meta, n_scf, _ist0, n_bp, total = \
        mp3_huff.blob_layout(L, Wb, R)
    blob = np.empty(total, np.uint32)
    o = 0
    blob[o : o + n_bits] = bits[:, :, :Wb].reshape(-1)
    o += n_bits
    blob[o : o + n_meta] = meta16.reshape(-1).view(np.uint32)
    o += n_meta
    blob[o : o + n_scf] = scfq.reshape(-1).view(np.uint32)
    o += n_scf
    blob[o : o + n_bp] = np.ascontiguousarray(
        np.stack([starts, d_pack], axis=1)).reshape(-1).view(np.uint32)
    blob_d = jax.device_put(blob)
    overlap = jnp.zeros((B, nch, 32, 18), jnp.float32)
    shist = jnp.zeros((B, nch, 16, 32), jnp.float32)
    na = jax.device_put(n_act)
    pcm, overlap, shist = mp3_huff.packed_window_blob(
        blob_d, overlap, shist, na, pats=pats, spats=spats,
        L=L, Wb=Wb, R=R, B=B, G=G, nch=nch, NBIG=nbig_b, NC1=nc1_b)
    _ = np.asarray(pcm[0, 0, 0, 0])

    def run(k):
        nonlocal overlap, shist
        t0 = time.perf_counter()
        for _ in range(k):
            pcm, o2, s2 = mp3_huff.packed_window_blob(
                blob_d, overlap, shist, na, pats=pats, spats=spats,
                L=L, Wb=Wb, R=R, B=B, G=G, nch=nch,
                NBIG=nbig_b, NC1=nc1_b)
            overlap, shist = o2, s2
        _ = np.asarray(pcm[0, 0, 0, 0])
        return time.perf_counter() - t0
    # two-point slope removes the fixed dispatch + fetch cost from dt
    lo, hi = reps, reps * 3
    t_lo = min(run(lo) for _ in range(2))
    t_hi = min(run(hi) for _ in range(2))
    dt = max(1e-9, (t_hi - t_lo) / (hi - lo))
    audio = float(n_act.sum()) * 576 / 44100.0
    # pure host C parse rate for this window (serial, no IO interleave):
    # a stable per-core host-stage number, unlike the e2e host_ms wall
    # time which inflates when uploads share the core
    bench_device_resident_mp3.host_parse_rtx = audio / max(1e-9, t_parse)
    return audio / dt, blob.nbytes, audio


def bench_device_resident_flac(flac_streams, B=512, W=12, reps=4):
    """Full FLAC decode throughput with window payloads RESIDENT on device:
    packed-residual unpack + LPC scan (Pallas) + mid/side decorrelation +
    s16 emit, on REAL corpus frames — the FLAC half of the aggregate
    device-resident metric (BASELINE.md's metric is MP3+FLAC aggregate)."""
    import functools

    import jax

    from audio_formats_tpu import models
    from audio_formats_tpu.host import native as _native
    from audio_formats_tpu.io.source import MemorySource
    from audio_formats_tpu.ops import lpc as lpc_ops
    from audio_formats_tpu.parallel.batch import _flac_width_plan

    lib = _native.get_lib()
    pool = list(flac_streams)
    while len(pool) < B:
        pool += list(flac_streams)
    decs = [models.probe_all(MemorySource(m)) for m in pool[:B]]
    lanes = []
    nch = decs[0].channels
    for d in decs:
        for _ in range(W):
            p = d._parse_frame_tensors()
            if p is None:
                break
            lanes.append((d, p))
    S = len(lanes)
    max_bs = -(-max(p[0] for _, p in lanes) // 1024) * 1024
    Ln = S * nch
    residual = np.zeros((Ln, max_bs), np.int32)
    coeffs = np.zeros((Ln, 32), np.int32)
    order = np.full(Ln, max_bs, np.int32)
    shift = np.zeros(Ln, np.int32)
    exact = np.zeros(Ln, bool)
    assigns = np.zeros(S, np.int32)
    wasteds = np.zeros((S, nch), np.int32)
    out_shifts = np.zeros(S, np.int32)
    audio = 0.0
    for si, (d, p) in enumerate(lanes):
        bs, ca, res, cf, orr, sh, wa, bps = p
        residual[si * nch : si * nch + nch, :bs] = res
        coeffs[si * nch : si * nch + nch] = cf
        order[si * nch : si * nch + nch] = orr
        shift[si * nch : si * nch + nch] = sh
        exact[si * nch : si * nch + nch] = np.asarray(bps) > 16
        assigns[si] = ca
        wasteds[si] = wa
        out_shifts[si] = 32 - d.bits_per_sample
        audio += bs / max(1, d.sample_rate)
    import ctypes as _ct

    _i32p = _ct.POINTER(_ct.c_int32)
    _u32p = _ct.POINTER(_ct.c_uint32)
    w_l = np.zeros(Ln, np.int32)
    wmax = lib.af_flac_widths(
        residual.ctypes.data_as(_i32p), Ln, max_bs,
        order.ctypes.data_as(_i32p), w_l.ctypes.data_as(_i32p))
    wb, Lb = _flac_width_plan(w_l, wmax, Ln, max_bs)
    wb = max(wb, wmax)  # device-resident: no overflow plane needed
    stride = (max_bs * wb + 31) // 32 + 1
    packed = np.empty((Ln, stride), np.uint32)
    lib.af_flac_pack(
        residual.ctypes.data_as(_i32p), Ln, max_bs,
        order.ctypes.data_as(_i32p), wb,
        packed.ctypes.data_as(_u32p), stride)
    warm = np.ascontiguousarray(residual[:, :32])

    @functools.partial(jax.jit, static_argnames=("w", "n"))
    def fused(packed, warm, coeffs, order, shift, exact, assigns,
              wasteds, out_shifts, w: int, n: int):
        res = lpc_ops.flac_unpack_residuals(packed, warm, order, w=w, n=n)
        samples = lpc_ops.flac_lpc(
            res, coeffs, order, shift, exact).reshape(S, nch, n)
        return lpc_ops.flac_post_stereo_batch_s16(
            samples, assigns, wasteds, out_shifts)

    args = [jax.device_put(a) for a in
            (packed, warm, coeffs, order, shift, exact, assigns,
             wasteds, out_shifts)]
    out = fused(*args, w=wb, n=max_bs)
    _ = np.asarray(out[0, 0, 0])

    def run(k):
        t0 = time.perf_counter()
        for _ in range(k):
            out = fused(*args, w=wb, n=max_bs)
        _ = np.asarray(out[0, 0, 0])
        return time.perf_counter() - t0

    lo, hi = reps, reps * 3
    t_lo = min(run(lo) for _ in range(2))
    t_hi = min(run(hi) for _ in range(2))
    dt = max(1e-9, (t_hi - t_lo) / (hi - lo))
    return audio / dt, packed.nbytes + warm.nbytes, audio


QOA_CORPUS_PATH = os.path.join(CACHE_DIR, f"bench_qoa_{CORPUS_VERSION}.pkl")


def bench_device_resident_qoa(B=32, secs=10, reps=6):
    """Full QOA decode with slice payloads RESIDENT on device: QOA's
    entropy layer is fixed-layout bit unpacking (staged once), so the
    batched LMS predictor scan (ops/lms.py) IS the complete decode —
    this is the chip's whole-format rate for the qoa.d:455-534 hot
    loop, complementing the MP3/FLAC rows."""
    import jax

    from audio_formats_tpu import models
    from audio_formats_tpu.io.source import MemorySource
    from audio_formats_tpu.ops import lms as lms_ops
    from audio_formats_tpu.parallel.encode import encode_qoa_batch

    if os.path.exists(QOA_CORPUS_PATH):
        with open(QOA_CORPUS_PATH, "rb") as f:
            streams = pickle.load(f)
    else:
        rng = np.random.default_rng(11)
        n = secs * 44100
        t = np.arange(n) / 44100.0
        pcms = []
        for i in range(8):  # 8 distinct stereo masters, lanes repeat them
            x = np.stack([
                0.3 * np.sin(2 * np.pi * (180 + 23 * i) * t)
                + 0.02 * rng.standard_normal(n),
                0.25 * np.sin(2 * np.pi * (240 + 31 * i) * t)
                + 0.02 * rng.standard_normal(n),
            ], 1).astype(np.float32)
            pcms.append(np.clip(x, -1, 1))
        streams = encode_qoa_batch(pcms, 44100)
        os.makedirs(CACHE_DIR, exist_ok=True)
        with open(QOA_CORPUS_PATH, "wb") as f:
            pickle.dump(streams, f)
    pool = list(streams)
    while len(pool) < B:
        pool += list(streams)
    decs = [models.probe_all(MemorySource(q)) for q in pool[:B]]
    FULL_S = 256
    H, Wt, SF, CD = [], [], [], []
    audio = 0.0
    for d in decs:
        pos = d._byte_pos
        while True:
            p = d._parse_frame_at(pos)
            if p is None:
                break
            h, w, sf, codes, f_samples, f_size = p
            S = sf.shape[1]
            if S < FULL_S:
                sf = np.pad(sf, ((0, 0), (0, FULL_S - S)))
                codes = np.pad(codes, ((0, 0), (0, FULL_S - S), (0, 0)))
            H.append(h)
            Wt.append(w)
            SF.append(sf.astype(np.int8))
            CD.append(codes.astype(np.int8))
            audio += f_samples / 44100.0
            pos += f_size
    hist = np.concatenate(H).astype(np.int32)
    wts = np.concatenate(Wt).astype(np.int32)
    sf8 = np.concatenate(SF)
    cd8 = np.concatenate(CD)
    L = hist.shape[0]
    Lp = -(-L // 1024) * 1024
    hp = np.zeros((Lp, 4), np.int32)
    wp = np.zeros((Lp, 4), np.int32)
    sp = np.zeros((Lp, FULL_S), np.int8)
    cp = np.zeros((Lp, FULL_S, 20), np.int8)
    hp[:L], wp[:L], sp[:L], cp[:L] = hist, wts, sf8, cd8
    args = [jax.device_put(a) for a in (hp, wp, sp, cp)]
    out = lms_ops.decode_slices(*args)
    _ = np.asarray(out[0, 0])

    def run(k):
        t0 = time.perf_counter()
        for _ in range(k):
            out = lms_ops.decode_slices(*args)
        _ = np.asarray(out[0, 0])
        return time.perf_counter() - t0

    lo, hi = reps, reps * 3
    t_lo = min(run(lo) for _ in range(2))
    t_hi = min(run(hi) for _ in range(2))
    dt = max(1e-9, (t_hi - t_lo) / (hi - lo))
    return audio / dt, hp.nbytes + wp.nbytes + sp.nbytes + cp.nbytes, audio


def bench_device_resident_vorbis(B=256, K=8, reps=6):
    """Vorbis post-entropy synthesis with spectra RESIDENT on device: the
    IMDCT + lapped overlap-add chain (ops/vorbis_win.vorbis_window_chain,
    the device half of output="device" Vorbis decode) on real packet
    spectra/geometry from the entropy stage — stereo coupled lanes, mixed
    long/short windows.  Entropy (codebooks/floors/residues) stays on the
    host by design (stb_vorbis2.d:1211's codebook walk is data-dependently
    book-switched, which defeats the lockstep interval-sum FSM), so this
    row is the chip's rate for everything after it."""
    import jax

    from audio_formats_tpu import models
    from audio_formats_tpu.io.source import MemorySource
    from audio_formats_tpu.ops import vorbis_win
    from golden import vorbis_ref

    rng = np.random.default_rng(5)
    ch, bs0, bs1 = 2, 512, 2048
    h = bs1 // 2
    masters = []
    for mi in range(4):  # 4 distinct stereo masters, lanes repeat them
        fix = vorbis_ref.Fixture(channels=ch, bs0=bs0, bs1=bs1,
                                 coupling=True)
        # music-shaped block pattern: mostly long, occasional short pair
        pattern = [1] * (K + 1)
        if K >= 6:  # occasional short-block pair (transients)
            pattern[3 + mi % 2] = 0
            pattern[4 + mi % 2] = 0
        frames = []
        for j in range(K + 1):
            lb = bool(pattern[j])
            n2 = (bs1 if lb else bs0) // 2
            posts = [[int(rng.integers(40, 100)) for _ in range(4)]
                     for _ in range(ch)]
            rs = []
            for _c in range(ch):
                r = np.zeros(n2)
                idx = rng.choice(n2, size=n2 // 3, replace=False)
                r[idx] = rng.integers(-5, 6, size=idx.size) * fix.vq_delta
                rs.append(r)
            prev_long = bool(pattern[j - 1]) if j > 0 else True
            next_long = bool(pattern[j + 1]) if j + 1 <= K else True
            frames.append(fix.audio_packet(
                posts, rs, long_block=lb,
                prev_flag=1 if prev_long else 0,
                next_flag=1 if next_long else 0))
        masters.append((fix.build(frames), fix.rate))
    L = B * ch
    X = np.zeros((K, L, h), np.float32)
    geom = np.zeros((4, K, B), np.int32)
    audio = 0.0
    for bi in range(B):
        data, sr = masters[bi % len(masters)]
        d = models.probe_all(MemorySource(data))
        k = 0
        while k < K:
            pk = d._reader.next_packet()
            if pk is None:
                break
            ent = d._packet_entropy(pk[0])
            if ent is None:
                continue
            spec, (n, l0, r0, r1) = ent
            X[k, bi * ch : (bi + 1) * ch, : n // 2] = spec
            geom[:, k, bi] = (l0, r0, r1, 1)
            if k > 0:  # first packet primes the lap (no output)
                audio += (r0 - l0) / sr
            k += 1
    state = (np.zeros((L, h), np.float32), np.zeros(B, np.int32),
             np.zeros(B, np.int32))
    args = [jax.device_put(a)
            for a in (X, geom[0], geom[1], geom[2], geom[3])]
    state = [jax.device_put(a) for a in state]

    # the per-window chain is sub-millisecond on the device — below the
    # per-dispatch jitter — so repetition happens INSIDE one device
    # program (fori_loop over the chain, carrying the lap state)
    # and the two-point slope cancels the single dispatch+fetch cost
    import functools

    @functools.partial(jax.jit, static_argnames=("n",))
    def chain_n(X, ls, rs, re, valid, lap, ll, hp, n: int):
        def body(_, c):
            lap, ll, hp, acc = c
            pcm, lap, ll, hp = vorbis_win.vorbis_window_chain(
                X, ls, rs, re, valid, lap, ll, hp,
                bs0=bs0, bs1=bs1, ch=ch)
            return (lap, ll, hp, acc + pcm[0, 0, 0])

        lap, ll, hp, acc = jax.lax.fori_loop(
            0, n, body, (lap, ll, hp, np.float32(0.0)))
        return acc

    lo, hi = reps, reps * 3
    _ = np.asarray(chain_n(*args, *state, n=lo))
    _ = np.asarray(chain_n(*args, *state, n=hi))

    def run(k):
        t0 = time.perf_counter()
        _ = np.asarray(chain_n(*args, *state, n=k))
        return time.perf_counter() - t0

    t_lo = min(run(lo) for _ in range(3))
    t_hi = min(run(hi) for _ in range(3))
    dt = max(1e-9, (t_hi - t_lo) / (hi - lo))
    return audio / dt, X.nbytes + geom.nbytes, audio


def _calibrated_chain_rate(run, n0, audio_per_iter, min_t=0.25):
    """Robust rate of a device-resident fori_loop chain whose per-iteration
    cost is far below the dispatch jitter: grow the DYNAMIC trip
    count until one chained call costs >= min_t of wall (the single
    dispatch+fetch it pays is then <2% of the measurement), take the best
    of 3 calls at that count.  run(k) must execute the chain with traced
    trip count k (one compile serves every k) and return its wall seconds.
    Replaces the two-point slope, which differenced ~1 ms of signal
    against multi-ms dispatch jitter and swung 50x run to run."""
    n = n0
    t = run(n)
    while t < min_t and n < (1 << 16):
        n = min(1 << 16,
                n * max(2, min(32, int(min_t * 1.2 / max(t, 1e-3)) + 1)))
        t = run(n)
    t = min(t, *(run(n) for _ in range(2)))
    return audio_per_iter * n / max(t, 1e-9)


def bench_device_resident_encode(Lq=4096, Lw=256, nw=1 << 18):
    """Device-resident encode rates — the write-half mirror of the decode
    rows.  QOA: the fused 16-scalefactor LMS search + slice-word pack
    (ops/lms.qoa_encode_frame_words — qoa.d:345-383's brute-force search
    as a lane axis, qoa.d:330-339's word layout packed on device) over
    Lq lanes of one frame.  WAV s24: the fused TPDF-dither + exact
    round-half-up quantize + byte pack (ops/pcm._quantize_pack_rows,
    wav.d:679-701 + 487-525 semantics) over [Lw, nw] float rows.  Inputs
    stay resident; each fori_loop iteration perturbs them (+(k&1)) so the
    loop body cannot be hoisted, and the carried accumulator sums a full
    output reduction so no lane is dead code."""
    import jax
    import jax.numpy as jnp

    from audio_formats_tpu.ops import lms as lms_ops
    from audio_formats_tpu.ops import pcm as pcm_ops

    rng = np.random.default_rng(31)
    out = {}

    samples = jax.device_put(np.clip(np.round(
        8000 * rng.standard_normal((Lq, 5120))), -32768, 32767
    ).astype(np.int16))

    @jax.jit
    def chain_qoa(s, n):
        def body(k, acc):
            hi, lo = lms_ops.qoa_encode_frame_words(
                s + (k & 1).astype(jnp.int16), np.int32(5120))
            return acc + jnp.sum(hi, dtype=jnp.uint32) \
                + jnp.sum(lo, dtype=jnp.uint32)

        return jax.lax.fori_loop(0, n, body, jnp.uint32(0))

    _ = np.asarray(chain_qoa(samples, jnp.int32(2)))

    def run_q(k):
        t0 = time.perf_counter()
        _ = np.asarray(chain_qoa(samples, jnp.int32(k)))
        return time.perf_counter() - t0

    # Lq lanes = Lq/2 stereo streams x 5120 samples per frame
    out["device_resident_encode_rtx_qoa"] = round(_calibrated_chain_rate(
        run_q, 2, (Lq / 2) * 5120 / 44100.0), 1)

    rows = jax.device_put(np.clip(
        rng.standard_normal((Lw, nw)) * 0.3, -1, 1).astype(np.float32))
    seeds = jax.device_put(np.arange(Lw, dtype=np.uint32))

    @jax.jit
    def chain_wav(x, seeds, n):
        def body(k, acc):
            w = pcm_ops._quantize_pack_rows(
                x + (k & 1).astype(jnp.float32) * np.float32(1e-8),
                seeds, "s24", True)
            return acc + jnp.sum(w, dtype=jnp.uint32)

        return jax.lax.fori_loop(0, n, body, jnp.uint32(0))

    _ = np.asarray(chain_wav(rows, seeds, jnp.int32(2)))

    def run_w(k):
        t0 = time.perf_counter()
        _ = np.asarray(chain_wav(rows, seeds, jnp.int32(k)))
        return time.perf_counter() - t0

    # Lw rows = Lw stereo streams of nw interleaved samples
    out["device_resident_encode_rtx_wav_s24"] = round(
        _calibrated_chain_rate(run_w, 2, Lw * nw / 2 / 44100.0), 1)
    return out


def bench_device_resident_celt(B=256, K=12, reps=6):
    """CELT (Opus music mode) post-entropy synthesis with spectra RESIDENT
    on device: the batched IMDCT + windowed overlap-add
    (ops/celt_dsp.celt_imdct_ola — the device half of every lockstep Opus
    group) chained with the deemphasis recurrence
    (ops/celt_dsp.deemphasis_scan) on real libopus-encoded stereo packet
    spectra.  Entropy (range decode, PVQ, energies) stays on the host by
    design — dopus.d:2290+'s laplace/PVQ symbol walk is serially
    data-dependent per frame and runs in the C host stage — so this row is
    the chip's rate for everything after it.  Long-block (non-transient)
    frames only: the dominant music shape; transient frames ride an
    identically-structured short-block bucket kernel in the scheduler."""
    import functools

    import jax
    import jax.numpy as jnp

    from audio_formats_tpu.models.celt import OVERLAP, CeltDecoder
    from audio_formats_tpu.models.opus import RangeDecoder, parse_packet
    from audio_formats_tpu.ops import celt_dsp
    from golden import opus_oracle as O

    if O.get_lib() is None:
        raise RuntimeError("libopus oracle unavailable")
    rng = np.random.default_rng(7)
    N, ch = 960, 2
    masters = []  # 4 distinct stereo masters; lanes repeat them (device
    for mi in range(4):  # rate depends on shape, not values)
        t = np.arange(N * (K + 6)) / 48000.0
        f0 = 200.0 + 70.0 * mi
        sig = (7000 * np.sin(2 * np.pi * f0 * t)
               * (0.6 + 0.4 * np.sin(2 * np.pi * 2.3 * t))
               + 2500 * np.sin(2 * np.pi * (2000 + 400 * mi) * t)
               + 900 * rng.standard_normal(t.size))
        sigs = np.clip(np.stack([sig, np.roll(sig, 17)], 1),
                       -32000, 32000).astype(np.int16)
        enc = O.OracleEncoder(48000, 2, bitrate=128000,
                              signal=O.OPUS_SIGNAL_MUSIC,
                              bandwidth=O.OPUS_BANDWIDTH_FULLBAND)
        cd = CeltDecoder(output_channels=2)
        frames = []
        for n in range(K + 6):
            info = parse_packet(enc.encode(sigs[n * N : (n + 1) * N]))
            if info["mode"] != "celt":
                continue
            for fr in info["frames"]:
                p = cd.decode_frame_symbols(
                    RangeDecoder(fr), 2 if info["stereo"] else 1,
                    info["frame_size"], 0, 21)
                if p["blocks"] == 1 and len(frames) < K:
                    frames.append(p["coeffs"][:, :N]
                                  * np.float32(p["imdct_scale"]))
        while len(frames) < K:  # rare: encoder chose transients late
            frames.append(frames[-1])
        masters.append(frames)

    L = B * ch
    X = np.zeros((K, L, N), np.float32)
    for bi in range(B):
        for k in range(K):
            X[k, bi * ch : (bi + 1) * ch] = masters[bi % len(masters)][k]
    audio = B * K * N / 48000.0
    tail0 = np.zeros((L, OVERLAP // 2), np.float32)
    m0 = np.zeros(L, np.float32)

    # per-window device time is sub-millisecond — below the dispatch
    # jitter — so repetition chains INSIDE one device program.
    # The trip count is a DYNAMIC arg (one compile serves every n) and is
    # calibrated until a single chained call costs >= 0.25 s of wall, so
    # the one dispatch+fetch it pays is <2% of the measurement — the
    # two-point slope this replaces differenced ~1 ms of signal against
    # multi-ms dispatch jitter and was unstable across runs.
    @jax.jit
    def chain_n(X, tail, m, n):
        def body(k, c):
            tail, m, acc = c
            raw, tail = celt_dsp.celt_imdct_ola(X[k % K], tail, 1, N)
            y, m = celt_dsp.deemphasis_scan(raw, m)
            return (tail, m, acc + y[0, 0])

        _, _, acc = jax.lax.fori_loop(
            0, n, body, (tail, m, jnp.float32(0.0)))
        return acc

    args = [jax.device_put(a) for a in (X, tail0, m0)]
    _ = np.asarray(chain_n(*args, jnp.int32(reps)))  # compile

    def run(k):
        t0 = time.perf_counter()
        _ = np.asarray(chain_n(*args, jnp.int32(k)))
        return time.perf_counter() - t0

    # each fori_loop iteration synthesizes exactly ONE window (X[k % K])
    rate = _calibrated_chain_rate(run, max(reps, K), B * N / 48000.0)
    return rate, X.nbytes, audio


def bench_batch_encode(B=64, secs=4, up_bw=None, down_bw=None):
    """Batched encode throughput (the write half of the framework): N
    distinct stereo masters through the lockstep QOA encoder (device
    16-scalefactor LMS search, ops/lms.py) and the batched WAV s24 encoder
    (device TPDF dither + exact quantize).  End-to-end wall including the
    host byte assembly — realtime x of audio encoded per second.

    Encode has its own wire physics, recorded here when link rates are
    passed: the QOA wire is s16 PCM up + packed slice words down; the WAV
    wire is f32 PCM up + the payload bytes down.
    ``encode_link_bound_rtx_*`` = audio_s / (up/up_bw + down/down_bw);
    ``encode_ceiling_fraction_*`` = measured / that cap."""
    from audio_formats_tpu.config import EncodingOptions
    from audio_formats_tpu.parallel.encode import (encode_qoa_batch,
                                                   encode_wav_batch)

    rng = np.random.default_rng(17)
    n = secs * 44100
    t = np.arange(n) / 44100.0
    pcms = []
    for i in range(B):
        x = np.stack([
            0.3 * np.sin(2 * np.pi * (160 + 17 * i) * t)
            + 0.02 * rng.standard_normal(n),
            0.25 * np.sin(2 * np.pi * (210 + 13 * i) * t)
            + 0.02 * rng.standard_normal(n),
        ], 1).astype(np.float32)
        pcms.append(np.clip(x, -1, 1))
    audio = B * secs
    out = {}

    def _ceiling(tag, rtx, up_bytes, down_bytes):
        if not (up_bw and down_bw):
            return
        cap = audio / (up_bytes / up_bw + down_bytes / down_bw)
        out[f"encode_link_bound_rtx_{tag}"] = round(cap, 1)
        out[f"encode_ceiling_fraction_{tag}"] = round(rtx / cap, 3)

    st = {}
    encode_qoa_batch(pcms, 44100, stats=st)  # compile warmup, timed shape
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        encode_qoa_batch(pcms, 44100, stats=st)
        best = min(best, time.perf_counter() - t0)
    qoa_rtx = round(audio / best, 1)
    out["batch_encode_rtx_qoa"] = qoa_rtx
    _ceiling("qoa", qoa_rtx, st.get("h2d_bytes", 0),
             st.get("d2h_bytes", 0))
    from audio_formats_tpu.config import AudioSampleFormat

    opt = EncodingOptions(sample_format=AudioSampleFormat.s24,
                          enable_dither=True)
    encode_wav_batch(pcms, 44100, options=opt)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        encode_wav_batch(pcms, 44100, options=opt)
        best = min(best, time.perf_counter() - t0)
    wav_rtx = round(audio / best, 1)
    out["batch_encode_rtx_wav_s24"] = wav_rtx
    # WAV wire, analytic: padded f32 rows up, 3 B/sample payload down
    nsamp = sum(p.size for p in pcms)
    _ceiling("wav_s24", wav_rtx, nsamp * 4, nsamp * 3)

    # device-only rate of the QOA encode kernel (16-scalefactor LMS
    # search, qoa.d:345-383 as a vectorized axis): per-frame cost is small
    # vs dispatch jitter, so repetition chains INSIDE one program
    import functools

    import jax

    from audio_formats_tpu.ops import lms as lms_ops

    L = 2 * B
    rng2 = np.random.default_rng(23)
    samples = jax.device_put(np.clip(np.round(
        8000 * rng2.standard_normal((L, 5120))), -32768, 32767
    ).astype(np.int32))
    h0 = jax.device_put(np.zeros((L, 4), np.int32))
    w0 = jax.device_put(np.tile(
        np.array([0, 0, -(1 << 13), 1 << 14], np.int32), (L, 1)))

    @functools.partial(jax.jit, static_argnames=("n",))
    def chain_n(samples, h, w, n: int):
        def body(_, c):
            h, w, acc = c
            _sf, codes, h, w = lms_ops.qoa_encode_frame_scan(
                samples, h, w, np.int32(5120))
            return (h, w, acc + codes[0, 0, 0])

        h, w, acc = jax.lax.fori_loop(0, n, body, (h, w, np.int32(0)))
        return acc

    lo, hi = 2, 6
    _ = np.asarray(chain_n(samples, h0, w0, n=lo))
    _ = np.asarray(chain_n(samples, h0, w0, n=hi))

    def run(k):
        t0 = time.perf_counter()
        _ = np.asarray(chain_n(samples, h0, w0, n=k))
        return time.perf_counter() - t0

    t_lo = min(run(lo) for _ in range(3))
    t_hi = min(run(hi) for _ in range(3))
    dt = max(1e-9, (t_hi - t_lo) / (hi - lo))
    out["device_qoa_encode_search_rtx"] = round(
        B * (5120 / 44100.0) / dt, 1)
    return out


def bench_device_dsp_only(B=1024, G=48, nch=2, reps=8):
    """Device ceiling: the MP3 window DSP alone (inputs device-resident),
    timed with chained state and a forced element fetch."""
    import functools

    import jax
    import jax.numpy as jnp

    from audio_formats_tpu.ops import mp3_dsp

    rng = np.random.default_rng(0)
    xq = jnp.asarray(rng.standard_normal((B, G, nch, 576)).astype(np.float32))
    ph_f = jnp.zeros((1, G, 1, 1), np.float32)
    ph_i = jnp.zeros((1, G, 1, 1), jnp.int32)
    aa = jnp.full((B, G, nch), 31, jnp.int32)
    wt = jnp.zeros((B, G, nch, 32), jnp.int32)
    overlap = jnp.zeros((B, nch, 32, 18), jnp.float32)
    shist = jnp.zeros((B, nch, 16, 32), jnp.float32)
    na = jnp.full((B,), G, jnp.int32)
    fn = functools.partial(mp3_dsp.mp3_window_dsp, nch=nch, ngr=G,
                           use_perm=False, dequant=False, use_mix=False)
    pcm, overlap, shist = fn(xq, ph_f, ph_f, ph_i, aa, wt, overlap, shist, na)
    _ = np.asarray(pcm[0, 0, 0, 0])

    def run(k):
        nonlocal overlap, shist
        t0 = time.perf_counter()
        for _ in range(k):
            pcm, o2, s2 = fn(xq, ph_f, ph_f, ph_i, aa, wt, overlap,
                             shist, na)
            overlap, shist = o2, s2
        _ = np.asarray(pcm[0, 0, 0, 0])
        return time.perf_counter() - t0
    # two-point slope removes the fixed dispatch + fetch cost that a
    # single timed loop folds into dt
    lo, hi = reps, reps * 4
    t_lo = min(run(lo) for _ in range(2))
    t_hi = min(run(hi) for _ in range(2))
    dt = max(1e-9, (t_hi - t_lo) / (hi - lo))
    return B * G * 576 / 44100.0 / dt


def golden_gauges():
    """Accuracy rows against the INDEPENDENT in-repo golden
    implementations (no system libraries): integer codecs must be exactly
    0, MP3 and Vorbis within the 1e-4 contract (relative to peak), the
    SILK fixture's RMS within the test suite's 0.02.  Each row is
    {"value", "bound", "ok"}; a row that cannot be computed raises."""
    import audio_formats_tpu as af
    import test_opus_silk
    from audio_formats_tpu.parallel import BatchDecoder
    from golden import flac_ref, mp3_ref, opus_ref, qoa_ref, vorbis_ref

    rng = np.random.default_rng(99)
    out = {}

    def row(key, value, bound):
        out[key] = {"value": float(value), "bound": bound,
                    "ok": bool(value <= bound)}

    # MP3: facade vs the independent numpy pipeline (f64, from-spec)
    qs = [np.zeros(576, np.int64) for _ in range(8)]
    for q in qs:
        q[rng.choice(400, 40, replace=False)] = rng.integers(-40, 41, 40)
    data = mp3_ref.build_mp3(
        [[[{"q": qs[i]}], [{"q": qs[i + 1]}]] for i in range(0, 8, 2)],
        channels=1)
    got = af.AudioStream().open_from_memory(data) \
        .read_samples_float(10 ** 6).reshape(-1)
    ref = mp3_ref.decode_mono(qs)
    row("mp3_rel_vs_golden",
        np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12), 1e-4)
    # FLAC + QOA: batch vs golden (integer paths: must be exact)
    t = np.arange(4000)[:, None]
    x = np.clip(np.round(
        9000 * np.sin(2 * np.pi * 300 * t * [1, 1.4] / 44100)),
        -32768, 32767).astype(np.int64)
    fd = flac_ref.build_flac(x, 44100, 16, block_size=1024,
                             stereo_mode="mid_side",
                             modes=["lpc8", "fixed3"])
    qd = qoa_ref.encode(x[:, :1].astype(np.int16), 44100)
    res = BatchDecoder([fd, qd]).decode_all()
    fref = (x.astype(np.float64) * (2 ** 16)
            / 2147483647.0).astype(np.float32)
    row("flac_max_abs_vs_golden", np.abs(res[0] - fref).max(), 0.0)
    qref = (qoa_ref.decode(qd)[0].astype(np.float32)
            * (np.float32(1.0) / np.float32(32767.0)))
    m = min(len(qref), len(res[1]))
    row("qoa_max_abs_vs_golden", np.abs(res[1][:m] - qref[:m]).max(), 0.0)
    # Vorbis: batch vs the independent fixture synthesis
    fix = vorbis_ref.Fixture(channels=1)
    frames = []
    for _ in range(6):
        r = np.zeros(fix.bs0 // 2)
        r[rng.choice(len(r), 30, replace=False)] = \
            rng.integers(-5, 6, 30) * fix.vq_delta
        frames.append({"posts": [[60, 70, 80, 90]],
                       "residues": [r], "long": False})
    vd = fix.build([fix.audio_packet(fr["posts"], fr["residues"])
                    for fr in frames])
    got_v = BatchDecoder([vd]).decode_all()[0].reshape(-1)
    ref_v = vorbis_ref.expected_output(fix, frames).reshape(-1)
    n = min(len(got_v), len(ref_v))
    row("vorbis_rel_vs_golden", np.abs(got_v[:n] - ref_v[:n]).max()
        / (np.abs(ref_v[:n]).max() + 1e-12), 1e-4)
    # Opus SILK: offline fixture RMS check (48k path)
    pkts = [(bytes.fromhex(h), 960) for h in test_opus_silk.SILK_PACKETS]
    od = opus_ref.build_ogg_opus(pkts, channels=1, preskip=0)
    got_o = BatchDecoder([od]).decode_all()[0]
    g = 10.0 ** (-1024 / 5120.0)
    rms = float(np.sqrt((got_o[200:] ** 2).mean())) / g
    row("opus_silk_rms_err_vs_fixture", abs(rms - test_opus_silk.SILK_RMS),
        0.02)
    return out


def measure_accuracy():
    """Continuous accuracy gauge (the BASELINE metric, measured every bench
    run): the in-repo golden rows, then every Opus mode and the C-library
    oracles (libopus, libavcodec, libmpg123, libvorbis) where installed."""
    out = golden_gauges()
    # Opus, every mode, vs the libopus oracle with explicit bounds.
    # Bounds: CELT is float-for-float the reference's pipeline -> 1e-4
    # rel max-abs; SILK/hybrid ride dopus.d's FLOAT SILK (FFmpeg) while
    # libopus is fixed-point int16, so the distance is inherited from the
    # reference — stated as SNR floors (the same contracts the test suite
    # enforces: tests/test_opus_silk.py:207,275).
    out.update(_opus_mode_gauge())
    out.update(_c_oracle_gauge())
    return out


def _c_oracle_gauge():
    """Accuracy anchors against the reference's own C decoder lineages
    (BASELINE.md first milestone, adapted: no D toolchain here, so the
    system C libraries stand in — libavcodec for FLAC bit-exactness,
    libmpg123 (ISO dist10 lineage) for MP3, libvorbis for Vorbis.
    Content is corpus-class (the same generators as the bench corpus).
    Rows carry bounds like the Opus gauge; full suites in
    tests/test_av_oracle.py and tests/test_vorbis_oracle.py."""
    import audio_formats_tpu as af

    res = {}

    def row(key, value, bound):
        res[key] = {"value": float(value), "bound": bound,
                    "ok": bool(value <= bound)}

    # --- FLAC: lossless, must match libavcodec sample-for-sample
    try:
        from golden import av_oracle

        if av_oracle.get_lib() is None:
            raise OSError("libavcodec oracle unavailable")
        rng = np.random.default_rng(41)
        data = bytes(_flac_master(rng, 2.0))
        _f, iv, sr, bits = av_oracle.decode(data)
        if bits == 32:
            iv = (iv.astype(np.int64) >> 16).astype(np.int64)
        ours = af.AudioStream().open_from_memory(data) \
            .read_samples_float(10 ** 7)
        m = min(len(ours), len(iv))
        want = ((iv[:m].astype(np.int64) << 16).astype(np.int32)
                .astype(np.float64) / 2147483647.0).astype(np.float32)
        row("flac_maxabs_vs_libavcodec", np.abs(ours[:m] - want).max(),
            0.0)
    except Exception as e:
        res["flac_maxabs_vs_libavcodec"] = f"skipped: {e}"

    # --- MP3: corpus-class frames at sane level (global_gain 170; the
    # corpus default 214 decodes ~65 dB past full scale, where real
    # decoders legitimately diverge — tests/test_av_oracle.py)
    try:
        from golden import mp3_ref, mpg123_oracle

        if mpg123_oracle.get_lib() is None:
            raise OSError("libmpg123 unavailable")
        rng = np.random.default_rng(43)
        frames = []
        for i in range(0, 56, 2):
            grs = []
            for g in (i, i + 1):
                q = np.zeros(576, np.int64)
                kind = (g // 8) % 3
                if kind == 0:
                    q[rng.choice(300, 25, replace=False)] = \
                        rng.integers(-60, 61, 25)
                elif kind == 1:
                    q[rng.choice(480, 90, replace=False)] = \
                        rng.integers(-12, 13, 90)
                else:
                    q[rng.choice(200, 12, replace=False)] = \
                        rng.integers(-4, 5, 12)
                gr = {"q": q}
                if (g // 2) % 9 == 4:
                    gr["block_type"] = 2
                grs.append([dict(gr) for _ in range(2)])
            frames.append(grs)
        data = bytes(mp3_ref.build_mp3(frames, channels=2,
                                       global_gain=170))
        ref = mpg123_oracle.decode(data, channels=2)
        ours = af.AudioStream().open_from_memory(data) \
            .read_samples_float(10 ** 7)
        m = min(len(ref), len(ours))
        peak = float(np.abs(ref[:m]).max()) + 1e-12
        row("mp3_rel_vs_libmpg123",
            float(np.abs(ref[:m] - ours[:m]).max()) / peak, 1e-4)
    except Exception as e:
        res["mp3_rel_vs_libmpg123"] = f"skipped: {e}"

    # --- Vorbis: a REAL libvorbis encode (psychoacoustics + block
    # switching), libvorbis's own synthesis as ground truth
    try:
        from golden import vorbis_oracle as VO
        from audio_formats_tpu.io import ogg as aogg

        if VO.get_libs() is None:
            raise OSError("libvorbis unavailable")
        rng = np.random.default_rng(47)
        n, rate = 44100, 44100
        t = np.arange(n) / rate
        base = (0.4 * np.sin(2 * np.pi * 440 * t)
                + 0.1 * np.sin(2 * np.pi * 2317 * t)
                + 0.02 * rng.standard_normal(n))
        pcm = np.stack([base, 0.3 * np.sin(2 * np.pi * 523 * t)
                        + 0.02 * rng.standard_normal(n)],
                       1).astype(np.float32)
        headers, audio = VO.encode(pcm, rate, 0.4)
        ref = VO.decode(headers, audio, 2)
        serial = 0x5157
        pages = [aogg.build_page([headers[0]], serial, 0, 0, bos=True),
                 aogg.build_page(headers[1:3], serial, 1, 0)]
        seq, pend = 2, []
        for i, (p, gpos) in enumerate(audio):
            pend.append(p)
            if len(pend) == 8 or i == len(audio) - 1:
                pages.append(aogg.build_page(
                    pend, serial, seq, gpos, eos=(i == len(audio) - 1)))
                pend, seq = [], seq + 1
        data = b"".join(pages)
        ours = af.AudioStream().open_from_memory(data) \
            .read_samples_float(10 ** 7)
        m = min(len(ref), len(ours))
        peak = float(np.abs(ref[:m]).max()) + 1e-12
        row("vorbis_rel_vs_libvorbis",
            float(np.abs(ref[:m] - ours[:m]).max()) / peak, 1e-4)
    except Exception as e:
        res["vorbis_rel_vs_libvorbis"] = f"skipped: {e}"
    return res


class _SkipRow(Exception):
    pass


def _opus_mode_gauge(only=None):
    """All-mode Opus accuracy gauge.  ``only`` (a set of row-name
    substrings) restricts which rows run — used by the sensitivity test
    to re-run a single row cheaply."""
    import audio_formats_tpu as af
    from golden import opus_oracle as O
    from golden import opus_ref

    def _want(key):
        return only is None or any(s in key for s in only)

    res = {}
    if O.get_lib() is None:
        return {"opus_modes": "libopus oracle unavailable"}
    from audio_formats_tpu.models.celt import CeltDecoder
    from audio_formats_tpu.models.opus import RangeDecoder, parse_packet

    rng = np.random.default_rng(21)
    N = 960
    t = np.arange(N * 6) / 48000.0

    def row(key, value, bound, higher_better=False):
        ok = value >= bound if higher_better else value <= bound
        res[key] = {"value": round(float(value), 6 if not higher_better
                                   else 2),
                    "bound": bound, "ok": bool(ok)}

    # --- CELT-only (music): float-for-float the reference's pipeline.
    # Bound tightened to 1e-5 (the row has read 0.0; the 1e-4 contract
    # bound could hide a 10x regression).  Sensitivity of this
    # row is PROVEN by tests/test_gauge_sensitivity.py, which perturbs a
    # CELT table by one ulp-scale step and shows the row fail.
    try:
        if not _want("celt"):
            raise _SkipRow()
        sig = np.clip(7000 * np.sin(2 * np.pi * 440 * t)
                      + 1500 * rng.standard_normal(t.size),
                      -32000, 32000).astype(np.int16)[:, None]
        enc = O.OracleEncoder(48000, 1, bitrate=96000,
                              signal=O.OPUS_SIGNAL_MUSIC,
                              bandwidth=O.OPUS_BANDWIDTH_FULLBAND)
        dec = O.OracleDecoder(48000, 1)
        mine = CeltDecoder(output_channels=1)
        worst = 0.0
        for n in range(6):
            pkt = enc.encode(sig[n * N : (n + 1) * N])
            info = parse_packet(pkt)
            ref = dec.decode(pkt)
            o_ = np.concatenate([
                mine.decode_frame(RangeDecoder(fr),
                                  2 if info["stereo"] else 1,
                                  info["frame_size"], 0, 21)
                for fr in info["frames"]])
            worst = max(worst, float(np.abs(o_ - ref).max())
                        / max(1e-5, float(np.abs(ref).max())))
        row("opus_celt_rel_vs_libopus", worst, 1e-5)
    except _SkipRow:
        pass
    except Exception as e:
        res["opus_celt_rel_vs_libopus"] = f"error: {e}"

    def _snr_stream(bitrate, bandwidth, want_cfgs, key, bound,
                    channels=1, s16=False, force_mode=None):
        if not _want(key):
            return
        try:
            # per-row rng seeded from the row NAME: row content must not
            # depend on which other rows run (a shared rng made adding a
            # row silently change every later row's test signal — the
            # r5 bench saw the s16 row move 48.5 -> 45.1 dB on unchanged
            # code when two stereo rows landed before it)
            rrng = np.random.default_rng(
                np.frombuffer(key.encode()[:16].ljust(16, b"\0"),
                              np.uint32))
            sig = (6000 * np.sin(2 * np.pi * 220 * t)
                   * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
                   + 2000 * np.sin(2 * np.pi * 5000 * t)
                   + 700 * rrng.standard_normal(t.size))
            if channels == 2:
                # coupled content: same voice in both channels with a
                # small delay + level offset (mid/side-friendly, the
                # coupled-SILK worst corner of DESIGN.md)
                sig = np.stack([sig, 0.8 * np.roll(sig, 23)], 1)
            else:
                sig = sig[:, None]
            sig = np.clip(sig, -32000, 32000).astype(np.int16)
            enc = O.OracleEncoder(48000, channels, bitrate=bitrate,
                                  application=O.OPUS_APPLICATION_VOIP,
                                  signal=O.OPUS_SIGNAL_VOICE,
                                  bandwidth=bandwidth)
            if force_mode is not None:
                import ctypes as _ct

                O.get_lib().opus_encoder_ctl(
                    _ct.c_void_p(enc._enc), 11002, force_mode)
            pkts = [(enc.encode(sig[n * N : (n + 1) * N]), N)
                    for n in range(6)]
            cfgs = {parse_packet(p)["config"] for p, _ in pkts}
            if not cfgs <= want_cfgs:
                res[key] = f"skipped: encoder chose configs {sorted(cfgs)}"
                return
            dec48 = O.OracleDecoder(48000, channels)
            g = 10.0 ** (-1024 / 5120.0)
            ref = np.concatenate([dec48.decode(p) for p, _ in pkts]) * g
            if channels == 1:
                ref = ref.reshape(-1, 1)
            data = opus_ref.build_ogg_opus(pkts, channels=channels,
                                           preskip=0)
            if s16:
                from audio_formats_tpu.io.source import MemorySource
                from audio_formats_tpu.models.opus import OpusDecoder

                d = OpusDecoder(MemorySource(data))
                d.s16_parity = True
                got = d.read(10 ** 6)
            else:
                st = af.AudioStream()
                st.open_from_memory(data)
                got = st.read_samples_float(st.get_length_in_frames())
            got = got.reshape(-1, channels)
            m = min(len(got), len(ref))
            err = got[300 : m - 300] - ref[300 : m - 300]
            snr = 10 * np.log10((ref[300 : m - 300] ** 2).mean()
                                / max(1e-20, (err ** 2).mean()))
            row(key, snr, bound, higher_better=True)
        except Exception as e:
            res[key] = f"error: {e}"

    # Bounds are envelope-minus-margin (~3 dB under the weakest measured
    # value), not loose contracts: a regression bigger than the margin
    # fails the bench row (earlier readings: silk48 51.8 dB, hybrid
    # 41.5 dB).
    # --- SILK wideband through the full 48 kHz facade path
    _snr_stream(13000, O.OPUS_BANDWIDTH_WIDEBAND, set(range(0, 12)),
                "opus_silk48_snr_db_vs_libopus", 46.5)
    # --- hybrid (SILK WB + CELT bands 17+)
    _snr_stream(36000, O.OPUS_BANDWIDTH_FULLBAND, set(range(12, 16)),
                "opus_hybrid_snr_db_vs_libopus", 48.0)
    # --- stereo SILK, low bitrate (the encoder codes these as mono-TOC
    # packets — side never coded — through the stereo facade).  r1-r4
    # measured 13.3 dB here; root cause (found r5): decode_superframe's
    # mono copy ran on a 2-sample-delay window while the MS unmix ran on
    # 1, so mono-TOC packets landed one native sample (3 @48k) off the
    # libopus grid.  Both paths now share the 1-sample timeline (libopus
    # dec_API.c semantics) and the row measures 54.1 dB.
    _snr_stream(16000, O.OPUS_BANDWIDTH_WIDEBAND, set(range(0, 12)),
                "opus_silk_coupled_snr_db_vs_libopus", 51.5,
                channels=2, force_mode=1000)
    # --- stereo SILK with the side channel REALLY coded (24 kbps keeps
    # stereo-TOC packets; measured side RMS 0.058, SNR 55.5 — r4 code
    # measured ~5 dB on this shape).  Bound measured-minus-4.
    _snr_stream(24000, O.OPUS_BANDWIDTH_WIDEBAND, set(range(0, 12)),
                "opus_silk_coupled_side_snr_db_vs_libopus", 53.5,
                channels=2, force_mode=1000)
    # --- hybrid stereo (SILK WB + CELT bands 17+, coupled content;
    # measured 54.0 after the timeline unification — r4 code ~4.9 dB)
    _snr_stream(52000, O.OPUS_BANDWIDTH_FULLBAND, set(range(12, 16)),
                "opus_hybrid_stereo_snr_db_vs_libopus", 48.0,
                channels=2, force_mode=1001)
    # --- s16-parity mode (the reference's exact output grid,
    # dopus.d:8098-8105): same stream as silk48, quantized output
    # (measured 48.5 dB — the s16 grid shaves ~3 dB off the float row)
    _snr_stream(13000, O.OPUS_BANDWIDTH_WIDEBAND, set(range(0, 12)),
                "opus_silk48_s16_snr_db", 43.5, s16=True)
    return res


def build_mixed_streams(mp3, flac):
    """The mixed-content lane list: normal MP3 + FLAC lanes alongside every
    other device group — MPEG-2 intensity-stereo MP3 (minimp3.d:963-1000),
    MPEG-1 Layer I and II, QOA, WAV, Vorbis, and Opus CELT-only, SILK-only,
    hybrid and mode-switching lanes (dopus.d:6400).  Everything is built
    from in-repo fixtures (no system library), and a lane that cannot be
    built raises.  Opus content: the stored libopus CELT and SILK packets
    of the test suite; the hybrid lanes are those SILK packets relabelled
    to a hybrid TOC, whose CELT layer then decodes as silence.  Returns
    (streams, check_idx, n_opus_mixed): check_idx are the lanes to compare
    with the per-stream facade."""
    import test_opus_celt
    import test_opus_silk
    from golden import mp3_ref, opus_ref, qoa_ref, vorbis_ref, wav_ref

    rng = np.random.default_rng(5)
    streams = list(mp3[:12]) + list(flac[:12])
    check_idx = []

    def add(data):
        check_idx.append(len(streams))
        streams.append(data)

    # MPEG-2 intensity-stereo MP3 lanes
    for _ in range(2):
        frames = []
        for _f in range(12):
            ql = np.zeros(576, np.int64)
            ql[rng.choice(500, 60, replace=False)] = \
                rng.integers(-40, 41, 60)
            qr = np.zeros(576, np.int64)
            qr[rng.choice(96, 25, replace=False)] = \
                rng.integers(-30, 31, 25)
            frames.append([[{"q": ql}, {"q": qr}]])
        add(mp3_ref.build_mp3_mpeg2(
            frames, channels=2, mode_ext=1, ch1_sfc=2 * 70,
            ch1_iscf=[1, 3, 5, 2, 4, 6, 1, 2, 3, 4, 5, 6,
                      1, 2, 3, 4, 5, 6]))

    # MPEG-1 Layer II and Layer I lanes (the subband lockstep group)
    for n_frames in (5, 9):
        gq = rng.integers(0, 16, size=(n_frames, 3, 30, 12)).tolist()
        scfs = rng.integers(0, 60, size=(n_frames, 30)).tolist()
        add(mp3_ref.build_mp3_l2(gq, scfs, ba=4)[0])
    for n_frames in (6, 4):
        gq = rng.integers(0, 64, size=(n_frames, 32, 12)).tolist()
        scfs = rng.integers(0, 60, size=(n_frames, 32)).tolist()
        add(mp3_ref.build_mp3_l1(gq, scfs, ba=6)[0])

    # QOA + WAV lanes
    t = np.arange(6000)[:, None]
    for k in range(3):
        x = np.clip(np.round(8000 * np.sin(
            2 * np.pi * (150 + 90 * k) * t * [1, 1.31] / 44100)),
            -32768, 32767).astype(np.int64)
        add(qoa_ref.encode(x.astype(np.int16), 44100))
        add(wav_ref.build_wav(wav_ref.pack_pcm(x, 16), fmt_tag=1,
                              channels=2, sample_rate=44100, bits=16))

    # Vorbis lane (independent golden fixture)
    fix = vorbis_ref.Fixture(channels=1)
    frames = []
    for _ in range(8):
        r = np.zeros(fix.bs0 // 2)
        r[rng.choice(len(r), 30, replace=False)] = \
            rng.integers(-5, 6, 30) * fix.vq_delta
        frames.append({"posts": [[60, 70, 80, 90]],
                       "residues": [r], "long": False})
    add(fix.build([fix.audio_packet(fr["posts"], fr["residues"])
                   for fr in frames]))

    # Opus lanes, one group each: CELT-only, SILK-only, hybrid, and
    # mode-switching tours through all three modes
    celt = [(bytes.fromhex(h), 480) for h in test_opus_celt.PACKETS]
    silk = [(bytes.fromhex(h), 960) for h in test_opus_silk.SILK_PACKETS]
    hyb = [(bytes([(13 << 3) | (p[0] & 7)]) + p[1:], n) for p, n in silk]
    for pkts in (celt, silk, hyb):
        for pre in (130, 0):
            add(opus_ref.build_ogg_opus(pkts, channels=1, preskip=pre))
    tours = ([silk[0], silk[1], celt[0], celt[1], silk[2], hyb[3], celt[2]],
             [celt[0], hyb[0], silk[1], celt[3], hyb[2], silk[3]])
    for pkts in tours:
        add(opus_ref.build_ogg_opus(pkts, channels=1, preskip=120))
    return streams, check_idx, len(tours)


def require_clean(dec, what):
    """Raise unless every lane of ``dec`` decoded through its device group:
    a group that raised is demoted to the per-stream path and still gives
    correct PCM, so without this check a device fault reads as a slower
    pass."""
    st = dec.stats
    bad = {k: st.get(k, 0) for k in ("group_demotions", "lanes_demoted")}
    errs = [e for e in dec.errors if e]
    if any(bad.values()) or st.get("group_exceptions") or errs:
        raise RuntimeError(
            f"{what}: {bad}, group_exceptions="
            f"{st.get('group_exceptions')}, lane errors={errs[:4]}")


def facade_deviation(streams, idx, res):
    """{lane: max |batch - facade| / facade peak} for the lanes in idx;
    raises if a lane's length differs from its per-stream decode."""
    import audio_formats_tpu as af

    out = {}
    for i in idx:
        s = af.AudioStream()
        s.open_from_memory(streams[i])
        ref = s.read_samples_float(10 ** 7)
        got = np.asarray(res[i])
        if got.shape != ref.shape:
            raise RuntimeError(f"lane {i}: batch {got.shape} != facade "
                               f"{ref.shape}")
        pk = float(np.abs(ref).max()) + 1e-12
        out[i] = float(np.abs(got - ref).max()) / pk
    return out


def bench_mixed_content(mp3, flac):
    """Scheduler behavior on REALISTIC mixed content (build_mixed_streams
    lanes).  The contract: every lane decodes through a device group
    (demotions == 0, the mode-switching lanes ride the mixed-mode lockstep
    group), and the straggler lanes match their per-stream facade decode.

    Two rates are recorded, each against its own physics:
    - ``rtx`` (headline): host bytes -> device-resident PCM — the same
      pipeline frame as the aggregate headline (the natural sink of a
      decode service is a model on the same card, DESIGN.md §1).
    - ``rtx_numpy``: PCM additionally downloaded to host numpy;
      ``numpy_ceiling_rtx`` records the cap the measured downlink puts on
      it: pcm_bytes / downlink."""
    from audio_formats_tpu.parallel import BatchDecoder

    out = {}
    streams, check_idx, n_opus = build_mixed_streams(mp3, flac)

    # first pass compiles the small-batch bucket variants and is the
    # cold row — measured device-resident, the SAME pipeline frame as
    # the warm headline (rtx).  The download for the correctness checks
    # happens after the cold clock stops; the numpy-sink cold cost is
    # visible as warm_walls_numpy_s + the compile delta regardless.
    t0 = time.perf_counter()
    dec = BatchDecoder(list(streams))
    r_cold = dec.decode_all(output="device")
    r_cold.sync()
    dt_cold = time.perf_counter() - t0
    require_clean(dec, "mixed batch (cold)")
    res = r_cold.to_numpy()
    pcm_bytes = sum(4 * r.size for r in res if r is not None)
    # best-of-3 warm passes, device-resident (headline) and numpy
    warm_dev, warm_np = [], []
    stats_dev = None
    for _ in range(3):
        t0 = time.perf_counter()
        dec = BatchDecoder(list(streams))
        r = dec.decode_all(output="device")
        r.sync()
        w = time.perf_counter() - t0
        require_clean(dec, "mixed batch")
        if not warm_dev or w < min(warm_dev):
            stats_dev = dec.stats
        warm_dev.append(w)
        t0 = time.perf_counter()
        dec2 = BatchDecoder(list(streams))
        dec2.decode_all()
        w_np = time.perf_counter() - t0
        require_clean(dec2, "mixed batch (numpy)")
        if not warm_np or w_np < min(warm_np):
            stats_np = dec2.stats
        warm_np.append(w_np)
    dt = min(warm_dev)
    dt_np = min(warm_np)
    secs = dec.stats["decoded_seconds"]
    out["lanes"] = len(streams)
    out["audio_s"] = round(secs, 1)
    out["rtx"] = round(secs / dt, 1)
    out["warm_walls_s"] = [round(w, 2) for w in warm_dev]
    out["rtx_numpy"] = round(secs / dt_np, 1)
    out["warm_walls_numpy_s"] = [round(w, 2) for w in warm_np]
    out["pcm_MB"] = round(pcm_bytes / 1e6, 1)
    out["rtx_cold"] = round(secs / dt_cold, 1)
    out["cold_start_s"] = round(dt_cold, 1)
    s = stats_dev
    out["host_s"] = round(s["host_ms"] / 1e3, 2)
    out["enqueue_s"] = round(s["enqueue_ms"] / 1e3, 2)
    out["host_cpu_s"] = round(s["host_cpu_ms"] / 1e3, 2)
    out["host_rtx_per_core_cpu"] = round(
        secs / max(1e-9, s["host_cpu_ms"] / 1e3), 1)
    out["host_s_by_format"] = {
        k: round(v / 1e3, 3) for k, v in s["host_ms_by_format"].items()}
    out["enqueue_s_by_format"] = {
        k: round(v / 1e3, 3)
        for k, v in s["enqueue_ms_by_format"].items()}
    out["h2d_MB"] = round(s["h2d_bytes"] / 1e6, 2)
    # actual downloaded bytes of the numpy-sink pass: quantifies the
    # padded-window d2h overhead over pcm_MB (measured ~1.35x at small
    # batch — the numpy row is link physics, not scheduler cost)
    out["d2h_MB_numpy"] = round(stats_np.get("d2h_bytes", 0) / 1e6, 2)
    out["group_demotions"] = dec.stats["group_demotions"]
    out["lanes_demoted"] = dec.stats.get("lanes_demoted", 0)
    out["opus_mixed_lanes"] = dec.stats.get("opus_mixed_lanes", 0)
    out["opus_mixed_expected"] = n_opus
    # straggler lanes must match their per-stream facade decode
    out["straggler_rel_vs_facade"] = max(
        facade_deviation(streams, check_idx, res).values())
    return out


def measure_link():
    """Host<->device bandwidth: best of three 8 MB probes each way."""
    import jax

    a = np.zeros(8 << 20, np.uint8)
    jax.device_put(a[: 1 << 20])  # warm
    up = down = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        x = jax.device_put(a)
        _ = np.asarray(x[0])
        up = max(up, a.nbytes / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        _ = np.asarray(x)
        down = max(down, a.nbytes / (time.perf_counter() - t0))
    return up, down


# --------------------------------------------------------------- main

_T0 = time.time()


def _mark(msg):
    """Phase marker on stderr (never stdout — the JSON contract)."""
    print(f"# [{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def device_record():
    """The device every number of a run comes from; exits unless JAX's
    first device is a GPU (no number is ever printed for another one)."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform} "
                         f"({dev.device_kind}); nothing runs without one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "name_power_limit": smi.stdout.strip().splitlines()[0]}


def main():
    from audio_formats_tpu.parallel import BatchDecoder
    from audio_formats_tpu.utils.compile_cache import enable_compile_cache

    device = device_record()
    enable_compile_cache()

    n_mp3 = int(os.environ.get("BENCH_MP3_STREAMS", "512"))
    n_flac = int(os.environ.get("BENCH_FLAC_STREAMS", "512"))
    mp3, mp3_secs, flac, flac_secs, flac_1w = build_corpus(n_mp3, n_flac)

    _mark("corpus ready; probing link")
    up_bw, down_bw = measure_link()
    from audio_formats_tpu.host import native as _native
    # MP3 pooled bit plane: bitwise-identical output, ships exactly the
    # copied maindata words (bit-plane inflation ~1.0) for ~1 ms/window
    # of on-device row rebuild — cheap enough to run whenever single-card
    if os.environ.get("AF_TPU_MP3_POOL_BITS") is None:
        os.environ["AF_TPU_MP3_POOL_BITS"] = "1"
    mp3_mode = "pool" if os.environ.get(
        "AF_TPU_MP3_POOL_BITS") not in (None, "", "0") else "split"

    # ---- FLAC wire-mode pick: EMPIRICAL, not modeled.  Each mode decodes
    # the same one-window-per-lane subset twice (first pass compiles) and
    # the faster wall wins; both probe rates are recorded.
    probe_rates = {}
    if os.environ.get("AF_TPU_FLAC_DEVICE_RICE") is None \
            and _native.get_lib() is not None:
        sub = flac_1w[: min(128, n_flac)]
        for mode, envval in (("packed", "0"), ("device_rice", "1")):
            os.environ["AF_TPU_FLAC_DEVICE_RICE"] = envval
            BatchDecoder(sub).decode_all(output="device").sync()
            t0 = time.perf_counter()
            d = BatchDecoder(sub)
            d.decode_all(output="device").sync()
            require_clean(d, f"wire probe {mode}")
            probe_rates[mode] = round(
                d.stats["decoded_seconds"] / (time.perf_counter() - t0), 1)
            _mark(f"wire probe {mode}: {probe_rates[mode]}")
        winner = max(probe_rates, key=probe_rates.get)
        os.environ["AF_TPU_FLAC_DEVICE_RICE"] = \
            "1" if winner == "device_rice" else "0"
    flac_mode = "device_rice" if os.environ.get(
        "AF_TPU_FLAC_DEVICE_RICE") not in (None, "", "0") else "packed"
    _mark(f"wire mode: flac={flac_mode} mp3={mp3_mode}")

    # ---- cold full pass: compiles every shape the timed reps will see
    # (the REAL corpus, not lookalike slices — round 3's warmup used
    # different slice shapes, so its "warm" reps recompiled and 77% of
    # the recorded wall was unaccounted compile tails).  Also the honest
    # cold-start number for a fresh service process.
    _mark("cold full pass (compile + cold-start measurement)")
    t0 = time.perf_counter()
    dec = BatchDecoder(mp3 + flac)
    dec.decode_all(output="device").sync()
    cold_s = time.perf_counter() - t0
    require_clean(dec, "headline (cold)")
    cold_rtx = dec.stats["decoded_seconds"] / cold_s

    # best-of-N warm reps; the rep budget counts from the FIRST REP, and
    # every wall is recorded in rep_walls_s.
    reps = int(os.environ.get("BENCH_REPS", "5"))
    _mark("end-to-end reps")
    best_dt, best_stats, best_split = float("inf"), None, None
    rep_walls = []
    rep_host_cpu = []   # per-rep parse-thread CPU: in-artifact spread
    budget_s = float(os.environ.get("BENCH_REP_BUDGET_S", "300"))
    t_reps0 = time.time()
    for ri in range(reps):
        t0 = time.perf_counter()
        dec = BatchDecoder(mp3 + flac)
        t_probe = time.perf_counter() - t0
        res = dec.decode_all(output="device")
        t_call = time.perf_counter() - t0 - t_probe
        res.sync()
        t_sync = time.perf_counter() - t0 - t_probe - t_call
        dt = time.perf_counter() - t0
        require_clean(dec, f"headline rep {ri + 1}")
        rep_walls.append(round(dt, 2))
        rep_host_cpu.append(round(dec.stats.get("host_cpu_ms", 0.0)
                                  / 1e3, 3))
        if dt < best_dt:
            best_dt, best_stats = dt, dict(dec.stats)
            best_split = (t_probe, t_call, t_sync)
        if time.time() - t_reps0 > budget_s and ri + 1 < reps:
            _mark(f"rep budget spent after rep {ri + 1}/{reps}")
            break

    audio = best_stats["decoded_seconds"]
    rtx = audio / best_dt
    # wall decomposition that closes: probe (stream
    # open/index), host entropy, device enqueue (payload assembly +
    # upload dispatch), device wait (sync), other (Python glue).  host
    # and enqueue timers run in the decode_call section, possibly on
    # concurrent threads, so `other` is derived from the decode_call
    # wall minus their sum (clamped: thread overlap can over-count).
    probe_s, call_s, sync_s = best_split
    host_s = best_stats["host_ms"] / 1e3
    enq_s = best_stats["enqueue_ms"] / 1e3
    other_s = max(0.0, call_s - host_s - enq_s)
    accounted = probe_s + host_s + enq_s + sync_s
    # the upload rides the async dispatch inside decode_all, invisible to
    # the host/enqueue thread timers: implied_h2d_s = bytes actually
    # shipped / the probed uplink is recorded next to `other`.
    implied_h2d = best_stats["h2d_bytes"] / max(1.0, up_bw)
    split = {
        "probe": round(probe_s, 2), "host": round(host_s, 2),
        "enqueue": round(enq_s, 2), "device_wait": round(sync_s, 2),
        "other": round(other_s, 2),
        "implied_h2d_s": round(implied_h2d, 2),
        "closes_frac": round(min(
            1.0, (accounted + min(other_s, implied_h2d)) / best_dt), 3),
    }

    # full-download variant (every PCM sample crosses back to the host),
    # measured on a subset
    ndl = max(8, min(64, n_mp3, n_flac))
    t0 = time.perf_counter()
    dec_np = BatchDecoder(mp3[:ndl] + flac[:ndl])
    dec_np.decode_all(output="numpy")
    require_clean(dec_np, "full-download subset")
    dl_rtx = dec_np.stats["decoded_seconds"] / (time.perf_counter() - t0)

    _mark("full-download subset done; accuracy gauge")
    accuracy = measure_accuracy()
    mixed = bench_mixed_content(mp3, flac)
    # the numpy-output row's own physics: downloading the PCM at the
    # probed downlink caps ANY decoder at this rate
    mixed["d2h_link_MBps"] = round(down_bw / 1e6, 1)
    mixed["numpy_ceiling_rtx"] = round(
        mixed["audio_s"] / (mixed["pcm_MB"] * 1e6 / down_bw), 1)
    _mark("mixed-content gauge done; device-resident rows")
    dsp_rtx = bench_device_dsp_only()
    res_rtx, res_bytes, res_audio = bench_device_resident_mp3(mp3, B=1024)
    fres_rtx, fres_bytes, fres_audio = bench_device_resident_flac(
        flac, B=512)
    qres_rtx, qres_bytes, qres_audio = bench_device_resident_qoa()
    vres_rtx, vres_bytes, vres_audio = bench_device_resident_vorbis()
    cres_rtx, cres_bytes, cres_audio = bench_device_resident_celt()
    _mark("device-resident rows done; batch encode rows")
    enc_rows = bench_batch_encode(up_bw=up_bw, down_bw=down_bw)
    enc_rows.update(bench_device_resident_encode())
    # aggregate device-resident MP3+FLAC: per-format window rates on the
    # device extrapolated to the CORPUS audio proportions (512 MP3 + 512
    # FLAC streams), so the mix weighting matches the end-to-end metric,
    # not the window sizes
    mp3_audio_total, flac_audio_total = sum(mp3_secs), sum(flac_secs)
    agg_rtx = (mp3_audio_total + flac_audio_total) / (
        mp3_audio_total / res_rtx + flac_audio_total / fres_rtx)

    _mark("assembling result")
    by = {k: round(v, 1) for k, v in
          best_stats["decoded_seconds_by_format"].items()}
    compressed = sum(len(b) for b in mp3 + flac)
    link_ceiling = audio / (compressed / max(1.0, up_bw))
    host_by = {k: round(v / 1e3, 2) for k, v in
               best_stats.get("host_ms_by_format", {}).items()}
    enq_by = {k: round(v / 1e3, 2) for k, v in
              best_stats.get("enqueue_ms_by_format", {}).items()}
    host_cpu_by = {k: round(v / 1e3, 2) for k, v in
                   best_stats.get("host_cpu_ms_by_format", {}).items()}
    # per-core host rate from THREAD CPU: the wall-based host timer also
    # counts time the parse thread waits for a core, so CPU time is the
    # quantity a host scales by its pool width.
    host_cpu_s = best_stats.get("host_cpu_ms", 0.0) / 1e3
    host_wall_s = best_stats["host_ms"] / 1e3
    # BOTH denominators recorded: _wall divides by the host stage's
    # summed wall time, _cpu by summed parse-thread CPU
    # (time.thread_time).
    host_rtx_core_wall = round(audio / max(1e-9, host_wall_s), 1)
    host_rtx_core_cpu = round(audio / max(1e-9, host_cpu_s), 1) \
        if host_cpu_s else 0.0
    host_rtx_core = host_rtx_core_cpu or host_rtx_core_wall
    detail = {
        "device": device,
        "streams": {"mp3": n_mp3, "flac": n_flac,
                    "distinct": True, "stereo": True},
        "decoded_audio_seconds": round(audio, 1),
        "decoded_seconds_by_format": by,
        "wall_s": round(best_dt, 3),
        # best-of-N protocol: compile excluded by the untimed cold pass on
        # the SAME streams; budget counted from rep 1; every rep's wall
        # recorded
        "reps_run": len(rep_walls),
        "rep_walls_s": rep_walls,
        # per-rep parse-thread CPU seconds: the within-run spread of the
        # quantity under host_rtx_per_core_cpu
        "rep_host_cpu_s": rep_host_cpu,
        "cold_start_s": round(cold_s, 1),
        "cold_rtx": round(cold_rtx, 1),
        # wall decomposition of the best rep (sums to closes_frac of wall)
        "wall_split_s": split,
        "windows": best_stats["windows"],
        "h2d_bytes": best_stats["h2d_bytes"],
        # honest speed-of-light: even uploading NOTHING but the
        # compressed bytes, the measured uplink caps end-to-end at
        # audio_s / (compressed_bytes / up_MBps)
        "compressed_bytes": compressed,
        "flac_wire_mode": flac_mode,
        "mp3_wire_mode": mp3_mode,
        # one-window-per-lane probe rates behind the empirical pick
        "wire_probe_rtx": probe_rates,
        "h2d_inflation": round(
            best_stats["h2d_bytes"] / max(1, compressed), 2),
        "link_bound_ceiling_rtx": round(link_ceiling, 1),
        "link_MBps": {"up": round(up_bw / 1e6, 1),
                      "down": round(down_bw / 1e6, 1)},
        # fraction of the wire-speed-of-light this run reached
        "ceiling_fraction": round(rtx / max(1e-9, link_ceiling), 3),
        "full_download_rtx": round(dl_rtx, 2),
        "device_dsp_only_rtx_mp3_b1024": round(dsp_rtx, 2),
        # full decode (entropy FSM + DSP) with inputs device-resident:
        # the device's rate, independent of the host stage and transfers
        "device_resident_full_decode_rtx_mp3_b1024": round(res_rtx, 2),
        "device_resident_full_decode_rtx_flac_b512": round(fres_rtx, 2),
        "device_resident_full_decode_rtx_qoa_b32": round(qres_rtx, 2),
        "device_resident_vorbis_synth_rtx_b256": round(vres_rtx, 2),
        "device_resident_celt_synth_rtx_b256": round(cres_rtx, 2),
        **enc_rows,
        # aggregate MP3+FLAC on the device, corpus-audio weighted
        "device_resident_full_decode_rtx_agg_b1024": round(agg_rtx, 2),
        "device_resident_window": {
            "bytes": res_bytes, "audio_s": round(res_audio, 1),
            "flac_bytes": fres_bytes,
            "flac_audio_s": round(fres_audio, 1),
            "qoa_bytes": qres_bytes,
            "qoa_audio_s": round(qres_audio, 1),
            "vorbis_bytes": vres_bytes,
            "vorbis_audio_s": round(vres_audio, 1),
            "celt_bytes": cres_bytes,
            "celt_audio_s": round(cres_audio, 1)},
        # host entropy stage rate per core (the host-side ceiling: a
        # host scales this by its parse-pool width) with the per-format
        # split, computed from summed parse-thread CPU (host_cpu_s_*)
        "host_stage_rtx_per_core": host_rtx_core,
        "host_stage_rtx_per_core_wall": host_rtx_core_wall,
        "host_stage_rtx_per_core_cpu": host_rtx_core_cpu,
        "host_wall_s": round(host_wall_s, 2),
        "host_cpu_s": round(host_cpu_s, 2),
        "host_cpu_s_by_format": host_cpu_by,
        "host_s_by_format": host_by,
        "enqueue_s_by_format": enq_by,
        # enqueue sub-stage attribution: what the per-window dispatch
        # loop spends building pools / assembling per-lane columns / in
        # the device_put call itself
        "enqueue_substage_s": {
            k[len("enq_"):-len("_ms")]: round(v / 1e3, 3)
            for k, v in sorted(best_stats.items())
            if k.startswith("enq_") and k.endswith("_ms")},
        "host_mp3_parse_rtx_per_core": round(getattr(
            bench_device_resident_mp3, "host_parse_rtx", 0.0), 1),
        "accuracy_vs_golden": accuracy,
        "mixed_content": mixed,
    }
    # full detail: file + stderr (stdout carries one compact line)
    detail_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "bench_detail.json")
    with open(detail_path, "w") as f:
        json.dump(detail, f, indent=1)
    print("# detail: " + json.dumps(detail), file=sys.stderr)

    def _num(x, default=0.0):
        return x if isinstance(x, (int, float)) else default

    acc = accuracy if isinstance(accuracy, dict) else {}

    def _gauge(key):
        v = acc.get(key)
        if isinstance(v, dict):
            return {"v": v.get("value"), "ok": v.get("ok")}
        return v if isinstance(v, (int, float)) else -1

    mx = mixed if isinstance(mixed, dict) else {}
    compact = {
        "metric": "aggregate realtime decode factor "
                  "(MP3+FLAC, host bytes -> device PCM, batch "
                  f"{n_mp3 + n_flac})",
        "value": round(rtx, 2),
        "unit": "x realtime/card",
        "detail": {
            "device": device,
            "audio_s": round(audio, 1),
            "wall_s": round(best_dt, 2),
            "reps_run": len(rep_walls),
            "rep_walls_s": rep_walls,
            "cold_start_s": round(cold_s, 1),
            "wall_split_s": split,
            "wire": {"flac": flac_mode, "mp3": mp3_mode,
                     "probe_rtx": {k: _num(v) for k, v in
                                   probe_rates.items()},
                     "h2d_inflation": detail["h2d_inflation"]},
            "link_up_MBps": round(up_bw / 1e6, 1),
            "ceiling_fraction": detail["ceiling_fraction"],
            "chip_rtx": {
                "agg_b1024": round(agg_rtx, 1),
                "mp3": round(res_rtx, 1), "flac": round(fres_rtx, 1),
                "qoa": round(qres_rtx, 1),
                "vorbis_synth": round(vres_rtx, 1),
                "celt_synth": round(cres_rtx, 1)},
            "encode_rtx": {
                k.replace("batch_encode_rtx_", "").replace(
                    "device_resident_encode_rtx_", "chip_").replace(
                    "device_", "dev_"): v
                for k, v in enc_rows.items() if isinstance(v, (int, float))},
            "host_rtx_per_core_wall": host_rtx_core_wall,
            "host_rtx_per_core_cpu": host_rtx_core_cpu,
            "host_cpu_s_by_format": host_cpu_by,
            "host_s_by_format": host_by,
            "gauges": {
                "mp3_rel": _gauge("mp3_rel_vs_golden"),
                "flac_abs": _gauge("flac_max_abs_vs_golden"),
                "qoa_abs": _gauge("qoa_max_abs_vs_golden"),
                "vorbis_rel": _gauge("vorbis_rel_vs_golden"),
                "flac_av": _gauge("flac_maxabs_vs_libavcodec"),
                "mp3_mpg123": _gauge("mp3_rel_vs_libmpg123"),
                "vorbis_libvorbis": _gauge("vorbis_rel_vs_libvorbis"),
                "celt_rel": _gauge("opus_celt_rel_vs_libopus"),
                "silk48_snr": _gauge("opus_silk48_snr_db_vs_libopus"),
                "hybrid_snr": _gauge("opus_hybrid_snr_db_vs_libopus"),
                "silk_coupled_snr": _gauge(
                    "opus_silk_coupled_snr_db_vs_libopus"),
                "silk_coupled_side_snr": _gauge(
                    "opus_silk_coupled_side_snr_db_vs_libopus"),
                "hybrid_stereo_snr": _gauge(
                    "opus_hybrid_stereo_snr_db_vs_libopus"),
                "silk_s16_snr": _gauge("opus_silk48_s16_snr_db"),
            },
            "mixed": {k: mx.get(k) for k in (
                "lanes", "rtx", "rtx_numpy", "numpy_ceiling_rtx",
                "rtx_cold", "host_s", "enqueue_s", "host_cpu_s",
                "group_demotions", "lanes_demoted",
                "straggler_rel_vs_facade")},
        },
    }
    line = json.dumps(compact)
    if len(line) > 1950:  # stdout contract: ONE parseable line < 2000 B
        compact["detail"].pop("gauges", None)
        compact["detail"].pop("host_s_by_format", None)
        line = json.dumps(compact)
    print(line)


if __name__ == "__main__":
    main()
