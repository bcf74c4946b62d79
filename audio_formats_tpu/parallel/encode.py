"""Batched encoders — N independent streams encode in lockstep on device.

The reference encodes one stream at a time (QOAEncoder qoa.d:538,
WAVEncoder wav.d:365).  Here the per-frame device work — QOA's brute-force
16-scalefactor LMS search (qoa.d:345-383, already a vectorized axis in
ops/lms.py) and WAV's TPDF dither + exact round-half-up quantize
(wav.d:679-701) — lifts to a [streams × channels] lane axis: one device
call per frame window (QOA) or per batch (WAV) serves every stream.

Outputs are byte-exact vs the streaming single-stream encoders (tested):
full frames run in lockstep; each stream's final partial frame (per-lane
length would break the static frame shape) finishes with a per-stream
call using identical kernels.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..config import EncodingOptions
from ..models import qoa as qoa_mod
from ..models.qoa import (QOA_FRAME_LEN, QOA_LMS_LEN, QOA_MAGIC,
                          _frame_size as _qoa_frame_size)
from ..ops.lms import QOA_SLICE_LEN, QOA_SLICES_PER_FRAME
from ..ops import lms as lms_ops
from ..ops import pcm as pcm_ops


def encode_qoa_batch(pcms: Sequence[np.ndarray], sample_rate: int,
                     parallel_frames: bool = True,
                     mesh=None, stats: dict = None) -> List[bytes]:
    """Encode N streams of float PCM [(frames, ch)] to QOA byte streams.

    Channel counts may differ per stream; lanes = Σ channels.  Byte-exact
    vs models/qoa.py QoaEncoder ONLY with ``parallel_frames=False``; the
    default frame-parallel layout emits different (equally valid) bytes —
    see below.  NOTE: the default flipped to ``True`` in round 4, so the
    output bytes of this public API changed for callers relying on the
    old sequential layout.

    ``parallel_frames=True`` (the default) selects the lane-parallel
    layout: QOA
    stores the pre-frame LMS state IN each frame header (qoa.d:315-326),
    so any per-frame starting state yields a valid stream — starting
    every frame from the encoder's initial state makes all frames
    independent lanes ([streams x frames x channels] instead of
    [streams x channels]), trading a fraction of a dB of SNR at each
    frame boundary (the LMS re-converges within a few slices) for a
    lane count that actually fills the device.  Output differs from (but
    decodes identically in contract to) the sequential encoder; each
    stream's FIRST frame is byte-identical to it.  Pass
    ``parallel_frames=False`` for byte-exact parity with the streaming
    single-stream QoaEncoder."""
    n = len(pcms)
    chans = [p.shape[1] for p in pcms]
    lengths = [p.shape[0] for p in pcms]

    # quantize float input exactly like QoaEncoder.write — on HOST: the
    # device quantize is bit-identical (TwoSum exact round-half-up ==
    # the f64 golden, A/B-tested) but costs an upload+download roundtrip
    # of the whole PCM per stream, which dominated the old encode wall
    def _q(p):
        q = pcm_ops.quantize_float_to_int_np(
            np.ascontiguousarray(p).reshape(-1), "s16")
        return q.reshape(-1, p.shape[1]).astype(np.int32)

    if parallel_frames:
        # lazy per-stream quantize: stream i quantizes when its first
        # chunk packs, so the host CPU cost overlaps earlier chunks'
        # wire + search instead of preceding all device work
        class _LazyS16:
            __slots__ = ("cache",)

            def __init__(self):
                self.cache = {}

            def __getitem__(self, i):
                a = self.cache.get(i)
                if a is None:
                    a = self.cache[i] = _q(pcms[i])
                return a

        return _encode_qoa_frames_parallel(
            _LazyS16(), chans, lengths, sample_rate, mesh=mesh,
            stats=stats)
    s16 = [_q(p) for p in pcms]
    L = sum(chans)
    lane_of = np.cumsum([0] + chans)
    hist = np.zeros((L, QOA_LMS_LEN), np.int32)
    wts = np.tile(np.array([0, 0, -(1 << 13), 1 << 14], np.int32), (L, 1))
    outs = [bytearray(b"\0" * 8) for _ in range(n)]

    n_full = [ln // QOA_FRAME_LEN for ln in lengths]
    W = max(n_full) if n_full else 0
    for w in range(W):
        lanes = np.zeros((L, QOA_FRAME_LEN), np.int32)
        active = np.zeros(n, bool)
        for i in range(n):
            if w < n_full[i]:
                active[i] = True
                seg = s16[i][w * QOA_FRAME_LEN : (w + 1) * QOA_FRAME_LEN]
                lanes[lane_of[i] : lane_of[i + 1]] = seg.T
        sf, codes, h2, w2 = lms_ops.qoa_encode_frame_scan(
            lanes, hist, wts, np.int32(QOA_FRAME_LEN))
        sf, codes, h2, w2 = map(np.asarray, (sf, codes, h2, w2))
        for i in range(n):
            if not active[i]:
                continue
            sl = slice(lane_of[i], lane_of[i + 1])
            outs[i] += qoa_mod.pack_qoa_frame(
                sample_rate, chans[i], QOA_FRAME_LEN,
                hist[sl], wts[sl], sf[sl], codes[sl])
        upd = np.repeat(active, chans)
        hist[upd] = h2[upd]
        wts[upd] = w2[upd]

    # final partial frames: per-lane lengths break the lockstep shape, so
    # each finishes with its own (identical-kernel) call
    for i in range(n):
        rem = lengths[i] - n_full[i] * QOA_FRAME_LEN
        if rem <= 0:
            continue
        sl = slice(lane_of[i], lane_of[i + 1])
        lanes = np.zeros((chans[i], QOA_FRAME_LEN), np.int32)
        lanes[:, :rem] = s16[i][n_full[i] * QOA_FRAME_LEN :].T
        sf, codes, h2, w2 = lms_ops.qoa_encode_frame_scan(
            lanes, hist[sl], wts[sl], np.int32(rem))
        outs[i] += qoa_mod.pack_qoa_frame(
            sample_rate, chans[i], rem, hist[sl], wts[sl],
            np.asarray(sf), np.asarray(codes))

    for i in range(n):
        outs[i][0:8] = ((QOA_MAGIC << 32) | lengths[i]).to_bytes(8, "big")
    return [bytes(o) for o in outs]


def _encode_qoa_frames_parallel(s16, chans, lengths, sample_rate,
                                mesh=None, stats=None) -> List[bytes]:
    """Frame-parallel QOA encode: every (stream, frame, channel) is an
    independent lane of a lockstep device call (chunked to bound memory
    AND to pipeline the wire), each frame starting from the encoder's
    initial LMS state {0,0,-2^13,2^14} (qoa.d:568-581) which is written
    into its header.  Per-lane frame lengths let final partial frames
    ride the same call.

    Wire discipline (transfers bound the encode wall when the link is
    slow): each <=2048-lane chunk runs build rows -> device_put -> launch ->
    copy_to_host_async as ONE pipeline step, so chunk k's upload,
    search, and download all stream while the host quantizes + packs
    chunk k+1's rows (everything is async until the final resolve);
    only the live lanes of each word plane come back (bucketed device
    slice).  If ``stats`` (a dict), h2d_bytes/d2h_bytes are recorded."""
    import jax

    n = len(chans)
    # lane layout: frame-major per stream, channel-minor
    spans = []  # (stream, frame_idx, frame_samples, lane_start)
    by_stream = [[] for _ in range(n)]
    lane = 0
    for i in range(n):
        nf = -(-lengths[i] // QOA_FRAME_LEN) if lengths[i] else 0
        for f in range(nf):
            fs = min(QOA_FRAME_LEN, lengths[i] - f * QOA_FRAME_LEN)
            spans.append((i, f, fs, lane))
            by_stream[i].append((fs, lane))
            lane += chans[i]
    L = lane
    CHUNK = 2048  # lanes per device call: small enough that several
    # chunks pipeline upload/compute/download, large enough to fill the
    # device; chunks cut at span boundaries so a
    # frame's channels stay together
    hi_all = np.zeros((L, QOA_SLICES_PER_FRAME), np.uint32)
    lo_all = np.zeros((L, QOA_SLICES_PER_FRAME), np.uint32)
    h2d = d2h = 0
    # ---- pipeline: per chunk, build rows -> put -> launch -> async
    # download.  Everything up to the final resolve is async, so while
    # the host packs chunk k+1's rows, chunk k's bytes are already on
    # the wire and its search on the chip — the wall becomes
    # max(host pack, wire, search) instead of their sum.
    fetches = []  # (c0, c1, hi_d, lo_d)
    si = 0
    while si < len(spans):
        c0 = spans[si][3]
        sj = si
        while sj < len(spans) and \
                spans[sj][3] + chans[spans[sj][0]] - c0 <= CHUNK:
            sj += 1
        sj = max(sj, si + 1)
        last = spans[sj - 1]
        c1 = last[3] + chans[last[0]]
        Lc = c1 - c0
        # pow2 lane bucket: chunk widths vary, the compiled kernel should not
        Lp = min(CHUNK, max(256, 1 << (Lc - 1).bit_length()))
        # int16 rows: halves the upload (values are s16 by construction;
        # the kernel casts to int32 on device)
        rows = np.zeros((Lp, QOA_FRAME_LEN), np.int16)
        flen = np.zeros(Lp, np.int32)  # pad lanes: len 0 -> fully inactive
        for (i, f, fs, ls) in spans[si:sj]:
            seg = s16[i][f * QOA_FRAME_LEN : f * QOA_FRAME_LEN + fs]
            rows[ls - c0 : ls - c0 + chans[i], :fs] = seg.T
            flen[ls - c0 : ls - c0 + chans[i]] = fs
        h2d += rows.nbytes + flen.nbytes
        if mesh is not None:
            # multi-chip: shard the lane axis over 'data' (Lp is a pow2
            # bucket, divisible by any pow2 data axis); word planes come
            # back lane-sharded and concatenate bit-exactly
            from jax.sharding import NamedSharding, PartitionSpec as P

            rows = jax.device_put(rows, NamedSharding(mesh, P("data", None)))
            flen = jax.device_put(flen, NamedSharding(mesh, P("data")))
        else:
            rows = jax.device_put(rows)
            flen = jax.device_put(flen)
        # fused search + DEVICE word pack: the only download is the
        # [L, 256] x 2 u32 word planes (8 B/slice), not codes+sf (84 B)
        hi, lo = lms_ops.qoa_encode_frame_words(rows, flen)
        if mesh is None and Lc < Lp:
            # fetch only the live lanes (256-bucketed so the device
            # slice compiles a bounded shape set, not one per call)
            Lf = min(Lp, -(-Lc // 256) * 256)
            hi, lo = hi[:Lf], lo[:Lf]
        for a in (hi, lo):
            try:
                a.copy_to_host_async()
            except AttributeError:
                pass
        fetches.append((c0, c1, hi, lo))
        si = sj
    # ---- resolve
    for (c0, c1, hi, lo) in fetches:
        Lc = c1 - c0
        hi = np.asarray(hi)
        lo = np.asarray(lo)
        d2h += hi.nbytes + lo.nbytes
        hi_all[c0:c1] = hi[:Lc]
        lo_all[c0:c1] = lo[:Lc]
    if stats is not None:
        stats["h2d_bytes"] = h2d
        stats["d2h_bytes"] = d2h
    # constant pre-frame LMS state words (history 0, weights
    # {0,0,-2^13,2^14}) — the frame-parallel contract writes the initial
    # state into every frame header (qoa.d:315-326)
    state_words = (b"\x00" * 8
                   + b"\x00\x00\x00\x00\xe0\x00\x40\x00")
    outs = []
    for i in range(n):
        ch = chans[i]
        parts = [((QOA_MAGIC << 32) | lengths[i]).to_bytes(8, "big")]
        st = state_words * ch
        for (fs, ls) in by_stream[i]:
            ns = (fs + QOA_SLICE_LEN - 1) // QOA_SLICE_LEN
            f_size = _qoa_frame_size(ch, ns)
            hdr = ((ch << 56) | (sample_rate << 32) | (fs << 16) | f_size)
            # interleave (slice-major, channel-minor) hi/lo into BE u64s
            w = np.empty((ns, ch, 2), dtype=">u4")
            w[:, :, 0] = hi_all[ls : ls + ch, :ns].T
            w[:, :, 1] = lo_all[ls : ls + ch, :ns].T
            parts.append(hdr.to_bytes(8, "big") + st + w.tobytes())
        outs.append(b"".join(parts))
    return outs


def encode_wav_batch(pcms: Sequence[np.ndarray], sample_rate: int,
                     options: EncodingOptions = None,
                     mesh=None) -> List[bytes]:
    """Encode N float streams to WAV, batching the TPDF-dither + exact
    round-half-up quantize into ONE padded [streams, n] device call (the
    dither noise is seed+position determined, so each lane reproduces the
    single-stream encoder's bytes exactly).  Byte-exact vs WavEncoder."""
    import struct

    from ..config import AudioSampleFormat
    from ..models.wav import _FMT_INFO

    options = options or EncodingOptions()
    fmt = options.sample_format
    sample_size, wformat, qkind = _FMT_INFO[fmt]
    n = len(pcms)
    if fmt in (AudioSampleFormat.fp32, AudioSampleFormat.fp64):
        kindstr = "<f4" if fmt == AudioSampleFormat.fp32 else "<f8"
        bodies = [np.ascontiguousarray(p).reshape(-1).astype(kindstr)
                  .tobytes() for p in pcms]
    else:
        flats = [np.ascontiguousarray(p, np.float32).reshape(-1)
                 for p in pcms]
        lens = [f.shape[0] for f in flats]
        maxn = max(lens) if lens else 0
        rows = np.zeros((n, maxn), np.float32)
        for i, f in enumerate(flats):
            rows[i, : lens[i]] = f
        seeds = [(options.dither_seed + 0) & 0xFFFFFFFF] * n
        # fused device quantize + byte pack: the download is exactly the
        # payload bytes (3 B/sample for s24), not a 4 B int32 plane
        bodies = pcm_ops.quantize_pack_rows(
            rows, lens, seeds, qkind, sample_size,
            dither=options.enable_dither and qkind != "s32", mesh=mesh)
    outs = []
    for i, p in enumerate(pcms):
        ch = p.shape[1]
        frame_size = sample_size * ch
        data = bodies[i]
        riff_length = 4 + (4 + 4 + 16) + (4 + 4 + len(data))
        hdr = (b"RIFF" + struct.pack("<I", riff_length & 0xFFFFFFFF)
               + b"WAVE" + b"fmt " + struct.pack("<I", 16)
               + struct.pack("<HHIIHH", wformat, ch, sample_rate,
                             sample_rate * frame_size, frame_size,
                             sample_size * 8)
               + b"data" + struct.pack("<I", len(data) & 0xFFFFFFFF))
        outs.append(hdr + data)
    return outs
