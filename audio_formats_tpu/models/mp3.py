"""MP3 decoder host stage: sync/index/side-info/scalefactors/Huffman.

Parity target: minimp3.d + minimp3_ex.d.  The host turns the serial, branchy
half of Layer III into dense per-frame tensors; all DSP past the Huffman
stage runs in ops/mp3_dsp.py on device.

Host responsibilities (with reference anchors):
* header validation/frame sizing (hdr_valid minimp3.d:228, hdr_frame_bytes
  minimp3.d:270), sync search with 10-frame match (mp3d_find_frame
  minimp3.d:1450)
* ID3v1/v2/APE skip (minimp3_ex.d:93-142), Xing/Info VBR tag with LAME
  delay/padding (mp3dec_check_vbrtag minimp3_ex.d:144-190)
* full-stream frame index for sample-accurate seek (mp3dec_load_index
  minimp3_ex.d:566-621), binary search + 2-frame predecode + 511-byte
  bit-reservoir preroll (mp3dec_ex_seek minimp3_ex.d:662-785)
* side info (L3_read_side_info minimp3.d:487), bit-reservoir splicing
  (L3_restore/save_reservoir minimp3.d:1170-1194; frames whose reservoir
  can't be restored output silence but are consumed, minimp3.d:1546-1558)
* scalefactors MPEG-1 (scfsi sharing) and MPEG-2 (partition machinery,
  intensity variant) (L3_decode_scalefactors minimp3.d:648-720)
* Huffman big-values/count1 decode with linbits escapes → quantized ints +
  per-coefficient gain (L3_huffman minimp3.d:748-883); gains fold
  global_gain/scalefac_scale/preflag/subblock_gain and the mid/side −0.5
  exponent exactly as the reference folds them into `scf`
* stereo preparation: mid/side or intensity per-band gains; intensity band
  activation (all-zero right channel detection, L3_intensity_stereo
  minimp3.d:963-1000) is computed from the Huffman output

Float output matches minimp3's float build (PCM scaled by 1/32768 inside the
synthesis FIR).  Layers I/II decode through the same synthesis filterbank
with the subband bit-allocation/scalefactor stage of minimp3.d:286-486
(grouped 3/5/9-level quantizers, joint-stereo bound, per-part scalefactors).
"""

from __future__ import annotations

import numpy as np

from ..config import AudioFileFormat
from ..errors import AudioFormatError
from ..host import native
from ..io.source import ByteSource
from ..ops import mp3_dsp
from ..utils.tables import mp3_tables as T

_NATIVE_CACHE = []


def _native_lib():
    if not _NATIVE_CACHE:
        _NATIVE_CACHE.append(native.get_lib())
    return _NATIVE_CACHE[0]

HDR_SIZE = 4
MAX_BITRESERVOIR_BYTES = 511
MAX_FREE_FORMAT_FRAME_SIZE = 2304
SHORT_BLOCK_TYPE = 2
STOP_BLOCK_TYPE = 3
MAX_FRAME_SYNC_MATCHES = 10
MAX_FREE_FORMAT_FRAME_SIZE = 2304
PREDECODE_FRAMES = 2

_HZ = [44100, 48000, 32000]
_HALFRATE = [
    # MPEG2/2.5: layers 1, 2, 3 (index = layer field 3..1 → 3-layer)
    [[0, 4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 72, 80],
     [0, 4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 72, 80],
     [0, 16, 24, 28, 32, 40, 48, 56, 64, 72, 80, 88, 96, 112, 128]],
    # MPEG1
    [[0, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160],
     [0, 16, 24, 28, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192],
     [0, 16, 32, 48, 64, 80, 96, 112, 128, 144, 160, 176, 192, 208, 224]],
]


# ---------------------------------------------------------------------------
# Header helpers (minimp3.d:65-283)
# ---------------------------------------------------------------------------

def _hdr_valid(h) -> bool:
    return (
        h[0] == 0xFF
        and ((h[1] & 0xF0) == 0xF0 or (h[1] & 0xFE) == 0xE2)
        and ((h[1] >> 1) & 3) != 0
        and (h[2] >> 4) != 15
        and ((h[2] >> 2) & 3) != 3
    )


def _hdr_compare(h1, h2) -> bool:
    return (
        _hdr_valid(h2)
        and ((h1[1] ^ h2[1]) & 0xFE) == 0
        and ((h1[2] ^ h2[2]) & 0x0C) == 0
        and (((h1[2] & 0xF0) == 0) == ((h2[2] & 0xF0) == 0))
    )


def _is_mpeg1(h) -> bool:
    return bool(h[1] & 0x8)


def _layer(h) -> int:
    return 4 - ((h[1] >> 1) & 3)  # 1, 2 or 3


def _hdr_sample_rate(h) -> int:
    hz = _HZ[(h[2] >> 2) & 3]
    if not (h[1] & 0x8):
        hz >>= 1
    if not (h[1] & 0x10):
        hz >>= 1
    return hz


def _hdr_bitrate_kbps(h) -> int:
    return 2 * _HALFRATE[1 if h[1] & 0x8 else 0][((h[1] >> 1) & 3) - 1][h[2] >> 4]


def _hdr_frame_samples(h) -> int:
    if (h[1] & 6) == 6:  # layer 1
        return 384
    return 1152 >> (1 if (h[1] & 14) == 2 else 0)


def _hdr_frame_bytes(h, free_format_size: int) -> int:
    fb = _hdr_frame_samples(h) * _hdr_bitrate_kbps(h) * 125 // _hdr_sample_rate(h)
    if (h[1] & 6) == 6:
        fb &= ~3
    return fb if fb else free_format_size


def _hdr_padding(h) -> int:
    if h[2] & 0x2:
        return 4 if (h[1] & 6) == 6 else 1
    return 0


def _is_mono(h) -> bool:
    return (h[3] & 0xC0) == 0xC0


def _is_ms_stereo(h) -> bool:
    return (h[3] & 0xE0) == 0x60


def _test_i_stereo(h) -> bool:
    return bool(h[3] & 0x10)


def _test_ms_stereo(h) -> bool:
    return bool(h[3] & 0x20)


def _my_sample_rate_idx(h) -> int:
    return ((h[2] >> 2) & 3) + (((h[1] >> 3) & 1) + ((h[1] >> 4) & 1)) * 3


# ---------------------------------------------------------------------------
# Bit reader with minimp3 get_bits semantics (returns 0 past limit)
# ---------------------------------------------------------------------------

class _Bits:
    __slots__ = ("buf", "pos", "limit")

    def __init__(self, buf, limit_bits=None):
        self.buf = buf
        self.pos = 0
        self.limit = len(buf) * 8 if limit_bits is None else limit_bits

    def get(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        if self.pos > self.limit:
            return 0
        first = p >> 3
        last = (p + n - 1) >> 3
        word = int.from_bytes(self.buf[first : last + 1], "big")
        return (word >> ((last + 1) * 8 - p - n)) & ((1 << n) - 1)


# ---------------------------------------------------------------------------
# Huffman LUTs built from the canonical spec tables
# ---------------------------------------------------------------------------

_L1_BITS = 10


def _build_lut(codes):
    """codes: [(code, len, *payload)] → (lut1, sub) where lut1 maps a 10-bit
    peek to (len, payload) for short codes or (-subidx-1,) for long ones."""
    lut1 = [None] * (1 << _L1_BITS)
    long_groups = {}
    for code, ln, *payload in codes:
        if ln <= _L1_BITS:
            base = code << (_L1_BITS - ln)
            for i in range(1 << (_L1_BITS - ln)):
                lut1[base + i] = (ln, payload)
        else:
            prefix = code >> (ln - _L1_BITS)
            long_groups.setdefault(prefix, []).append((code, ln, payload))
    subs = []
    for prefix, group in long_groups.items():
        maxlen = max(ln for _, ln, _ in group)
        ext = maxlen - _L1_BITS
        sub = [None] * (1 << ext)
        for code, ln, payload in group:
            rest = code & ((1 << (ln - _L1_BITS)) - 1)
            base = rest << (maxlen - ln)
            for i in range(1 << (maxlen - ln)):
                sub[base + i] = (ln, payload)
        subs.append((ext, sub))
        lut1[prefix] = (-len(subs), None)
    return lut1, subs


_BIG_LUTS = [_build_lut(t) if t else None for t in T.HUFF_TABLES]
_C1_LUTS = [_build_lut(T.COUNT1_A), _build_lut(T.COUNT1_B)]


class _HuffReader:
    """Bit reader over main data with 32-bit-peek Huffman decode."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos_bits):
        # pad so 32-bit peeks never run off the end
        self.buf = bytes(buf) + b"\0\0\0\0\0\0\0\0"
        self.pos = pos_bits

    def peek32(self) -> int:
        p = self.pos
        byte = p >> 3
        word = int.from_bytes(self.buf[byte : byte + 8], "big")
        return (word >> (32 - (p & 7))) & 0xFFFFFFFF

    def get(self, n: int) -> int:
        v = self.peek32() >> (32 - n) if n else 0
        self.pos += n
        return v

    def decode(self, lut) -> tuple:
        lut1, subs = lut
        peek = self.peek32()
        e = lut1[peek >> (32 - _L1_BITS)]
        if e is None:
            raise AudioFormatError("Invalid MP3 Huffman code")
        if e[0] < 0:
            ext, sub = subs[-e[0] - 1]
            e = sub[(peek >> (32 - _L1_BITS - ext)) & ((1 << ext) - 1)]
            if e is None:
                raise AudioFormatError("Invalid MP3 Huffman code")
        self.pos += e[0]
        return e[1]


# ---------------------------------------------------------------------------
# Side info
# ---------------------------------------------------------------------------

class _GrInfo:
    __slots__ = (
        "sfbtab", "part_23_length", "big_values", "scalefac_compress",
        "global_gain", "block_type", "mixed_block_flag", "n_long_sfb",
        "n_short_sfb", "table_select", "region_count", "subblock_gain",
        "preflag", "scalefac_scale", "count1_table", "scfsi",
    )


def _read_side_info(bs: _Bits, hdr) -> tuple:
    """Returns (main_data_begin, [gr_info...]) or raises."""
    sr_idx = _my_sample_rate_idx(hdr)
    sr_idx -= sr_idx != 0
    mono = _is_mono(hdr)
    gr_count = 1 if mono else 2
    scfsi = 0
    if _is_mpeg1(hdr):
        gr_count *= 2
        main_data_begin = bs.get(9)
        scfsi = bs.get(7 + gr_count)
    else:
        main_data_begin = bs.get(8 + gr_count) >> gr_count

    part_23_sum = 0
    grs = []
    for _ in range(gr_count):
        if mono:
            scfsi <<= 4
        gr = _GrInfo()
        gr.part_23_length = bs.get(12)
        part_23_sum += gr.part_23_length
        gr.big_values = bs.get(9)
        if gr.big_values > 288:
            raise AudioFormatError("MP3: big_values out of range")
        gr.global_gain = bs.get(8)
        gr.scalefac_compress = bs.get(4 if _is_mpeg1(hdr) else 9)
        row = T.SCF_LONG[sr_idx * 23 : (sr_idx + 1) * 23]
        gr.sfbtab = row
        gr.n_long_sfb = 22
        gr.n_short_sfb = 0
        gr.region_count = [0, 0, 0]
        gr.subblock_gain = [0, 0, 0]
        gr.mixed_block_flag = 0
        if bs.get(1):  # window switching
            gr.block_type = bs.get(2)
            if gr.block_type == 0:
                raise AudioFormatError("MP3: invalid block type")
            gr.mixed_block_flag = bs.get(1)
            gr.region_count[0] = 7
            gr.region_count[1] = 255
            if gr.block_type == SHORT_BLOCK_TYPE:
                scfsi &= 0x0F0F
                if not gr.mixed_block_flag:
                    gr.region_count[0] = 8
                    gr.sfbtab = T.SCF_SHORT[sr_idx * 40 : (sr_idx + 1) * 40]
                    gr.n_long_sfb = 0
                    gr.n_short_sfb = 39
                else:
                    gr.sfbtab = T.SCF_MIXED[sr_idx * 40 : (sr_idx + 1) * 40]
                    gr.n_long_sfb = 8 if _is_mpeg1(hdr) else 6
                    gr.n_short_sfb = 30
            tables = bs.get(10) << 5
            gr.subblock_gain = [bs.get(3), bs.get(3), bs.get(3)]
        else:
            gr.block_type = 0
            tables = bs.get(15)
            gr.region_count[0] = bs.get(4)
            gr.region_count[1] = bs.get(3)
            gr.region_count[2] = 255
        gr.table_select = [tables >> 10, (tables >> 5) & 31, tables & 31]
        gr.preflag = bs.get(1) if _is_mpeg1(hdr) else (gr.scalefac_compress >= 500)
        gr.scalefac_scale = bs.get(1)
        gr.count1_table = bs.get(1)
        gr.scfsi = (scfsi >> 12) & 15
        scfsi <<= 4
        grs.append(gr)

    if part_23_sum + bs.pos > bs.limit + main_data_begin * 8:
        raise AudioFormatError("MP3: side info inconsistent")
    return main_data_begin, grs


# ---------------------------------------------------------------------------
# Scalefactors (L3_decode_scalefactors, minimp3.d:648-720)
# ---------------------------------------------------------------------------

def _read_scalefactors(iscf, ist_pos, scf_size, scf_count, br: _HuffReader,
                       scfsi: int) -> None:
    n = 0
    for i in range(4):
        cnt = scf_count[i]
        if cnt == 0:
            break
        if scfsi & 8:
            iscf[n : n + cnt] = ist_pos[n : n + cnt]
        else:
            bits = scf_size[i]
            if bits == 0:
                iscf[n : n + cnt] = 0
                ist_pos[n : n + cnt] = 0
            else:
                max_scf = (1 << bits) - 1 if scfsi < 0 else -1
                for k in range(cnt):
                    s = br.get(bits)
                    ist_pos[n + k] = 255 if s == max_scf else s
                    iscf[n + k] = s
        n += cnt
        scfsi *= 2
    iscf[n : n + 3] = 0


def _decode_scalefactors(hdr, ist_pos, br: _HuffReader, gr: _GrInfo,
                         ch: int) -> np.ndarray:
    """Returns per-sfb gains scf[40] float32."""
    part_idx = (1 if gr.n_short_sfb else 0) + (1 if not gr.n_long_sfb else 0)
    scf_partition = T.SCF_PARTITIONS[part_idx * 28 : (part_idx + 1) * 28]
    scf_size = [0, 0, 0, 0]
    iscf = np.zeros(40 + 3, dtype=np.int32)
    scf_shift = gr.scalefac_scale + 1
    scfsi = gr.scfsi
    k = 0
    if _is_mpeg1(hdr):
        part = T.SCFC_DECODE[gr.scalefac_compress]
        scf_size[0] = scf_size[1] = part >> 2
        scf_size[2] = scf_size[3] = part & 3
    else:
        ist = 1 if (_test_i_stereo(hdr) and ch) else 0
        sfc = gr.scalefac_compress >> ist
        k = ist * 3 * 4
        while sfc >= 0:
            modprod = 1
            for i in range(3, -1, -1):
                scf_size[i] = (sfc // modprod) % T.SCF_MOD[k + i]
                modprod *= T.SCF_MOD[k + i]
            sfc -= modprod
            k += 4
        scfsi = -16
    _read_scalefactors(iscf, ist_pos, scf_size, scf_partition[k:], br, scfsi)

    if gr.n_short_sfb:
        sh = 3 - scf_shift
        for i in range(0, gr.n_short_sfb, 3):
            iscf[gr.n_long_sfb + i + 0] += gr.subblock_gain[0] << sh
            iscf[gr.n_long_sfb + i + 1] += gr.subblock_gain[1] << sh
            iscf[gr.n_long_sfb + i + 2] += gr.subblock_gain[2] << sh
    elif gr.preflag:
        for i in range(10):
            iscf[11 + i] += T.PREAMP[i]

    gain_exp = gr.global_gain - 4 - 210 - (2 if _is_ms_stereo(hdr) else 0)
    nb = gr.n_long_sfb + gr.n_short_sfb
    exps = gain_exp - (iscf[:nb].astype(np.int64) << scf_shift)
    scf = np.zeros(40, dtype=np.float32)
    scf[:nb] = np.exp2(exps.astype(np.float64) / 4.0).astype(np.float32)
    return scf


# ---------------------------------------------------------------------------
# Huffman decode → quantized values + per-coefficient gains
# ---------------------------------------------------------------------------

def _huffman(br: _HuffReader, gr: _GrInfo, scf: np.ndarray, limit_bits: int):
    """Returns (q[576] int32, gains[576] f32) in huffman (pre-reorder)
    order."""
    q = np.zeros(580, dtype=np.int32)
    gains = np.zeros(580, dtype=np.float32)
    sfb = list(gr.sfbtab) + [0, 0, 0]
    pos = 0
    sfb_i = 0
    scf_i = 0
    one = np.float32(0.0)
    big = gr.big_values

    for region in range(3):
        if big <= 0:
            break
        tab_num = gr.table_select[region]
        lut = _BIG_LUTS[tab_num]
        linbits = T.LINBITS[tab_num]
        sfb_cnt = gr.region_count[region]
        while True:
            np_pairs = sfb[sfb_i] // 2
            sfb_i += 1
            pairs = min(big, np_pairs)
            one = scf[scf_i]
            scf_i += 1
            for _ in range(pairs):
                if lut is None:
                    q[pos] = q[pos + 1] = 0
                    gains[pos] = gains[pos + 1] = one
                    pos += 2
                    continue
                x, y = br.decode(lut)
                for v in (x, y):
                    if v == 15 and linbits:
                        v += br.get(linbits)
                    if v:
                        if br.get(1):
                            v = -v
                    q[pos] = v
                    gains[pos] = one
                    pos += 1
            big -= np_pairs
            sfb_cnt -= 1
            if big <= 0 or sfb_cnt < 0:
                break

    # count1 region (quadruples)
    lut = _C1_LUTS[gr.count1_table]
    npairs = 1 - big
    while pos <= 572:
        (v,) = br.decode(lut)
        if br.pos > limit_bits:
            break
        vals = [(v >> 3) & 1, (v >> 2) & 1, (v >> 1) & 1, v & 1]
        stop = False
        for s in range(4):
            if s % 2 == 0:
                npairs -= 1
                if npairs == 0:
                    np_pairs = sfb[sfb_i] // 2
                    sfb_i += 1
                    if np_pairs == 0:
                        stop = True
                        break
                    npairs = np_pairs
                    one = scf[scf_i]
                    scf_i += 1
            if vals[s]:
                sign = br.get(1)
                q[pos + s] = -1 if sign else 1
                gains[pos + s] = one
            else:
                q[pos + s] = 0
                gains[pos + s] = one
        if stop:
            break
        pos += 4

    br.pos = limit_bits
    return q[:576], gains[:576]


# ---------------------------------------------------------------------------
# Stereo & reorder preparation (host side of ops/mp3_dsp.py)
# ---------------------------------------------------------------------------

_IDENT_PERM = np.arange(576, dtype=np.int32)


def _reorder_perm_full(gr: _GrInfo, n_long_bands: int) -> np.ndarray:
    """Permutation implementing L3_reorder (minimp3.d:984-1000):
    new[i] = old[perm[i]]."""
    if not gr.n_short_sfb:
        return _IDENT_PERM
    perm = _IDENT_PERM.copy()
    src = n_long_bands * 18
    dst = src
    sfb = list(gr.sfbtab) + [0, 0, 0]
    i = gr.n_long_sfb
    while sfb[i]:
        length = sfb[i]
        for j in range(length):
            if dst + 3 > 576 or src + 2 * length + j >= 576:
                return perm
            perm[dst] = src + j
            perm[dst + 1] = src + length + j
            perm[dst + 2] = src + 2 * length + j
            dst += 3
        src += 3 * length
        i += 3
    return perm


def _pan_gains(ipos: int, mpeg1: bool, mpeg2_sh: int):
    """Intensity position → (kl, kr) (minimp3.d:930-952)."""
    if mpeg1:
        pan = [0.0, 1.0, 0.21132487, 0.78867513, 0.36602540, 0.63397460,
               0.5, 0.5, 0.63397460, 0.36602540, 0.78867513, 0.21132487,
               1.0, 0.0]
        return pan[2 * ipos], pan[2 * ipos + 1]
    kr = float(2.0 ** (-(((ipos + 1) >> 1) << mpeg2_sh) / 4.0))
    if ipos & 1:
        return kr, 1.0
    return 1.0, kr


def _stereo_mix(hdr, grs, gch, q_right, ist_pos_right, gr_pair):
    """Compute the per-coefficient (a, b, c, d) stereo mix vectors."""
    a = np.ones(576, dtype=np.float32)
    b = np.zeros(576, dtype=np.float32)
    c = np.zeros(576, dtype=np.float32)
    d = np.ones(576, dtype=np.float32)
    gr = gch
    if _test_i_stereo(hdr):
        # intensity stereo (minimp3.d:963-1000)
        sfb = list(gr.sfbtab) + [0]
        n_sfb = gr.n_long_sfb + gr.n_short_sfb
        max_blocks = 3 if gr.n_short_sfb else 1
        max_band = [-1, -1, -1]
        p = 0
        for i in range(n_sfb):
            w = sfb[i]
            if np.any(q_right[p : p + w]):
                max_band[i % 3] = i
            p += w
        if gr.n_long_sfb:
            m = max(max_band)
            max_band = [m, m, m]
        ist_pos = ist_pos_right.copy()
        default_pos = 3 if _is_mpeg1(hdr) else 0
        for i in range(max_blocks):
            itop = n_sfb - max_blocks + i
            prev = itop - max_blocks
            ist_pos[itop] = default_pos if max_band[i] >= prev else ist_pos[prev]
        max_pos = 7 if _is_mpeg1(hdr) else 64
        mpeg2_sh = gr_pair.scalefac_compress & 1
        s = np.float32(1.41421356) if _test_ms_stereo(hdr) else np.float32(1.0)
        p = 0
        i = 0
        while sfb[i]:
            w = sfb[i]
            ipos = int(ist_pos[i])
            if i > max_band[i % 3] and ipos < max_pos:
                kl, kr = _pan_gains(ipos, _is_mpeg1(hdr), mpeg2_sh)
                # l' = l*kl*s ; r' = l*kr*s
                a[p : p + w] = np.float32(kl) * s
                b[p : p + w] = 0.0
                c[p : p + w] = np.float32(kr) * s
                d[p : p + w] = 0.0
            elif _test_ms_stereo(hdr):
                a[p : p + w] = 1.0
                b[p : p + w] = 1.0
                c[p : p + w] = 1.0
                d[p : p + w] = -1.0
            p += w
            i += 1
    elif _is_ms_stereo(hdr):
        a[:] = 1.0
        b[:] = 1.0
        c[:] = 1.0
        d[:] = -1.0
    return np.stack([a, b, c, d])


def _n_long_bands(hdr, gr) -> int:
    return (2 if gr.mixed_block_flag else 0) << (
        1 if _my_sample_rate_idx(hdr) == 2 else 0
    )


# ---------------------------------------------------------------------------
# VBR tag / ID3 (minimp3_ex.d)
# ---------------------------------------------------------------------------

def _skip_id3v2(buf) -> int:
    if (
        len(buf) >= 10
        and bytes(buf[:3]) == b"ID3"
        and not (buf[5] & 15 or buf[6] & 0x80 or buf[7] & 0x80 or buf[8] & 0x80
                 or buf[9] & 0x80)
    ):
        size = (((buf[6] & 0x7F) << 21) | ((buf[7] & 0x7F) << 14)
                | ((buf[8] & 0x7F) << 7) | (buf[9] & 0x7F)) + 10
        if buf[5] & 16:
            size += 10
        return min(size, len(buf))
    return 0


def _strip_tail_tags(buf) -> int:
    """Returns usable size after ID3v1/APE strip (minimp3_ex.d:93-112)."""
    size = len(buf)
    if size >= 128 and bytes(buf[size - 128 : size - 125]) == b"TAG":
        size -= 128
        if size >= 227 and bytes(buf[size - 227 : size - 223]) == b"TAG+":
            size -= 227
    if size > 32 and bytes(buf[size - 32 : size - 24]) == b"APETAGEX":
        size -= 32
        tag_size = int.from_bytes(buf[size + 8 + 4 : size + 8 + 8], "little")
        if size >= tag_size:
            size -= tag_size
    return size


def _check_vbr_tag(view, off: int, frame_size: int):
    """Returns (found, frames, delay, padding): minimp3_ex.d:144-190."""
    hdr = view[off : off + 4]
    bs = _Bits(view[off + 4 : off + frame_size])
    if not (hdr[1] & 1):  # CRC present
        bs.get(16)
    try:
        _read_side_info(bs, hdr)
    except AudioFormatError:
        return 0, 0, 0, 0
    p = off + 4 + bs.pos // 8
    tag = bytes(view[p : p + 4])
    if tag not in (b"Xing", b"Info"):
        return 0, 0, 0, 0
    flags = view[p + 7]
    if not (flags & 1):
        return -1, 0, 0, 0
    t = p + 8
    frames = int.from_bytes(view[t : t + 4], "big")
    t += 4
    if flags & 2:
        t += 4
    if flags & 4:
        t += 100
    if flags & 8:
        t += 4
    delay = padding = 0
    if t < len(view) and view[t]:
        t += 21
        if t - off + 14 < frame_size:
            delay = ((view[t] << 4) | (view[t + 1] >> 4)) + 528 + 1
            padding = (((view[t + 1] & 0xF) << 8) | view[t + 2]) - (528 + 1)
    return 1, frames, delay, padding


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def probe(src: ByteSource):
    try:
        dec = Mp3Decoder(src)
    except AudioFormatError:
        return None
    return dec


class Mp3Decoder:
    format = AudioFileFormat.mp3

    def __init__(self, src: ByteSource):
        self._src = src
        view = src.view()
        start = _skip_id3v2(view)
        size = _strip_tail_tags(view)
        self._view = view[start:size]
        self._free_format_bytes = 0
        self._index_and_detect()
        self._reset_decoder_state()
        self._offset = self._start_offset
        self._cur_sample = 0  # interleaved sample position incl. channels
        self._to_skip = self._start_delay
        self._buf = np.zeros((0, self.channels), dtype=np.float32)
        self._buf_start = 0

    # -- open-time scan ------------------------------------------------------
    def _index_and_detect(self) -> None:
        view = self._view
        # find the first run of consistent frames (mp3d_find_frame)
        pos = self._find_first_frame(0)
        if pos < 0:
            raise AudioFormatError("Not an MP3 stream")
        h = view[pos : pos + 4]
        self._layer = _layer(h)
        self.channels = 1 if _is_mono(h) else 2
        self.sample_rate = _hdr_sample_rate(h)
        self._mpeg1 = _is_mpeg1(h)
        self._hdr0 = bytes(h)
        self._spf = _hdr_frame_samples(h)

        self._start_delay = 0
        self._detected_samples = 0
        frame_size = _hdr_frame_bytes(h, self._free_format_bytes) + _hdr_padding(h)
        ret, frames, delay, padding = (
            _check_vbr_tag(view, pos, frame_size)
            if self._layer == 3 else (0, 0, 0, 0)
        )
        start = pos
        if ret:
            start = pos + frame_size  # skip the tag frame
        if ret > 0:
            self._start_delay = delay * self.channels
            samples = self._spf * self.channels * frames
            samples = max(0, samples - self._start_delay)
            pad = padding * self.channels
            if pad > 0:
                samples = max(0, samples - pad)
            self._detected_samples = samples

        self._start_offset = start
        # full frame index (offsets + cumulative output samples)
        offsets = []
        samples_acc = []
        total = 0
        reserv = 0
        had_success = False
        p = start
        n = len(view)
        # native fast path: the C walk (af_host.cc:af_mp3_index) indexes
        # matching-header runs with the same side-info reservoir
        # simulation; python takes over only at resync points (below)
        import os as _os

        from ..host import native as _native

        _lib = _native.get_lib()
        if _lib is not None and not _os.environ.get("AF_TPU_NO_NATIVE_INDEX"):
            state = np.array([0, 0, 0, start], np.int64)
            buf_o = np.empty(65536, np.int64)
            buf_s = np.empty(65536, np.int64)
            while True:
                cnt = _native.mp3_index(
                    _lib, view, self._hdr0, self._free_format_bytes,
                    self._layer, self._spf * self.channels,
                    state, buf_o, buf_s)
                offsets.extend(buf_o[:cnt].tolist())
                samples_acc.extend(buf_s[:cnt].tolist())
                if cnt < buf_o.shape[0]:
                    break
            total, reserv, hs, p = (int(x) for x in state)
            had_success = bool(hs)
        while p + HDR_SIZE <= n:
            h = view[p : p + 4]
            if not _hdr_compare(self._hdr0, h):
                q = self._find_first_frame(p)
                if q < 0:
                    break
                p = q
                h = view[p : p + 4]
                if not _hdr_compare(self._hdr0, h):
                    break
            fb = _hdr_frame_bytes(h, self._free_format_bytes) + _hdr_padding(h)
            if fb <= 0 or p + fb > n:
                break
            offsets.append(p)
            samples_acc.append(total)
            # decodability via reservoir simulation (side-info only; Layer
            # I/II frames are always independently decodable)
            if self._layer == 3:
                ok, consumed, avail = self._frame_reservoir_step(p, fb, reserv)
            else:
                ok, avail = True, 0
            if ok or had_success:
                total += self._spf * self.channels
                had_success = True
            reserv = min(avail, MAX_BITRESERVOIR_BYTES)
            p += fb
        if not offsets:
            raise AudioFormatError("MP3: no frames found")
        self._index_offsets = np.array(offsets, dtype=np.int64)
        self._index_samples = np.array(samples_acc, dtype=np.int64)
        if not self._detected_samples:
            self._total_samples = total
        else:
            self._total_samples = self._detected_samples
        self.length_frames = self._total_samples // self.channels

    def _find_first_frame(self, start: int) -> int:
        view = self._view
        n = len(view)
        for i in range(start, n - HDR_SIZE):
            h = view[i : i + 4]
            if not _hdr_valid(h):
                continue
            fb = _hdr_frame_bytes(h, self._free_format_bytes)
            if not fb:
                # free format: deduce the constant frame size from the
                # distance to the next two matching headers
                # (mp3d_find_frame, minimp3.d:1458-1471)
                for k in range(HDR_SIZE, MAX_FREE_FORMAT_FRAME_SIZE):
                    if i + 2 * k >= n - HDR_SIZE:
                        break
                    if _hdr_compare(h, view[i + k : i + k + 4]):
                        cand = k - _hdr_padding(h)
                        nextfb = cand + _hdr_padding(view[i + k : i + k + 4])
                        if (i + k + nextfb + HDR_SIZE <= n and
                                _hdr_compare(h, view[i + k + nextfb :
                                                     i + k + nextfb + 4])):
                            fb = cand
                            self._free_format_bytes = cand
                            break
            if not fb:
                continue
            # require a run of matching frames (mp3d_match_frame)
            k = i
            match = 0
            ok = True
            while match < MAX_FRAME_SYNC_MATCHES:
                step = _hdr_frame_bytes(view[k : k + 4], fb) + _hdr_padding(
                    view[k : k + 4]
                )
                if k + step + HDR_SIZE > n:
                    break
                if not _hdr_compare(h, view[k + step : k + step + 4]):
                    ok = False
                    break
                k += step
                match += 1
            if ok and match > 0 or (ok and i + fb >= n - HDR_SIZE):
                return i
        return -1

    def _frame_reservoir_step(self, p, fb, reserv):
        """Side-info-only simulation of reservoir restore/save."""
        view = self._view
        h = view[p : p + 4]
        bs = _Bits(view[p + 4 : p + fb])
        if not (h[1] & 1):
            bs.get(16)
        try:
            main_data_begin, grs = _read_side_info(bs, h)
        except AudioFormatError:
            return False, 0, 0
        ok = reserv >= main_data_begin
        frame_main = (bs.limit - bs.pos) // 8
        # bits consumed by granule data
        used_bits = sum(g.part_23_length for g in grs)
        have = min(reserv, main_data_begin)
        total_bits = (have + frame_main) * 8
        consumed = (8 * have + used_bits + 7) // 8 if ok else 0
        avail = max(0, (total_bits // 8) - consumed)
        return ok, consumed, avail

    # -- decoder state -------------------------------------------------------
    def _reset_decoder_state(self) -> None:
        ch = self.channels
        self._reserv = 0
        self._reserv_buf = b""
        self._overlap = np.zeros((1, ch, 32, 18), dtype=np.float32)
        self._shist = np.zeros((1, ch, 16, 32), dtype=np.float32)
        self._ist_pos = np.zeros((2, 40), dtype=np.int32)

    # -- frame decode --------------------------------------------------------
    def _parse_frame_tensors(self, off: int):
        """Host entropy stage for one frame.

        Returns (tensors | None, frame_bytes): ``tensors`` is the dict of
        device inputs, or None when this frame produces no output (reservoir
        underflow / corrupt side info).  frame_bytes == 0 means EOF/stream
        mismatch.  Updates host-side reservoir/scalefactor state."""
        view = self._view
        h = view[off : off + 4]
        if not _hdr_compare(self._hdr0, h):
            return None, 0
        if (1 if _is_mono(h) else 2) != self.channels:
            # mid-stream channel change: the reference stops the
            # read with MP3D_E_DECODE (minimp3_ex.d:411-414) —
            # header compare does not cover the mode bits
            return None, 0
        fb = _hdr_frame_bytes(h, self._free_format_bytes) + _hdr_padding(h)
        if off + fb > len(view):
            return None, 0
        bs = _Bits(view[off + 4 : off + fb])
        if not (h[1] & 1):
            bs.get(16)
        try:
            main_data_begin, grs = _read_side_info(bs, h)
        except AudioFormatError:
            self._reset_decoder_state()
            return None, fb

        # reservoir splice (L3_restore_reservoir)
        frame_main = bytes(view[off + 4 + bs.pos // 8 : off + fb])
        have = min(self._reserv, main_data_begin)
        maindata = (
            self._reserv_buf[len(self._reserv_buf) - have :] + frame_main
            if have
            else frame_main
        )
        success = self._reserv >= main_data_begin

        nch = self.channels
        ngr = 2 if self._mpeg1 else 1
        tensors = None
        br = _HuffReader(maindata, 0)
        if success:
            q = np.zeros((1, ngr, nch, 576), dtype=np.float32)
            scale = np.zeros((1, ngr, nch, 576), dtype=np.float32)
            mix = np.zeros((1, ngr, 4, 576), dtype=np.float32)
            perm = np.zeros((1, ngr, nch, 576), dtype=np.int32)
            aa_bands = np.zeros((1, ngr, nch), dtype=np.int32)
            wtype = np.zeros((1, ngr, nch, 32), dtype=np.int32)
            lib = _native_lib()
            native_done = False
            ist_snaps = None
            if lib is not None:
                gr_params = np.zeros((ngr * nch, 21), np.int32)
                sfbtabs = np.zeros((ngr * nch, 40), np.uint8)
                for i, gr in enumerate(grs):
                    gr_params[i] = (
                        [gr.part_23_length, gr.big_values,
                         gr.scalefac_compress, gr.global_gain,
                         gr.block_type, gr.mixed_block_flag,
                         gr.n_long_sfb, gr.n_short_sfb]
                        + list(gr.table_select) + list(gr.region_count)
                        + list(gr.subblock_gain)
                        + [gr.preflag, gr.scalefac_scale, gr.count1_table,
                           gr.scfsi]
                    )
                    tab = np.asarray(gr.sfbtab, np.uint8)
                    sfbtabs[i, : len(tab)] = tab
                res = native.mp3_granules_scf_huff(
                    lib, bytes(h), maindata, gr_params, sfbtabs,
                    ngr, nch, self._ist_pos,
                )
                if res is not None:
                    qn, gn, ist_snaps = res
                    q[0] = qn
                    scale[0] = gn
                    br.pos = sum(g.part_23_length for g in grs)
                    native_done = True
            if not native_done:
                for g in range(ngr):
                    for ch in range(nch):
                        gr = grs[g * nch + ch]
                        limit = br.pos + gr.part_23_length
                        scf = _decode_scalefactors(
                            h, self._ist_pos[ch], br, gr, ch
                        )
                        qv, gains = _huffman(br, gr, scf, limit)
                        q[0, g, ch] = qv
                        scale[0, g, ch] = gains
            for g in range(ngr):
                if nch == 2:
                    ist_r = (
                        ist_snaps[g] if ist_snaps is not None
                        else self._ist_pos[1]
                    )
                    mix[0, g] = _stereo_mix(
                        h, grs, grs[g * nch], q[0, g, 1], ist_r,
                        grs[g * nch + 1],
                    )
                else:
                    mix[0, g, 0] = 1.0
                    mix[0, g, 3] = 1.0
                for ch in range(nch):
                    gr = grs[g * nch + ch]
                    nlb = _n_long_bands(h, gr)
                    if gr.n_short_sfb:
                        aa_bands[0, g, ch] = nlb - 1
                        perm[0, g, ch] = _reorder_perm_full(gr, nlb)
                        wt = np.full(32, mp3_dsp.WIN_SHORT, dtype=np.int32)
                        wt[:nlb] = mp3_dsp.WIN_NORMAL
                        wtype[0, g, ch] = wt
                    else:
                        aa_bands[0, g, ch] = 31
                        perm[0, g, ch] = _IDENT_PERM
                        if gr.block_type == STOP_BLOCK_TYPE:
                            wtype[0, g, ch] = mp3_dsp.WIN_STOP
                        elif gr.block_type == 1:
                            wtype[0, g, ch] = mp3_dsp.WIN_START
                        else:
                            wtype[0, g, ch] = mp3_dsp.WIN_NORMAL

            tensors = {
                "q": q, "scale": scale, "mix": mix, "perm": perm,
                "aa_bands": aa_bands, "wtype": wtype,
            }

        # save reservoir (L3_save_reservoir)
        pos_bytes = (
            (br.pos + 7) // 8 if success else 0
        )
        remains = len(maindata) - pos_bytes
        if remains > MAX_BITRESERVOIR_BYTES:
            pos_bytes += remains - MAX_BITRESERVOIR_BYTES
            remains = MAX_BITRESERVOIR_BYTES
        self._reserv_buf = maindata[pos_bytes : pos_bytes + max(0, remains)]
        self._reserv = max(0, remains)
        return tensors, fb

    # frames per device call on the single-stream facade: per-frame
    # dispatch pays one host<->device round-trip per 26 ms of audio
    _FACADE_WINDOW = 64

    def _decode_l3_window(self):
        """Decode up to _FACADE_WINDOW L3 frames with one device call;
        same (pcm | None, consumed_bytes) contract as _decode_frame_at.
        Excess samples are buffered by read()'s normal buffering."""
        view = self._view
        nch = self.channels
        ngr = 2 if self._mpeg1 else 1
        parts = []
        fb_total = 0
        while len(parts) < self._FACADE_WINDOW:
            off = self._offset + fb_total
            if off >= len(view) - HDR_SIZE:
                break
            tensors, fb = self._parse_frame_tensors(off)
            if fb == 0:
                break
            fb_total += fb
            if tensors is not None:
                parts.append(tensors)
        if fb_total == 0:
            return None, 0
        if not parts:
            return np.zeros((0, nch), np.float32), fb_total
        # EOF tail: pad with silent granules to the static window width so
        # the whole stream costs ceil(frames/W) device calls; the pad
        # output (and post-EOF state) is sliced away / irrelevant
        n_real = len(parts)
        if n_real < self._FACADE_WINDOW:
            pad = self._pad_part(nch, ngr)
            parts = parts + [pad] * (self._FACADE_WINDOW - n_real)
        cat = {k: np.concatenate([p[k] for p in parts], axis=1)
               for k in parts[0]}
        out, self._overlap, self._shist = mp3_dsp.mp3_frame_dsp(
            cat["q"], cat["scale"], cat["mix"], cat["perm"],
            cat["aa_bands"], cat["wtype"], self._overlap, self._shist,
            nch=nch, ngr=self._FACADE_WINDOW * ngr)
        out = np.asarray(out)
        pcm = out[0].transpose(0, 2, 1).reshape(-1, nch)
        return pcm[: n_real * ngr * 576], fb_total

    def _pad_part(self, nch, ngr):
        if getattr(self, "_pad_tensors", None) is None:
            mix = np.zeros((1, ngr, 4, 576), np.float32)
            mix[:, :, 0] = 1.0
            mix[:, :, 3] = 1.0
            perm = np.zeros((1, ngr, nch, 576), np.int32)
            perm[:] = _IDENT_PERM
            self._pad_tensors = {
                "q": np.zeros((1, ngr, nch, 576), np.float32),
                "scale": np.zeros((1, ngr, nch, 576), np.float32),
                "mix": mix,
                "perm": perm,
                "aa_bands": np.full((1, ngr, nch), 31, np.int32),
                "wtype": np.full((1, ngr, nch, 32), mp3_dsp.WIN_NORMAL,
                                 np.int32),
            }
        return self._pad_tensors

    def _decode_frame_at(self, off: int):
        """Decode one frame; returns (pcm [n, ch] f32 | None at EOF,
        frame_bytes)."""
        if self._layer != 3:
            return self._decode_l12_frame_at(off)
        tensors, fb = self._parse_frame_tensors(off)
        if fb == 0:
            return None, 0
        nch = self.channels
        if tensors is None:
            return np.zeros((0, nch), np.float32), fb
        ngr = 2 if self._mpeg1 else 1
        out, self._overlap, self._shist = mp3_dsp.mp3_frame_dsp(
            tensors["q"], tensors["scale"], tensors["mix"], tensors["perm"],
            tensors["aa_bands"], tensors["wtype"],
            self._overlap, self._shist, nch=nch, ngr=ngr,
        )
        out = np.asarray(out)  # [1, ngr, nch, 576]
        pcm = out[0].transpose(0, 2, 1).reshape(ngr * 576, nch)
        return pcm, fb


    # -- Layer I/II decode (minimp3.d:286-486) --------------------------------
    def _decode_l12_frame_at(self, off: int):
        S2, fb = self._l12_parse_subbands(off)
        if S2 is None:
            if fb:
                return np.zeros((0, self.channels), np.float32), fb
            return None, 0
        nch = self.channels
        pcm, self._shist = mp3_dsp.mp3_synth_slots(
            S2[None], self._shist, nch=nch
        )
        pcm = np.asarray(pcm)[0]  # [nch, slots*32]
        return pcm.T.astype(np.float32), fb

    def _l12_parse_subbands(self, off: int):
        """Host entropy stage for one Layer I/II frame: bit allocation +
        scale info + subband sample decode + scalefactor application
        (minimp3.d:286-486) WITHOUT the synthesis filterbank — the batch
        scheduler stacks these blocks and synthesizes a whole window with
        one device call.  Returns (S [nch, slots, 32] | None, frame_bytes);
        (None, fb>0) marks a corrupt frame (facade emits no output and the
        slot history does not advance)."""
        view = self._view
        h = view[off : off + 4]
        if not _hdr_compare(self._hdr0, h):
            return None, 0
        if (1 if _is_mono(h) else 2) != self.channels:
            # mid-stream channel change: the reference stops the
            # read with MP3D_E_DECODE (minimp3_ex.d:411-414) —
            # header compare does not cover the mode bits
            return None, 0
        fb = _hdr_frame_bytes(h, self._free_format_bytes) + _hdr_padding(h)
        if off + fb > len(view):
            return None, 0
        bs = _Bits(view[off + 4 : off + fb])
        if not (h[1] & 1):
            bs.get(16)
        try:
            sci = _l12_read_scale_info(h, bs)
        except AudioFormatError:
            return None, fb
        layer = _layer(h)
        group_size = 1 if layer == 1 else 3
        n_granules = 3
        nch = self.channels
        slots_total = 12 if layer == 1 else 36
        S = np.zeros((1, nch, slots_total, 32), np.float32)
        slot = 0
        for igr in range(n_granules):
            grbuf = np.zeros((2, 32, 18), np.float32)
            # 4 groups of group_size slots
            for j in range(4):
                for i in range(2 * sci["total_bands"]):
                    ba = sci["bitalloc"][i]
                    ch, band = i & 1, i >> 1
                    base_slot = group_size * j
                    if ba != 0:
                        if ba < 17:
                            half = (1 << (ba - 1)) - 1
                            for k in range(group_size):
                                grbuf[ch, band, base_slot + k] = float(
                                    bs.get(ba) - half
                                )
                        else:
                            mod = (2 << (ba - 17)) + 1  # 3, 5, 9
                            code = bs.get(mod + 2 - (mod >> 3))  # 5, 7, 10
                            for k in range(group_size):
                                grbuf[ch, band, base_slot + k] = float(
                                    code % mod - mod // 2
                                )
                                code //= mod
            if layer == 1 and igr < 2:
                # Layer I accumulates 3 granule-iterations (12 slots) before
                # synthesis; stash and continue
                pass
            # apply scalefactors (L12_apply_scf_384): granule igr uses
            # scf part igr; mono bands copy ch0 -> ch1
            nslots = group_size * 4
            if nch == 2:
                sb = sci["stereo_bands"]
                grbuf[1, sb:, :] = grbuf[0, sb:, :]
            for band in range(sci["total_bands"]):
                for ch in range(nch):
                    scf = sci["scf"][band * 6 + ch * 3 + igr]
                    grbuf[ch, band, :nslots] *= scf
            s0 = igr * nslots if layer != 1 else igr * 4
            S[0, :nch, s0 : s0 + nslots, :] = np.transpose(
                grbuf[:nch, :, :nslots], (0, 2, 1)
            )
            slot = s0 + nslots
        return S[0, :, :slot], fb

    # -- streaming read (mp3dec_ex_read, minimp3_ex.d:787-888) ---------------
    def read(self, max_frames: int, dtype=np.float32) -> np.ndarray:
        nch = self.channels
        out = []
        got = 0
        limit = self._total_samples
        while got < max_frames:
            avail = self._buf.shape[0] - self._buf_start
            if avail == 0:
                if limit and self._cur_sample >= limit:
                    break
                if self._offset >= len(self._view) - HDR_SIZE:
                    break
                if self._layer == 3 and not self._to_skip:
                    pcm, fb = self._decode_l3_window()
                else:
                    pcm, fb = self._decode_frame_at(self._offset)
                if pcm is None:
                    break
                self._offset += fb
                if pcm.shape[0] == 0:
                    if self._to_skip:
                        self._to_skip = max(
                            0, self._to_skip - self._spf * nch
                        )
                    continue
                if self._to_skip:
                    skip_frames = min(pcm.shape[0], self._to_skip // nch)
                    pcm = pcm[skip_frames:]
                    self._to_skip -= skip_frames * nch
                self._buf = pcm
                self._buf_start = 0
                avail = pcm.shape[0]
                if avail == 0:
                    continue
            take = min(avail, max_frames - got)
            if limit:
                remain = (limit - self._cur_sample) // nch
                take = min(take, max(0, remain))
                if take == 0:
                    break
            out.append(self._buf[self._buf_start : self._buf_start + take])
            self._buf_start += take
            self._cur_sample += take * nch
            got += take
        if not out:
            return np.zeros((0, nch), dtype=dtype)
        return np.concatenate(out).astype(dtype)

    # -- seek (mp3dec_ex_seek, minimp3_ex.d:662-785) --------------------------
    def tell(self) -> int:
        return self._cur_sample // self.channels

    def seek(self, frame: int) -> bool:
        if frame < 0 or frame > self.length_frames:
            return False
        nch = self.channels
        position = frame * nch + self._start_delay
        self._buf = np.zeros((0, nch), dtype=np.float32)
        self._buf_start = 0
        self._cur_sample = frame * nch
        self._reset_decoder_state()
        if position == 0:
            self._offset = self._start_offset
            self._to_skip = 0
            return True
        idx = self._index_samples
        i = int(np.searchsorted(idx, position, side="right") - 1)
        i = max(0, i)
        # predecode + reservoir preroll (minimp3_ex.d:713-752)
        i = max(0, i - PREDECODE_FRAMES)
        to_fill = 511 if self._layer == 3 else 0
        while i and to_fill:
            off = int(self._index_offsets[i - 1])
            h = self._view[off : off + 4]
            fb = _hdr_frame_bytes(h, self._free_format_bytes) + _hdr_padding(h)
            bs = _Bits(self._view[off + 4 : off + fb])
            if not (h[1] & 1):
                bs.get(16)
            i -= 1
            try:
                _read_side_info(bs, h)
            except AudioFormatError:
                break
            frame_bytes = (bs.limit - bs.pos) // 8
            to_fill -= min(to_fill, frame_bytes)
        self._offset = int(self._index_offsets[i])
        self._to_skip = int(position - self._index_samples[i])
        return True

# ---------------------------------------------------------------------------
# Layer I/II scale info (minimp3.d:286-430)
# ---------------------------------------------------------------------------

# (tab_offset into BITALLOC_CODE_TAB, code width, band count)
_ALLOC_L1 = [(76, 4, 32)]
_ALLOC_L2M2 = [(60, 4, 4), (44, 3, 7), (44, 2, 19)]
_ALLOC_L2M1 = [(0, 4, 3), (16, 4, 8), (32, 3, 12), (40, 2, 7)]
_ALLOC_L2M1_LOW = [(44, 4, 2), (44, 3, 10)]

# dequant scale table (minimp3.d:356-366; ISO quantization steps)
_DEQ_L12 = [
    3.17891e-07, 2.52311e-07, 2.00259e-07, 1.36239e-07, 1.08133e-07,
    8.58253e-08, 6.35783e-08, 5.04621e-08, 4.00518e-08, 3.07637e-08,
    2.44172e-08, 1.93799e-08, 1.51377e-08, 1.20148e-08, 9.53615e-09,
    7.50925e-09, 5.96009e-09, 4.73053e-09, 3.7399e-09, 2.96836e-09,
    2.35599e-09, 1.86629e-09, 1.48128e-09, 1.17569e-09, 9.32233e-10,
    7.39914e-10, 5.8727e-10, 4.65889e-10, 3.69776e-10, 2.93492e-10,
    2.32888e-10, 1.84843e-10, 1.4671e-10, 1.1643e-10, 9.24102e-11,
    7.3346e-11, 5.82112e-11, 4.62023e-11, 3.66708e-11, 2.91047e-11,
    2.31004e-11, 1.83348e-11, 1.45521e-11, 1.155e-11, 9.16727e-12,
    3.17891e-07, 2.52311e-07, 2.00259e-07, 1.90735e-07, 1.51386e-07,
    1.20155e-07, 1.05964e-07, 8.41035e-08, 6.6753e-08,
]


def _l12_subband_alloc(h):
    mode = (h[3] >> 6) & 3
    mode_ext = (h[3] >> 4) & 3
    if mode == 3:
        stereo_bands = 0
    elif mode == 1:
        stereo_bands = (mode_ext << 2) + 4
    else:
        stereo_bands = 32
    if (h[1] & 6) == 6:  # layer 1
        alloc, nbands = _ALLOC_L1, 32
    elif not _is_mpeg1(h):
        alloc, nbands = _ALLOC_L2M2, 30
    else:
        sr_idx = (h[2] >> 2) & 3
        kbps = _hdr_bitrate_kbps(h) >> (1 if mode != 3 else 0)
        if not kbps:
            kbps = 192
        alloc, nbands = _ALLOC_L2M1, 27
        if kbps < 56:
            alloc = _ALLOC_L2M1_LOW
            nbands = 12 if sr_idx == 2 else 8
        elif kbps >= 96 and sr_idx != 1:
            nbands = 30
    return alloc, nbands, min(stereo_bands, nbands)


def _l12_read_scale_info(h, bs: "_Bits") -> dict:
    alloc, total_bands, stereo_bands = _l12_subband_alloc(h)
    bitalloc = [0] * 64
    scfcod = [0] * 64
    k = 0
    ai = -1
    ba_bits = 0
    tab_off = 0
    for i in range(total_bands):
        if i == k:
            ai += 1
            tab_off, ba_bits, cnt = alloc[ai]
            k += cnt
        ba = T.BITALLOC_CODE_TAB[tab_off + bs.get(ba_bits)]
        bitalloc[2 * i] = ba
        if i < stereo_bands:
            ba = T.BITALLOC_CODE_TAB[tab_off + bs.get(ba_bits)]
        bitalloc[2 * i + 1] = ba if stereo_bands else 0
    for i in range(2 * total_bands):
        # NOTE: scfcod bits exist only for allocated subchannels.  The D
        # reference hoists get_bits out of the C short-circuit ternary
        # (minimp3.d:430) and would misread mono/partially-allocated Layer II
        # streams; we keep the original minimp3/ISO semantics.
        if bitalloc[i]:
            scfcod[i] = 2 if (h[1] & 6) == 6 else bs.get(2)
        else:
            scfcod[i] = 6
    # scalefactors (L12_read_scalefactors, minimp3.d:354-386)
    scf = [0.0] * (64 * 3)
    idx = 0
    for i in range(2 * total_bands):
        s = 0.0
        ba = bitalloc[i]
        mask = (4 + ((19 >> scfcod[i]) & 3)) if ba else 0
        m = 4
        while m:
            if mask & m:
                b = bs.get(6)
                s = _DEQ_L12[ba * 3 - 6 + b % 3] * float(1 << 21 >> (b // 3))
            scf[idx] = s
            idx += 1
            m >>= 1
    for i in range(stereo_bands, total_bands):
        bitalloc[2 * i + 1] = 0
    return {
        "total_bands": total_bands,
        "stereo_bands": stereo_bands,
        "bitalloc": bitalloc,
        "scf": scf,
    }
