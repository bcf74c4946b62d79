"""Golden Vorbis fixture generator.

Builds small but fully spec-conformant Ogg Vorbis streams with *chosen*
floor posts and residue vectors, so the exact expected decoder output is
computable independently (floor render → coupling → spectrum → IMDCT → lapped
OLA, all in float64 numpy).  Exercises: codebooks (scalar + VQ lookup type
1), floor1 with multi-segment posts, residue type 2 with classwords, channel
coupling, single and dual block sizes with window transitions.

Independent of audio_formats_tpu except the Ogg page writer and the spec's
inverse-dB table (shared constants).
"""

from __future__ import annotations

import sys
import os

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
from audio_formats_tpu.io import ogg  # page writer only  # noqa: E402
from audio_formats_tpu.utils.tables.vorbis_tables import INVERSE_DB_TABLE  # noqa: E402


def ilog(x):
    r = 0
    while x > 0:
        r += 1
        x >>= 1
    return r


class _BW:  # LSB-first bit writer
    def __init__(self):
        self.bytes = bytearray()
        self.acc = 0
        self.n = 0

    def w(self, v, bits):
        self.acc |= (v & ((1 << bits) - 1)) << self.n
        self.n += bits
        while self.n >= 8:
            self.bytes.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def done(self):
        if self.n:
            self.bytes.append(self.acc & 0xFF)
            self.acc = 0
            self.n = 0
        return bytes(self.bytes)


def assign_codewords(lengths):
    """Canonical Vorbis codeword assignment (spec §3.2.1)."""
    codes = [0] * len(lengths)
    used = [i for i, l in enumerate(lengths) if l > 0]
    if len(used) <= 1:
        return codes
    available = [0] * 33
    first = True
    for i in used:
        ln = lengths[i]
        if first:
            codes[i] = 0
            for j in range(1, ln + 1):
                available[j] = 1 << (32 - j)
            first = False
            continue
        j = ln
        while j > 0 and not available[j]:
            j -= 1
        res = available[j]
        available[j] = 0
        codes[i] = res >> (32 - ln)
        for k in range(j + 1, ln + 1):
            available[k] = res + (1 << (32 - k))
    return codes


def _wcode(bw, code, length):
    """Write a Huffman codeword: MSB of the codeword goes first."""
    for b in range(length - 1, -1, -1):
        bw.w((code >> b) & 1, 1)


class Fixture:
    """A concrete tiny Vorbis configuration."""

    def __init__(self, channels=1, bs0=512, bs1=512, sample_rate=44100,
                 coupling=False, extra_floor0=False):
        #: when set, the setup header carries an (unused) floor type 0
        #: config before the floor1 — a tolerance case: stb_vorbis parses
        #: floor0 configs at setup and errors only if a packet uses one
        self.extra_floor0 = extra_floor0
        self.channels = channels
        self.bs0 = bs0
        self.bs1 = bs1
        self.rate = sample_rate
        self.coupling = coupling and channels == 2
        self.two_sizes = bs1 != bs0
        # floor book: 128 scalar entries, flat 7-bit codes
        self.floor_entries = 128
        self.floor_lens = [7] * 128
        self.floor_codes = assign_codewords(self.floor_lens)
        # class book: scalar, cw dims=4, classifications=2 -> 16 entries
        self.cw = 4
        self.classifications = 2
        self.class_lens = [4] * 16
        self.class_codes = assign_codewords(self.class_lens)
        # residue VQ book: lookup type 1, dims=2, 11x11 grid
        self.vq_dims = 2
        self.vq_quant = 11
        self.vq_entries = 121
        self.vq_lens = [7] * 121
        self.vq_codes = assign_codewords(self.vq_lens)
        self.vq_min = -2.5
        self.vq_delta = 0.5
        self.part_size = 8
        # floor1 layout: xlist [0, 256, 64, 128] multiplier 2 (range 128)
        self.floor_x = [0, 256, 64, 128]
        self.multiplier = 2

    # ------------------------------------------------------------- headers
    def id_header(self):
        bw = _BW()
        for ch in b"\x01vorbis":
            bw.w(ch, 8)
        bw.w(0, 32)
        bw.w(self.channels, 8)
        bw.w(self.rate, 32)
        bw.w(0, 32)
        bw.w(0, 32)
        bw.w(0, 32)
        bw.w(ilog(self.bs0) - 1, 4)
        bw.w(ilog(self.bs1) - 1, 4)
        bw.w(1, 1)
        return bw.done()

    def comment_header(self):
        bw = _BW()
        for ch in b"\x03vorbis":
            bw.w(ch, 8)
        vendor = b"af-ref-fixture"
        bw.w(len(vendor), 32)
        for c in vendor:
            bw.w(c, 8)
        bw.w(0, 32)  # no comments
        bw.w(1, 1)
        return bw.done()

    def _write_codebook_scalar(self, bw, entries, lengths):
        bw.w(0x564342, 24)
        bw.w(1, 16)  # dims=1 (scalar use)
        bw.w(entries, 24)
        bw.w(0, 1)  # not ordered
        bw.w(0, 1)  # not sparse
        for ln in lengths:
            bw.w(ln - 1, 5)
        bw.w(0, 4)  # no lookup

    def _write_codebook_class(self, bw):
        bw.w(0x564342, 24)
        bw.w(self.cw, 16)  # dims = classword size
        bw.w(16, 24)
        bw.w(0, 1)
        bw.w(0, 1)
        for ln in self.class_lens:
            bw.w(ln - 1, 5)
        bw.w(0, 4)

    def _write_codebook_vq(self, bw):
        bw.w(0x564342, 24)
        bw.w(self.vq_dims, 16)
        bw.w(self.vq_entries, 24)
        bw.w(0, 1)
        bw.w(0, 1)
        for ln in self.vq_lens:
            bw.w(ln - 1, 5)
        bw.w(1, 4)  # lookup type 1
        # float32_pack(min), float32_pack(delta)
        bw.w(_float32_pack(self.vq_min), 32)
        bw.w(_float32_pack(self.vq_delta), 32)
        bw.w(4 - 1, 4)  # value_bits=4 (mults 0..10 fit)
        bw.w(0, 1)  # no sequence_p
        for m in range(self.vq_quant):
            bw.w(m, 4)

    def setup_header(self):
        bw = _BW()
        for ch in b"\x05vorbis":
            bw.w(ch, 8)
        bw.w(3 - 1, 8)  # 3 codebooks
        self._write_codebook_scalar(bw, self.floor_entries, self.floor_lens)
        self._write_codebook_class(bw)
        self._write_codebook_vq(bw)
        # time transforms
        bw.w(0, 6)
        bw.w(0, 16)
        # floors
        if self.extra_floor0:
            bw.w(1, 6)   # 2 floors: [floor0 (unused), floor1]
            bw.w(0, 16)  # type 0
            bw.w(8, 8)   # order
            bw.w(8000, 16)
            bw.w(64, 16)  # bark_map_size
            bw.w(6, 6)    # amplitude_bits
            bw.w(0, 8)    # amplitude_offset
            bw.w(0, 4)    # 1 book
            bw.w(0, 8)    # book 0
        else:
            bw.w(0, 6)
        bw.w(1, 16)
        bw.w(1, 5)  # partitions = 1
        bw.w(0, 4)  # partition class 0
        bw.w(2 - 1, 3)  # class 0 dims = 2
        bw.w(0, 2)  # subclasses = 0
        bw.w(0 + 1, 8)  # subclass book 0 (stored +1)
        bw.w(self.multiplier - 1, 2)
        bw.w(8, 4)  # rangebits (xlist values < 256)
        bw.w(self.floor_x[2], 8)
        bw.w(self.floor_x[3], 8)
        # residues: 1 residue, type 2
        bw.w(0, 6)
        bw.w(2, 16)
        bw.w(0, 24)  # begin
        bw.w(1 << 23, 24)  # end (clipped to actual size by decoder)
        bw.w(self.part_size - 1, 24)
        bw.w(self.classifications - 1, 6)
        bw.w(1, 8)  # classbook = book 1
        # cascade: class0 -> no pass; class1 -> pass 0
        bw.w(0, 3); bw.w(0, 1)
        bw.w(1, 3); bw.w(0, 1)
        # books: class1 pass0 = book 2
        bw.w(2, 8)
        # mappings: 1 mapping type 0
        bw.w(0, 6)
        bw.w(0, 16)
        bw.w(0, 1)  # submaps = 1
        if self.coupling:
            bw.w(1, 1)
            bw.w(0, 8)  # 1 coupling step
            bits = ilog(self.channels - 1)
            bw.w(0, bits)  # mag = ch0
            bw.w(1, bits)  # ang = ch1
        else:
            bw.w(0, 1)
        bw.w(0, 2)
        # (submaps == 1: no mux)
        bw.w(0, 8)  # time config
        bw.w(1 if self.extra_floor0 else 0, 8)  # the floor1's index
        bw.w(0, 8)  # residue 0
        # modes
        n_modes = 2 if self.two_sizes else 1
        bw.w(n_modes - 1, 6)
        bw.w(0, 1); bw.w(0, 16); bw.w(0, 16); bw.w(0, 8)  # mode 0: short
        if self.two_sizes:
            bw.w(1, 1); bw.w(0, 16); bw.w(0, 16); bw.w(0, 8)  # mode 1: long
        bw.w(1, 1)  # framing bit
        return bw.done()

    # -------------------------------------------------------------- packets
    def audio_packet(self, floor_posts, residues, long_block=False,
                     prev_flag=1, next_flag=1):
        """floor_posts: [ch][4] y values (or None for unused channel);
        residues: [ch][n2] values on the VQ grid."""
        bw = _BW()
        bw.w(0, 1)  # audio packet
        if self.two_sizes:
            bw.w(1 if long_block else 0, 1)
        if long_block:
            bw.w(prev_flag, 1)
            bw.w(next_flag, 1)
        n = self.bs1 if long_block else self.bs0
        n2 = n // 2
        ranges = [256, 128, 86, 64][self.multiplier - 1]
        ybits = ilog(ranges - 1)
        for c in range(self.channels):
            posts = floor_posts[c]
            if posts is None:
                bw.w(0, 1)
                continue
            bw.w(1, 1)
            bw.w(posts[0], ybits)
            bw.w(posts[1], ybits)
            # partition 0: class 0, dims 2 -> posts[2], posts[3] via book 0
            for p in (posts[2], posts[3]):
                _wcode(bw, self.floor_codes[p], self.floor_lens[p])

        # residue type 2: interleave channels
        ch = self.channels
        interleaved = np.zeros(n2 * ch)
        for c in range(ch):
            interleaved[c::ch] = residues[c]
        npart = (n2 * ch) // self.part_size
        classes = []
        for p in range(npart):
            seg = interleaved[p * self.part_size : (p + 1) * self.part_size]
            classes.append(1 if np.any(seg != 0) else 0)
        # pass 0: classwords then vq codes, cw partitions per classword
        p = 0
        while p < npart:
            group = classes[p : p + self.cw]
            group = group + [0] * (self.cw - len(group))
            temp = 0
            for g in group:
                temp = temp * self.classifications + g
            _wcode(bw, self.class_codes[temp], self.class_lens[temp])
            for i in range(self.cw):
                if p >= npart:
                    break
                if classes[p] == 1:
                    seg = interleaved[
                        p * self.part_size : (p + 1) * self.part_size
                    ]
                    for k in range(0, self.part_size, self.vq_dims):
                        pair = seg[k : k + self.vq_dims]
                        e = self._vq_entry(pair)
                        _wcode(bw, self.vq_codes[e], self.vq_lens[e])
                p += 1

        # window geometry for granule accounting
        if long_block and not prev_flag:
            left_start = (n - self.bs0) >> 2
        else:
            left_start = 0
        if long_block and not next_flag:
            right_start = (n * 3 - self.bs0) >> 2
        else:
            right_start = n2
        return bw.done(), right_start - left_start

    def _vq_entry(self, pair):
        idx = []
        for v in pair:
            i = int(round((v - self.vq_min) / self.vq_delta))
            assert 0 <= i < self.vq_quant and abs(
                self.vq_min + i * self.vq_delta - v) < 1e-9, v
            idx.append(i)
        # lookup type 1: dim d uses (e // quant^d) % quant
        return idx[0] + idx[1] * self.vq_quant

    def build(self, packets, per_page=4, final_granule=None):
        """Assemble the Ogg stream from (packet_bytes, ret_len) tuples.

        Page granules are cumulative returned-sample counts (the first audio
        packet returns nothing — lap priming).  `final_granule` overrides the
        last page's granule to exercise end-truncation."""
        serial = 0xAF01
        pages = [ogg.build_page([self.id_header()], serial, 0, 0, bos=True)]
        pages.append(ogg.build_page(
            [self.comment_header(), self.setup_header()], serial, 1, 0
        ))
        seq = 2
        out_pos = 0
        first = True
        for i in range(0, len(packets), per_page):
            group = packets[i : i + per_page]
            for _, ret in group:
                if not first:
                    out_pos += ret
                first = False
            is_last = i + per_page >= len(packets)
            granule = out_pos
            if is_last and final_granule is not None:
                granule = final_granule
            pages.append(ogg.build_page(
                [pk for pk, _ in group], serial, seq, granule, eos=is_last,
            ))
            seq += 1
        return b"".join(pages)


def _float32_pack(v: float) -> int:
    """Inverse of Vorbis float32_unpack for exactly-representable values."""
    sign = 0
    if v < 0:
        sign = 1
        v = -v
    if v == 0:
        return 0
    exp = 0
    m = v
    # normalize mantissa to integer < 2^21
    while m != int(m):
        m *= 2
        exp -= 1
    m = int(m)
    while m >= (1 << 21):
        m >>= 1
        exp += 1
    return (sign << 31) | ((exp + 788 + 0) << 21) | m


# ---------------------------------------------------------------------------
# Expectation model (independent float64 pipeline)
# ---------------------------------------------------------------------------

def render_floor_curve(xlist, posts, multiplier, n2):
    """Spec floor1 curve for ALL-nonzero posts (fixture posts are chosen so
    every post is 'new' i.e. step2 set; amplitude synthesis with neighbors)."""
    ranges = [256, 128, 86, 64][multiplier - 1]
    n_pts = len(xlist)
    final_y = list(posts[:2]) + [0] * (n_pts - 2)
    for i in range(2, n_pts):
        lo = 0
        hi = 1
        for j in range(i):
            if xlist[lo] < xlist[j] < xlist[i]:
                lo = j
            if xlist[i] < xlist[j] < xlist[hi]:
                hi = j
        dy = final_y[hi] - final_y[lo]
        adx = xlist[hi] - xlist[lo]
        err = abs(dy) * (xlist[i] - xlist[lo])
        off = err // adx
        pred = final_y[lo] - off if dy < 0 else final_y[lo] + off
        val = posts[i]
        high_room = ranges - pred
        low_room = pred
        room = 2 * min(high_room, low_room)
        if val:
            if val >= room:
                final_y[i] = (val - low_room + pred if high_room > low_room
                              else pred - val + high_room - 1)
            else:
                final_y[i] = (pred - ((val + 1) >> 1) if val & 1
                              else pred + (val >> 1))
        else:
            final_y[i] = pred
    order = np.argsort(xlist, kind="stable")
    curve = np.zeros(n2)
    xs = np.array(xlist)
    lx, ly = 0, final_y[order[0]] * multiplier
    nonzero_posts = [True] * n_pts  # fixtures always set every post
    for idx in order[1:]:
        hx, hy = xlist[idx], final_y[idx] * multiplier
        if lx < n2:
            _gold_line(lx, ly, min(hx, n2), hy, curve)
        lx, ly = hx, hy
    if lx < n2:
        curve[lx:] = INVERSE_DB_TABLE[min(ly, 255)]
    return curve


def _gold_line(x0, y0, x1, y1, curve):
    dy = y1 - y0
    adx = x1 - x0
    if adx <= 0:
        return
    base = dy // adx if dy >= 0 else -((-dy) // adx)
    ady = abs(dy) - abs(base) * adx
    y = y0
    err = 0
    curve[x0] = INVERSE_DB_TABLE[min(max(y, 0), 255)]
    for x in range(x0 + 1, x1):
        err += ady
        if err >= adx:
            err -= adx
            y += base + (1 if dy >= 0 else -1)
        else:
            y += base
        curve[x] = INVERSE_DB_TABLE[min(max(y, 0), 255)]


def inverse_couple(M, A):
    newM = M.copy()
    newA = A.copy()
    for j in range(len(M)):
        m, a = M[j], A[j]
        if m > 0:
            if a > 0:
                newM[j], newA[j] = m, m - a
            else:
                newA[j], newM[j] = m, m + a
        else:
            if a > 0:
                newM[j], newA[j] = m, m + a
            else:
                newA[j], newM[j] = m, m - a
    return newM, newA


def imdct64(X, n):
    m = n // 2
    k = np.arange(m)[:, None]
    t = np.arange(n)[None, :]
    C = np.cos(np.pi / (2 * n) * (2 * t + 1 + m) * (2 * k + 1))
    return X @ C


def slope(L):
    j = np.arange(L)
    s = np.sin(np.pi / (2 * L) * (j + 0.5))
    return np.sin(np.pi / 2 * s * s)


def expected_output(fix: Fixture, frames):
    """frames: list of dicts {posts: [ch][4]|None, residues: [ch][n2],
    long: bool, prev: int, next: int}.  Returns expected [total, ch]."""
    ch = fix.channels
    prev = None
    out = []
    for fr in frames:
        n = fix.bs1 if fr.get("long") else fix.bs0
        n2 = n // 2
        spec = np.zeros((ch, n2))
        curves = []
        for c in range(ch):
            posts = fr["posts"][c]
            curves.append(
                render_floor_curve(fix.floor_x, posts, fix.multiplier, n2)
                if posts is not None else None
            )
        res = [np.array(fr["residues"][c], dtype=np.float64) for c in range(ch)]
        if fix.coupling:
            zero = [fr["posts"][c] is None for c in range(ch)]
            if not all(zero):
                M, A = inverse_couple(res[0], res[1])
                res = [M, A]
        for c in range(ch):
            if curves[c] is not None:
                spec[c] = res[c] * curves[c]
        y = imdct64(spec, n)
        # window geometry
        if fr.get("long") and not fr.get("prev", 1):
            left_start = (n - fix.bs0) >> 2
        else:
            left_start = 0
        if fr.get("long") and not fr.get("next", 1):
            right_start = (n * 3 - fix.bs0) >> 2
            right_end = (n * 3 + fix.bs0) >> 2
        else:
            right_start = n2
            right_end = n
        if prev is not None and prev.shape[1] > 0:
            L = prev.shape[1]
            w = slope(L)
            seg = y[:, left_start : left_start + L]
            y[:, left_start : left_start + L] = seg * w + prev * w[::-1]
        had_prev = prev is not None
        prev = y[:, right_start:right_end].copy()
        if had_prev:
            out.append(y[:, left_start:right_start].T)
    return np.concatenate(out) if out else np.zeros((0, ch))
