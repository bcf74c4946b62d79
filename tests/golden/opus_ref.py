"""Golden Opus helpers: RFC 6716 §5.1 range ENCODER (for decoder roundtrip
validation) and Ogg-Opus stream fixtures."""

from __future__ import annotations

import struct
import sys
import os

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
from audio_formats_tpu.io import ogg  # noqa: E402

SYM_BITS = 8
SYM_MAX = 255
CODE_BITS = 32
CODE_TOP = 1 << 31
CODE_BOT = 1 << 23
CODE_SHIFT = CODE_BITS - SYM_BITS - 1  # 23


class RangeEncoder:
    def __init__(self, size: int):
        self.buf = bytearray(size)
        self.size = size
        self.offs = 0
        self.end_offs = 0
        self.end_window = 0
        self.nend_bits = 0
        self.val = 0
        self.rng = CODE_TOP
        self.rem = -1
        self.ext = 0

    def _write_byte(self, b: int) -> None:
        assert self.offs + self.end_offs < self.size
        self.buf[self.offs] = b & 0xFF
        self.offs += 1

    def _write_byte_at_end(self, b: int) -> None:
        assert self.offs + self.end_offs < self.size
        self.end_offs += 1
        self.buf[self.size - self.end_offs] = b & 0xFF

    def _carry_out(self, c: int) -> None:
        if c != SYM_MAX:
            carry = c >> SYM_BITS
            if self.rem >= 0:
                self._write_byte(self.rem + carry)
            while self.ext > 0:
                self._write_byte((SYM_MAX + carry) & SYM_MAX)
                self.ext -= 1
            self.rem = c & SYM_MAX
        else:
            self.ext += 1

    def _normalize(self) -> None:
        while self.rng <= CODE_BOT:
            self._carry_out(self.val >> CODE_SHIFT)
            self.val = (self.val << SYM_BITS) & (CODE_TOP - 1)
            self.rng <<= SYM_BITS

    def encode(self, fl: int, fh: int, ft: int) -> None:
        r = self.rng // ft
        if fl > 0:
            self.val += self.rng - r * (ft - fl)
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * (ft - fh)
        self._normalize()

    def encode_bin(self, fl: int, fh: int, bits: int) -> None:
        r = self.rng >> bits
        if fl > 0:
            self.val += self.rng - r * ((1 << bits) - fl)
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * ((1 << bits) - fh)
        self._normalize()

    def enc_bit_logp(self, bit: int, logp: int) -> None:
        r = self.rng
        l = self.val
        s = r >> logp
        r -= s
        if bit:
            self.val = l + r
        self.rng = s if bit else r
        self._normalize()

    def enc_icdf(self, s: int, icdf, ftb: int) -> None:
        r = self.rng >> ftb
        if s > 0:
            self.val += self.rng - r * icdf[s - 1]
            self.rng = r * (icdf[s - 1] - icdf[s])
        else:
            self.rng -= r * icdf[s]
        self._normalize()

    def enc_uint(self, fl: int, ft: int) -> None:
        assert ft > 1
        ft -= 1
        ftb = ft.bit_length()
        if ftb > 8:
            ftb -= 8
            ft1 = (ft >> ftb) + 1
            fl1 = fl >> ftb
            self.encode(fl1, fl1 + 1, ft1)
            self.enc_bits(fl & ((1 << ftb) - 1), ftb)
        else:
            self.encode(fl, fl + 1, ft + 1)

    def enc_bits(self, fl: int, bits: int) -> None:
        window = self.end_window
        used = self.nend_bits
        window |= fl << used
        used += bits
        while used >= SYM_BITS:
            self._write_byte_at_end(window & SYM_MAX)
            window >>= SYM_BITS
            used -= SYM_BITS
        self.end_window = window
        self.nend_bits = used

    def done(self) -> bytes:
        l = CODE_BITS - self.rng.bit_length()
        msk = (CODE_TOP - 1) >> l
        end = (self.val + msk) & ~msk
        if (end | msk) >= self.val + self.rng:
            l += 1
            msk >>= 1
            end = (self.val + msk) & ~msk
        while l > 0:
            self._carry_out(end >> CODE_SHIFT)
            end = (end << SYM_BITS) & (CODE_TOP - 1)
            l -= SYM_BITS
        if self.rem >= 0 or self.ext > 0:
            self._carry_out(0)
        # flush raw-bit window
        window = self.end_window
        used = self.nend_bits
        while used > 0:
            self._write_byte_at_end(window & SYM_MAX)
            window >>= SYM_BITS
            used -= SYM_BITS
        return bytes(self.buf)


def build_ogg_opus(packets, channels=1, preskip=312, final_granule=None,
                   gain_q8=0, packets_per_page=5):
    """Assemble an Ogg Opus stream.  packets: list of (bytes, samples48k)."""
    head = (b"OpusHead" + bytes([1, channels])
            + struct.pack("<H", preskip) + struct.pack("<I", 44100)
            + struct.pack("<h", gain_q8) + bytes([0]))
    vendor = b"af-ref"
    tags = (b"OpusTags" + struct.pack("<I", len(vendor)) + vendor
            + struct.pack("<I", 1)
            + struct.pack("<I", len(b"R128_TRACK_GAIN=-1024"))
            + b"R128_TRACK_GAIN=-1024")
    serial = 0x0B0E
    pages = [ogg.build_page([head], serial, 0, 0, bos=True),
             ogg.build_page([tags], serial, 1, 0)]
    seq = 2
    granule = 0  # RFC 7845: cumulative decoded samples incl. preskip region
    for i in range(0, len(packets), packets_per_page):
        group = packets[i : i + packets_per_page]
        granule += sum(n for _, n in group)
        last = i + packets_per_page >= len(packets)
        g = granule
        if last and final_granule is not None:
            g = final_granule
        pages.append(ogg.build_page([p for p, _ in group], serial, seq, g,
                                    eos=last))
        seq += 1
    return b"".join(pages)


def silence_packet(config=17, frame_size=None, stereo=0):
    """A CELT packet whose single frame codes 'silence' (logp-15 bit set)."""
    enc = RangeEncoder(4)
    enc.enc_bit_logp(1, 15)
    frame = enc.done()
    toc = (config << 3) | (stereo << 2) | 0
    nsamples = [480, 960, 1920, 2880][config & 3] if config < 12 else \
        (480 << (config & 1)) if config < 16 else (120 << (config & 3))
    return bytes([toc]) + frame, nsamples


def dtx_packet(config=17):
    """Zero-length frame packet (DTX)."""
    nsamples = 120 << (config & 3) if config >= 16 else 960
    return bytes([(config << 3) | 0]), nsamples
