"""Golden ProTracker MOD fixture builder (M.K. 4-channel, 31 samples)."""

from __future__ import annotations

import numpy as np

PERIODS = [856, 808, 762, 720, 678, 640, 604, 570, 538, 508, 480, 453,
           428, 404, 381, 360, 339, 320, 302, 285, 269, 254, 240, 226,
           214, 202, 190, 180, 170, 160, 151, 143, 135, 127, 120, 113]


def cell(sample=0, period=0, effect=0, param=0):
    """4-byte pattern cell."""
    return bytes([
        (sample & 0xF0) | ((period >> 8) & 0x0F),
        period & 0xFF,
        ((sample & 0x0F) << 4) | (effect & 0x0F),
        param & 0xFF,
    ])


def build_mod(patterns, order, samples, title=b"af-ref test"):
    """patterns: list of [64][4] cells (bytes); order: list of pattern idx;
    samples: list of (np.int8 data, volume, finetune, loop_start, loop_len)."""
    out = bytearray()
    out += title.ljust(20, b"\0")[:20]
    for i in range(31):
        if i < len(samples):
            data, volume, finetune, loop_start, loop_len = samples[i]
            name = b"sample%d" % i
            out += name.ljust(22, b"\0")[:22]
            out += (len(data) // 2).to_bytes(2, "big")
            out += bytes([finetune & 0x0F, volume])
            out += (loop_start // 2).to_bytes(2, "big")
            out += (loop_len // 2).to_bytes(2, "big")
        else:
            out += b"\0" * 22 + b"\0\0" + b"\0\x40" + b"\0\0" + b"\0\x01"
    out += bytes([len(order), 0])
    out += bytes(order).ljust(128, b"\0")[:128]
    out += b"M.K."
    for pat in patterns:
        for row in pat:
            for c in row:
                out += c
    for s in samples:
        out += s[0].astype(np.int8).tobytes()
    return bytes(out)


def empty_pattern():
    return [[cell() for _ in range(4)] for _ in range(64)]


def saw_sample(length=64, amp=100):
    x = np.linspace(-amp, amp, length).astype(np.int8)
    return x
