"""Golden FastTracker II XM fixture builder."""

from __future__ import annotations

import struct

import numpy as np


def build_xm(patterns, order, instruments, channels=4, linear=True,
             tempo=6, bpm=125, restart=0, name=b"af-ref xm"):
    """patterns: list of [rows][channels] tuples
    (note, instr, volcol, fx, param); order: pattern indices;
    instruments: list of dicts:
      {samples: [ {data: np.int8/int16 array, volume, finetune,
                   loop_type, loop_start, loop_len, panning, relative_note,
                   bits} ],
       sample_of_notes: [96], vol_env: {...}|None, fadeout: int}
    """
    out = bytearray()
    out += b"Extended Module: "
    out += name.ljust(20, b"\0")[:20]
    out += bytes([0x1A])
    out += b"af-ref tracker".ljust(20, b"\0")[:20]
    out += struct.pack("<H", 0x0104)
    header = struct.pack(
        "<IHHHHHHHH", 276, len(order), restart, channels, len(patterns),
        len(instruments), 1 if linear else 0, tempo, bpm,
    )
    out += header
    out += bytes(order).ljust(256, b"\0")[:256]

    for pat in patterns:
        rows = len(pat)
        packed = bytearray()
        for row in pat:
            for cell in row:
                note, instr, vol, fx, param = cell
                packed += bytes([note, instr, vol, fx, param])
        out += struct.pack("<IBHH", 9, 0, rows, len(packed))
        out += packed

    for ins in instruments:
        samples = ins["samples"]
        ihdr = bytearray()
        ihdr += struct.pack("<I", 263)
        ihdr += b"instr".ljust(22, b"\0")
        ihdr += bytes([0])
        ihdr += struct.pack("<H", len(samples))
        if samples:
            ihdr += struct.pack("<I", 40)
            ihdr += bytes(ins.get("sample_of_notes", [0] * 96))
            vol_env = ins.get("vol_env")
            pts = (vol_env or {}).get("points", [])
            env_bytes = bytearray()
            for f, v in (pts + [(0, 0)] * 12)[:12]:
                env_bytes += struct.pack("<HH", f, v)
            ihdr += env_bytes
            ihdr += bytes(48)  # panning envelope points
            ihdr += bytes([len(pts)])  # num vol points
            ihdr += bytes([0])  # num pan points
            ihdr += bytes([(vol_env or {}).get("sustain", 0)])
            ihdr += bytes([(vol_env or {}).get("loop_start", 0),
                           (vol_env or {}).get("loop_end", 0)])
            ihdr += bytes([0, 0, 0])  # pan sustain/loop
            vtype = 0
            if vol_env:
                vtype = 1 | (2 if vol_env.get("sustain_on") else 0) | \
                    (4 if vol_env.get("loop_on") else 0)
            ihdr += bytes([vtype, 0])
            ihdr += bytes([0, 0, 0, 0])  # vibrato type/sweep/depth/rate
            ihdr += struct.pack("<H", ins.get("fadeout", 0))
            ihdr = ihdr.ljust(263, b"\0")
        out += ihdr
        payloads = []
        for s in samples:
            data = np.asarray(s["data"])
            bits = s.get("bits", 8)
            if bits == 16:
                delta = np.diff(np.concatenate([[0], data.astype(np.int64)]))
                payload = delta.astype("<i2").tobytes()
                length = len(data) * 2
                ls = s.get("loop_start", 0) * 2
                ll = s.get("loop_len", 0) * 2
            else:
                delta = np.diff(np.concatenate([[0], data.astype(np.int64)]))
                payload = delta.astype(np.int8).tobytes()
                length = len(data)
                ls = s.get("loop_start", 0)
                ll = s.get("loop_len", 0)
            out += struct.pack(
                "<IIIBbBBbB", length, ls, ll, s.get("volume", 64),
                s.get("finetune", 0),
                (s.get("loop_type", 0) | (0x10 if bits == 16 else 0)),
                s.get("panning", 128), s.get("relative_note", 0), 0,
            )
            out += b"smp".ljust(22, b"\0")
            payloads.append(payload)
        for p in payloads:
            out += p
    return bytes(out)


def cell(note=0, instr=0, vol=0, fx=0, param=0):
    return (note, instr, vol, fx, param)


def empty_rows(rows, channels):
    return [[cell() for _ in range(channels)] for _ in range(rows)]
