"""Opus: range-decoder roundtrip vs the RFC range encoder, packet TOC
parsing, Ogg-Opus container metadata/duration/preskip, silence decode,
seek, and the documented coded-audio gap."""

import numpy as np
import pytest

from audio_formats_tpu import AudioFileFormat, AudioStream
from audio_formats_tpu.models.opus import RangeDecoder, parse_packet

from golden import opus_ref


# ---------------------------------------------------------------------------
# Range coder roundtrip
# ---------------------------------------------------------------------------

def test_range_coder_roundtrip_symbols(rng):
    for trial in range(20):
        n = int(rng.integers(5, 60))
        fts = rng.integers(2, 300, size=n)
        symbols = [int(rng.integers(0, ft)) for ft in fts]
        enc = opus_ref.RangeEncoder(256)
        for s, ft in zip(symbols, fts):
            enc.encode(s, s + 1, int(ft))
        data = enc.done()
        dec = RangeDecoder(data)
        for s, ft in zip(symbols, fts):
            got = dec.decode(int(ft))
            assert got == s
            dec.update(got, got + 1, int(ft))


def test_range_coder_bit_logp_and_icdf(rng):
    icdf = [200, 150, 100, 50, 20, 0]  # 8-bit inverse CDF
    for trial in range(10):
        bits = [int(rng.integers(0, 2)) for _ in range(30)]
        logps = [int(rng.integers(1, 14)) for _ in range(30)]
        syms = [int(rng.integers(0, len(icdf))) for _ in range(12)]
        enc = opus_ref.RangeEncoder(256)
        for b, lp in zip(bits, logps):
            enc.enc_bit_logp(b, lp)
        for s in syms:
            enc.enc_icdf(s, icdf, 8)
        data = enc.done()
        dec = RangeDecoder(data)
        for b, lp in zip(bits, logps):
            assert dec.dec_bit_logp(lp) == b
        for s in syms:
            assert dec.dec_icdf(icdf, 8) == s


def test_range_coder_uint_and_raw_bits(rng):
    for trial in range(10):
        uints = [(int(rng.integers(0, ft)), int(ft))
                 for ft in rng.integers(2, 100000, size=15)]
        raws = [(int(rng.integers(0, 1 << b)), int(b))
                for b in rng.integers(1, 20, size=10)]
        enc = opus_ref.RangeEncoder(512)
        for v, ft in uints:
            enc.enc_uint(v, ft)
        for v, b in raws:
            enc.enc_bits(v, b)
        data = enc.done()
        dec = RangeDecoder(data)
        for v, ft in uints:
            assert dec.dec_uint(ft) == v
        for v, b in raws:
            assert dec.dec_bits(b) == v


# ---------------------------------------------------------------------------
# Packet TOC
# ---------------------------------------------------------------------------

def test_toc_codes():
    # code 0: single frame
    p = parse_packet(bytes([17 << 3]) + b"abc")
    assert p["mode"] == "celt" and p["frame_size"] == 240
    assert p["frames"] == [b"abc"]
    # code 1: two equal frames
    p = parse_packet(bytes([(17 << 3) | 1]) + b"abcd")
    assert p["frames"] == [b"ab", b"cd"]
    # code 2: two frames, explicit first length
    p = parse_packet(bytes([(17 << 3) | 2, 2]) + b"abcde")
    assert p["frames"] == [b"ab", b"cde"]
    # code 3 CBR: 3 frames
    p = parse_packet(bytes([(16 << 3) | 3, 3]) + b"abcdef")
    assert p["frames"] == [b"ab", b"cd", b"ef"]
    # code 3 VBR with padding
    p = parse_packet(bytes([(16 << 3) | 3, 0xC2, 1, 1]) + b"abcdZ")
    assert p["frames"] == [b"a", b"bcd"]
    # SILK/hybrid configs
    assert parse_packet(bytes([0]) + b"x")["mode"] == "silk"
    assert parse_packet(bytes([12 << 3]) + b"x")["mode"] == "hybrid"
    assert parse_packet(bytes([15 << 3]) + b"x")["frame_size"] == 960
    assert parse_packet(bytes([14 << 3]) + b"x")["frame_size"] == 480
    # stereo flag
    assert parse_packet(bytes([(17 << 3) | 4]) + b"x")["stereo"] == 1


# ---------------------------------------------------------------------------
# Container end-to-end (silence streams)
# ---------------------------------------------------------------------------

def _silence_stream(n_packets=20, preskip=312, **kw):
    packets = [opus_ref.silence_packet() for _ in range(n_packets)]
    return opus_ref.build_ogg_opus(packets, preskip=preskip, **kw), packets


def test_container_metadata_and_silence_decode():
    data, packets = _silence_stream()
    s = AudioStream().open_from_memory(data)
    assert not s.is_error(), s.error_message()
    assert s.get_format() == AudioFileFormat.opus
    assert s.get_samplerate() == 48000.0  # always 48 kHz (dopus.d:7954)
    assert s.get_num_channels() == 1
    total = sum(n for _, n in packets) - 312  # preskip excluded
    assert s.get_length_in_frames() == total
    out = s.read_samples_float(10**6)
    assert out.shape == (total, 1)
    assert np.all(out == 0)
    assert s._decoder.r128_track_gain_q8 == -1024


def test_dtx_and_final_truncation():
    packets = [opus_ref.silence_packet(), opus_ref.dtx_packet(),
               opus_ref.silence_packet()]
    total = sum(n for _, n in packets)
    data = opus_ref.build_ogg_opus(packets, preskip=100,
                                   final_granule=total - 50)
    s = AudioStream().open_from_memory(data)
    assert not s.is_error()
    assert s.get_length_in_frames() == total - 50 - 100
    out = s.read_samples_float(10**6)
    assert out.shape[0] == total - 50 - 100


def test_seek_contract_silence():
    data, packets = _silence_stream(n_packets=30)
    s = AudioStream().open_from_memory(data)
    L = s.get_length_in_frames()
    assert s.tell_position() == 0
    assert not s.seek_position(-1)
    assert not s.seek_position(L + 1)
    assert s.seek_position(L - 1)
    assert s.read_samples_float(10).shape[0] == 1
    assert s.seek_position(L)
    assert s.read_samples_float(10).shape[0] == 0
    for target in (0, 1, 500, 1921, 3000):
        assert s.seek_position(target), target
        assert s.tell_position() == target
    assert not s.is_error()


def test_coded_celt_audio_decodes():
    # a CELT frame with the silence bit CLEAR decodes as coded audio
    # (band decode implemented; models/celt.py)
    enc = opus_ref.RangeEncoder(16)
    enc.enc_bit_logp(0, 15)
    enc.enc_bits(0x2A, 6)
    frame = enc.done()
    pkt = bytes([17 << 3]) + frame
    data = opus_ref.build_ogg_opus([(pkt, 240)], preskip=100)
    s = AudioStream().open_from_memory(data)
    out = s.read_samples_float(200)
    assert not s.is_error()
    assert out.shape[0] == 140  # 240 - preskip
    assert np.all(np.isfinite(out))


def test_coded_silk_reports_clear_error():
    # SILK-only packets (config 0) are the remaining gap: clear error
    pkt = bytes([0 << 3]) + b"\x42" * 10
    data = opus_ref.build_ogg_opus([(pkt, 480)], preskip=100)
    s = AudioStream().open_from_memory(data)
    assert not s.is_error()
    out = s.read_samples_float(100)
    assert out.shape[0] == 0
    assert s.is_error()
    assert "not yet supported" in s.error_message()


def test_mapping_family2_channel_count_guard():
    """Ambisonic (mapping family 2) streams must have (n+1)^2 channels;
    the reference rejects anything else (dopus.d:1348-1352)."""
    import struct

    from audio_formats_tpu.io import ogg as aogg

    def _stream(channels, streams=1, coupled=0, cmap=None):
        cmap = cmap if cmap is not None else list(range(channels))
        head = (b"OpusHead" + bytes([1, channels]) +
                struct.pack("<H", 0) + struct.pack("<I", 48000) +
                struct.pack("<h", 0) + bytes([2]) +
                bytes([streams, coupled]) + bytes(cmap))
        vendor = b"af-ref"
        tags = (b"OpusTags" + struct.pack("<I", len(vendor)) + vendor +
                struct.pack("<I", 0))
        pkt, n = opus_ref.silence_packet()
        return b"".join([
            aogg.build_page([head], 7, 0, 0, bos=True),
            aogg.build_page([tags], 7, 1, 0),
            aogg.build_page([pkt], 7, 2, n, eos=True),
        ])

    # 3 channels is not (n+1)^2: the reference's clear error
    s = AudioStream()
    s.open_from_memory(_stream(3, cmap=[0, 0, 0]))
    assert s.is_error()
    assert "(n+1)^2" in s.error_message()

    # 1 channel == (0+1)^2: opens and decodes
    ok = AudioStream()
    ok.open_from_memory(_stream(1))
    assert not ok.is_error(), ok.error_message()
    out = ok.read_samples_float(ok.get_length_in_frames())
    assert not ok.is_error()
    assert out.shape[1] == 1


def test_bad_page_crc_skipped():
    """A page whose CRC fails is rejected and skipped, matching the
    reference's Opus page validation (dopus.d:7080-7084); the rest of the
    stream still decodes."""
    data, packets = _silence_stream(n_packets=20, preskip=0)
    st = AudioStream()
    st.open_from_memory(data)
    clean = st.read_samples_float(st.get_length_in_frames())

    # corrupt one byte inside a mid-file page body (capture pattern and
    # header left intact so only the CRC check can reject it)
    buf = bytearray(data)
    pos = data.index(b"OggS", len(data) // 2)
    buf[pos + 40] ^= 0x5A
    st2 = AudioStream()
    st2.open_from_memory(bytes(buf))
    out = st2.read_samples_float(st2.get_length_in_frames())
    assert not st2.is_error()
    assert out.shape[0] < clean.shape[0]  # the bad page's audio is gone
