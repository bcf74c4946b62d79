"""SILK decode tests (Opus LP layer; reference dopus.d:3815-5378).

Validation layers mirror the CELT suite:
 * offline fixtures with libopus range-coder fingerprints (entropy layer
   bit-exact) and PCM spot values
 * live oracle sweeps vs libopus at the SILK native rate (8/12/16 kHz),
   where the synthesis comparison is resampler-free — observed 45-60 dB
   SNR (limited only by libopus's fixed-point int16 internals)
 * end-to-end Ogg facade at 48 kHz (the polyphase output path), aligned
   with libopus's SILK-path delay
"""

import ctypes

import numpy as np
import pytest

from audio_formats_tpu.models.opus import RangeDecoder, parse_packet
from audio_formats_tpu.models.silk import SilkDecoder

from golden import opus_oracle, opus_ref


def _have_oracle():
    try:
        return opus_oracle.get_lib() is not None
    except Exception:
        return False


needs_oracle = pytest.mark.skipif(not _have_oracle(),
                                  reason="system libopus unavailable")

# ---------------------------------------------------------------- offline

# Four WB 20 ms mono SILK packets (libopus 13 kbps VOIP, AM tone + noise).
SILK_PACKETS = [
    "48839ca46b1d692050011179689fabd7bc0285308061eaa877cf48786d55224c",
    "48b7c52895d3580800677dc9026f38c239b475d884b51e5a54494ff34f0d399b699fee5d671f691feeacc7f8ab2f358700c0b0e6341f4213",
    "48b7bf9a6cc3da05330ba16ef98122d6a31814567c28b45a593c1eaf9bbc8ffb576902",
    "48b7d12a32a80abbbf618d85b957b1044edc14d24d9bc52911a6404deb369326258aadaec8",
]
SILK_RANGES = [0x4A6281E, 0x194445D, 0x1CE8638, 0x5678898]
# native-rate output carries a ONE-sample delay (the libopus mono/stereo
# shared timeline, models/silk.py decode_superframe); the r1-r4 fixture
# was recorded on a two-sample window, so indices moved down by one with
# identical values
SILK_SAMPLE_IDX = [49, 332, 699, 998]
SILK_SAMPLES = [-0.00294011, 0.12073896, 0.08190174, -0.01996817]
SILK_RMS = 0.10663538


def _decode_all(packets):
    dec = SilkDecoder(output_channels=1)
    outs = []
    ranges = []
    for hexpkt in packets:
        info = parse_packet(bytes.fromhex(hexpkt))
        rd = RangeDecoder(info["frames"][0])
        outs.append(dec.decode_superframe(
            rd, info["config"] // 4, 2 if info["stereo"] else 1,
            [10, 20, 40, 60][info["config"] & 3]))
        ranges.append(rd.rng & 0xFFFFFFFF)
    return np.concatenate(outs), ranges


def test_fixture_entropy_bit_exact():
    """Range fingerprints after each packet match libopus exactly: gains,
    NLSF VQ, pitch/LTP, shell-coded excitation all decode bit-for-bit."""
    _, ranges = _decode_all(SILK_PACKETS)
    assert ranges == SILK_RANGES


def test_fixture_pcm():
    out, _ = _decode_all(SILK_PACKETS)
    assert out.shape == (4 * 320, 1)
    assert abs(float(np.sqrt((out ** 2).mean())) - SILK_RMS) < 1e-6
    for i, v in zip(SILK_SAMPLE_IDX, SILK_SAMPLES):
        assert abs(float(out[i, 0]) - v) < 1e-6


def test_lsf2lpc_stability():
    """Every decoded LPC filter must be stable (bounded impulse
    response) — decode the fixtures and check the filters directly."""
    from audio_formats_tpu.models.silk import _lsf2lpc

    # synthetic NLSFs spread across the range
    for seed in range(5):
        rng = np.random.default_rng(seed)
        nlsf = np.sort(rng.integers(100, 32700, 16)).tolist()
        for order in (10, 16):
            a = _lsf2lpc(nlsf[:order], order)
            # impulse response must not blow up
            h = np.zeros(200)
            state = np.zeros(order)
            x = 1.0
            for n in range(200):
                y = x + float(np.dot(a, state))
                state = np.concatenate([[y], state[:-1]])
                h[n] = y
                x = 0.0
            assert np.isfinite(h).all() and np.abs(h[-50:]).max() < 100.0


# ------------------------------------------------------------ oracle sweeps

def _native_sweep(bw_ctl, rate, bwi, voiced, channels=1, bitrate=13000):
    O = opus_oracle
    rng = np.random.default_rng(8)
    N = 960
    t = np.arange(N * 10) / 48000.0
    if voiced:
        base = 6000 * np.sin(2 * np.pi * 220 * t) * \
            (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) + \
            800 * rng.standard_normal(t.size)
    else:
        base = 2500 * rng.standard_normal(t.size)
    if channels == 2:
        sig = np.stack([base, 5000 * np.sin(2 * np.pi * 300 * t) +
                        700 * rng.standard_normal(t.size)], 1)
    else:
        sig = base[:, None]
    sig = np.clip(sig, -32000, 32000).astype(np.int16)
    enc = O.OracleEncoder(48000, channels, bitrate=bitrate,
                          application=O.OPUS_APPLICATION_VOIP,
                          signal=O.OPUS_SIGNAL_VOICE, bandwidth=bw_ctl)
    dec = O.OracleDecoder(rate, channels)
    mine = SilkDecoder(output_channels=channels)
    refs = []
    outs = []
    for n in range(10):
        pkt = enc.encode(sig[n * N : (n + 1) * N])
        info = parse_packet(pkt)
        assert info["config"] < 12  # SILK-only
        ref = dec.decode(pkt)
        fr = ctypes.c_uint32(0)
        dec._lib.opus_decoder_ctl(ctypes.c_void_p(dec._dec), 4031,
                                  ctypes.byref(fr))
        rd = RangeDecoder(info["frames"][0])
        outs.append(mine.decode_superframe(
            rd, info["config"] // 4, 2 if info["stereo"] else 1,
            [10, 20, 40, 60][info["config"] & 3]))
        assert (rd.rng & 0xFFFFFFFF) == fr.value  # entropy bit-exact
        refs.append(ref)
    ref = np.concatenate(refs)
    out = np.concatenate(outs)
    # libopus's SILK path delay at the native rate (measured), minus this
    # decoder's intrinsic delay; one native sample less on the unmix path
    best = -1e9
    for d in range(0, 16):
        err = out[: len(out) - d or None] - ref[d:]
        snr = 10 * np.log10((ref[d:] ** 2).mean() /
                            max(1e-15, (err[100:] ** 2).mean()))
        best = max(best, snr)
    return best


@needs_oracle
@pytest.mark.parametrize("bw_ctl,rate,bwi", [
    (opus_oracle.OPUS_BANDWIDTH_NARROWBAND, 8000, 0),
    (opus_oracle.OPUS_BANDWIDTH_MEDIUMBAND, 12000, 1),
    (opus_oracle.OPUS_BANDWIDTH_WIDEBAND, 16000, 2),
])
@pytest.mark.parametrize("voiced", [True, False])
def test_oracle_native_rate(bw_ctl, rate, bwi, voiced):
    snr = _native_sweep(bw_ctl, rate, bwi, voiced)
    assert snr > 40.0, snr


@needs_oracle
def test_oracle_stereo_native():
    snr = _native_sweep(opus_oracle.OPUS_BANDWIDTH_WIDEBAND, 16000, 2,
                        True, channels=2, bitrate=24000)
    assert snr > 40.0, snr


@needs_oracle
def test_ogg_silk_facade_48k():
    """Full path: Ogg demux -> SILK decode -> polyphase x3 to 48 kHz,
    compared against libopus decoding the same packets at 48 kHz."""
    import audio_formats_tpu as af

    O = opus_oracle
    rng = np.random.default_rng(8)
    N = 960
    t = np.arange(N * 10) / 48000.0
    sig = (6000 * np.sin(2 * np.pi * 220 * t) *
           (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) +
           800 * rng.standard_normal(t.size)).astype(np.int16)[:, None]
    enc = O.OracleEncoder(48000, 1, bitrate=13000,
                          application=O.OPUS_APPLICATION_VOIP,
                          signal=O.OPUS_SIGNAL_VOICE,
                          bandwidth=O.OPUS_BANDWIDTH_WIDEBAND)
    pkts = [(enc.encode(sig[n * N : (n + 1) * N]), N) for n in range(10)]
    dec48 = O.OracleDecoder(48000, 1)
    g = 10.0 ** (-1024 / 5120.0)
    ref = np.concatenate([dec48.decode(p) for p, _ in pkts]) * g
    data = opus_ref.build_ogg_opus(pkts, channels=1, preskip=0)
    st = af.AudioStream()
    st.open_from_memory(data)
    n = st.get_length_in_frames()
    assert n == 9600
    out = st.read_samples_float(n)
    m = min(len(out), len(ref))
    err = out[300 : m - 300] - ref[300 : m - 300]
    snr = 10 * np.log10((ref[300 : m - 300] ** 2).mean() /
                        (err ** 2).mean())
    # aligned at zero shift; the resampler is system-identified from
    # libopus itself (~81 dB, tools/fit_silk_resampler.py), so the level
    # is limited by the native SILK decode accuracy
    assert snr > 45.0, snr
    # sample-accurate seek from the page anchor
    st.seek_position(3000)
    chunk = st.read_samples_float(500)
    assert np.allclose(chunk, out[3000:3500], atol=1e-6)


def test_silk_offline_facade():
    """Offline: fixture packets through the Ogg facade (no libopus)."""
    import audio_formats_tpu as af

    pkts = [(bytes.fromhex(h), 960) for h in SILK_PACKETS]
    data = opus_ref.build_ogg_opus(pkts, channels=1, preskip=0)
    st = af.AudioStream()
    st.open_from_memory(data)
    n = st.get_length_in_frames()
    assert n == 4 * 960
    out = st.read_samples_float(n)
    assert out.shape == (n, 1)
    assert np.isfinite(out).all()
    g = 10.0 ** (-1024 / 5120.0)
    # the 48k output is the fixture PCM upsampled x3 (+gain): compare RMS
    rms = float(np.sqrt((out[200:] ** 2).mean())) / g
    assert abs(rms - SILK_RMS) < 0.02


# ---------------------------------------------------------------- hybrid

@needs_oracle
@pytest.mark.parametrize("bw_ctl,channels,bitrate", [
    (opus_oracle.OPUS_BANDWIDTH_FULLBAND, 1, 36000),
    (opus_oracle.OPUS_BANDWIDTH_SUPERWIDEBAND, 2, 52000),
])
def test_hybrid_facade(bw_ctl, channels, bitrate):
    """Hybrid packets (SILK WB + CELT bands 17+) through the facade."""
    import audio_formats_tpu as af

    O = opus_oracle
    rng = np.random.default_rng(10)
    N = 960
    t = np.arange(N * 8) / 48000.0
    base = (6000 * np.sin(2 * np.pi * 220 * t) *
            (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) +
            2000 * np.sin(2 * np.pi * 5000 * t) +
            600 * rng.standard_normal(t.size))
    if channels == 2:
        sig = np.stack([base, 5000 * np.sin(2 * np.pi * 330 * t)], 1)
    else:
        sig = base[:, None]
    sig = np.clip(sig, -32000, 32000).astype(np.int16)
    enc = O.OracleEncoder(48000, channels, bitrate=bitrate,
                          application=O.OPUS_APPLICATION_VOIP,
                          signal=O.OPUS_SIGNAL_VOICE, bandwidth=bw_ctl)
    pkts = [(enc.encode(sig[n * N : (n + 1) * N]), N) for n in range(8)]
    cfgs = {parse_packet(p)["config"] for p, _ in pkts}
    assert cfgs <= set(range(12, 16)), cfgs  # hybrid configs only
    dec48 = O.OracleDecoder(48000, channels)
    g = 10.0 ** (-1024 / 5120.0)
    ref = np.concatenate([dec48.decode(p) for p, _ in pkts]) * g
    data = opus_ref.build_ogg_opus(pkts, channels=channels, preskip=0)
    st = af.AudioStream()
    st.open_from_memory(data)
    out = st.read_samples_float(st.get_length_in_frames())
    m = min(len(out), len(ref))
    err = out[300 : m - 300] - ref[300 : m - 300]
    snr = 10 * np.log10((ref[300 : m - 300] ** 2).mean() / (err ** 2).mean())
    # the SILK layer rides the libopus-identified resampler; the stereo
    # case is limited by native stereo-SILK accuracy
    assert snr > 25.0, snr


@needs_oracle
def test_mode_switch_tour():
    """SILK -> hybrid -> CELT in one stream stays in sync; post-switch
    CELT packets must match a continuing libopus decode closely."""
    import audio_formats_tpu as af

    O = opus_oracle
    rng = np.random.default_rng(11)
    N = 960
    t = np.arange(N * 4) / 48000.0
    sig = (6000 * np.sin(2 * np.pi * 220 * t) *
           (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) +
           600 * rng.standard_normal(t.size)).astype(np.int16)[:, None]
    packs = []
    for bw, br in ((O.OPUS_BANDWIDTH_WIDEBAND, 13000),
                   (O.OPUS_BANDWIDTH_FULLBAND, 36000)):
        enc = O.OracleEncoder(48000, 1, bitrate=br,
                              application=O.OPUS_APPLICATION_VOIP,
                              signal=O.OPUS_SIGNAL_VOICE, bandwidth=bw)
        packs += [(enc.encode(sig[n * N : (n + 1) * N]), N)
                  for n in range(4)]
    encc = O.OracleEncoder(48000, 1, bitrate=96000,
                           signal=O.OPUS_SIGNAL_MUSIC,
                           bandwidth=O.OPUS_BANDWIDTH_FULLBAND)
    packs += [(encc.encode(sig[n * N : (n + 1) * N]), N) for n in range(4)]
    dec = O.OracleDecoder(48000, 1)
    g = 10.0 ** (-1024 / 5120.0)
    ref = np.concatenate([dec.decode(p) for p, _ in packs]) * g
    st = af.AudioStream()
    st.open_from_memory(opus_ref.build_ogg_opus(packs, channels=1,
                                                preskip=0))
    out = st.read_samples_float(st.get_length_in_frames())
    assert not st.is_error()
    assert np.isfinite(out).all()
    # the last CELT packet (transition long settled) must match closely
    seg = slice(11 * 960 + 100, 12 * 960 - 50)
    err = out[seg] - ref[seg]
    snr = 10 * np.log10((ref[seg] ** 2).mean() / (err ** 2).mean())
    assert snr > 25.0, snr


# ------------------------------------------------------------- multistream

@needs_oracle
def test_multistream_surround_51():
    """Mapping family 1, 5.1 surround: 4 elementary streams (2 coupled),
    self-delimited sub-packet framing, vorbis channel order."""
    import struct

    import audio_formats_tpu as af
    from audio_formats_tpu.io import ogg as aogg

    O = opus_oracle
    lib = O.get_lib()
    lib.opus_multistream_encoder_create.restype = ctypes.c_void_p
    lib.opus_multistream_encoder_create.argtypes = [
        ctypes.c_int32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.opus_multistream_encode.restype = ctypes.c_int32
    lib.opus_multistream_encode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32]
    lib.opus_multistream_decoder_create.restype = ctypes.c_void_p
    lib.opus_multistream_decoder_create.argtypes = [
        ctypes.c_int32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)]
    lib.opus_multistream_decode_float.restype = ctypes.c_int
    lib.opus_multistream_decode_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]

    CH, streams, coupled = 6, 4, 2
    mapping = (ctypes.c_ubyte * CH)(0, 4, 1, 2, 3, 5)
    err = ctypes.c_int(0)
    enc = lib.opus_multistream_encoder_create(
        48000, CH, streams, coupled, mapping, 2049, ctypes.byref(err))
    assert err.value == 0
    lib.opus_multistream_encoder_ctl(ctypes.c_void_p(enc), 4002, 256000)
    rng = np.random.default_rng(3)
    N, npkt = 960, 6
    t = np.arange(N * npkt) / 48000.0
    sig = np.stack(
        [np.clip(6000 * np.sin(2 * np.pi * (200 + 100 * c) * t) +
                 400 * rng.standard_normal(t.size), -32000, 32000)
         for c in range(CH)], 1).astype(np.int16)
    pkts = []
    for n in range(npkt):
        block = np.ascontiguousarray(sig[n * N : (n + 1) * N])
        out = np.zeros(8000, np.uint8)
        ln = lib.opus_multistream_encode(
            ctypes.c_void_p(enc),
            block.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), N,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size)
        assert ln > 0
        pkts.append((bytes(out[:ln]), N))
    dec = lib.opus_multistream_decoder_create(
        48000, CH, streams, coupled, mapping, ctypes.byref(err))
    refs = []
    for p, _ in pkts:
        buf = (ctypes.c_uint8 * len(p)).from_buffer_copy(p)
        o = np.zeros(5760 * CH, np.float32)
        n = lib.opus_multistream_decode_float(
            ctypes.c_void_p(dec),
            ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), len(p),
            o.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 5760, 0)
        refs.append(o[: n * CH].reshape(n, CH))
    ref = np.concatenate(refs)

    head = (b"OpusHead" + bytes([1, CH]) + struct.pack("<H", 312) +
            struct.pack("<I", 48000) + struct.pack("<h", 0) + bytes([1]) +
            bytes([streams, coupled]) + bytes(mapping))
    vendor = b"af-ref"
    tags = (b"OpusTags" + struct.pack("<I", len(vendor)) + vendor +
            struct.pack("<I", 0))
    serial = 99
    pages = [aogg.build_page([head], serial, 0, 0, bos=True),
             aogg.build_page([tags], serial, 1, 0)]
    g = 0
    seq = 2
    for i, (p, n) in enumerate(pkts):
        g += n
        pages.append(aogg.build_page([p], serial, seq, g,
                                     eos=(i == len(pkts) - 1)))
        seq += 1
    st = af.AudioStream()
    st.open_from_memory(b"".join(pages))
    assert st.get_num_channels() == CH
    out = st.read_samples_float(st.get_length_in_frames())
    refc = ref[312:]
    m = min(len(out), len(refc))
    errv = out[300 : m - 300] - refc[300 : m - 300]
    snr = 10 * np.log10((refc[300 : m - 300] ** 2).mean() /
                        (errv ** 2).mean())
    assert snr > 60.0, snr


@needs_oracle
def test_silk_stereo_batch_equals_facade():
    """Stereo SILK streams through the lockstep batch group (the batched
    device conv resampler) vs the single-stream facade."""
    import audio_formats_tpu as af
    from audio_formats_tpu.parallel import BatchDecoder

    O = opus_oracle
    rng = np.random.default_rng(5)
    N = 960
    t = np.arange(N * 8) / 48000.0
    sig = np.stack([
        6000 * np.sin(2 * np.pi * 220 * t) + 700 * rng.standard_normal(t.size),
        5000 * np.sin(2 * np.pi * 300 * t) + 700 * rng.standard_normal(t.size),
    ], 1)
    sig = np.clip(sig, -32000, 32000).astype(np.int16)
    enc = O.OracleEncoder(48000, 2, bitrate=48000,
                          application=O.OPUS_APPLICATION_VOIP,
                          signal=O.OPUS_SIGNAL_VOICE,
                          bandwidth=O.OPUS_BANDWIDTH_WIDEBAND)
    pkts = []
    for n in range(8):
        pkt = enc.encode(sig[n * N : (n + 1) * N])
        info = parse_packet(pkt)
        if info["config"] >= 12 or len(info["frames"]) != 1:
            pytest.skip("encoder did not produce single-frame SILK packets")
        pkts.append((pkt, N))
    streams = [opus_ref.build_ogg_opus(pkts, channels=2, preskip=312),
               opus_ref.build_ogg_opus(pkts[:5], channels=2, preskip=312)]
    dec = BatchDecoder(streams)
    got = dec.decode_all()
    assert dec.stats["windows"] >= 5
    for data, g in zip(streams, got):
        st = af.AudioStream()
        st.open_from_memory(data)
        n = st.get_length_in_frames()
        ref = st.read_samples_float(n)
        assert g.shape == ref.shape
        peak = np.abs(ref).max() + 1e-9
        assert np.abs(g - ref).max() / peak < 1e-5


@needs_oracle
@pytest.mark.parametrize("channels", [1, 2])
def test_hybrid_batch_equals_facade(channels):
    """Hybrid packets through the lockstep group (batched SILK conv +
    bucketed CELT IMDCT + the facade's own FIFO/redundancy helpers) vs
    the per-stream facade, mono and stereo, ragged lengths."""
    import audio_formats_tpu as af
    from audio_formats_tpu.parallel import BatchDecoder

    O = opus_oracle
    rng = np.random.default_rng(12)
    N = 960
    t = np.arange(N * 8) / 48000.0
    base = (6000 * np.sin(2 * np.pi * 220 * t) *
            (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) +
            2000 * np.sin(2 * np.pi * 5000 * t) +
            600 * rng.standard_normal(t.size))
    sig = np.stack([base, 5000 * np.sin(2 * np.pi * 330 * t)], 1) \
        if channels == 2 else base[:, None]
    sig = np.clip(sig, -32000, 32000).astype(np.int16)
    enc = O.OracleEncoder(48000, channels, bitrate=28000 * channels,
                          application=O.OPUS_APPLICATION_VOIP,
                          signal=O.OPUS_SIGNAL_VOICE,
                          bandwidth=O.OPUS_BANDWIDTH_SUPERWIDEBAND)
    pkts = [(enc.encode(sig[n * N : (n + 1) * N]), N) for n in range(8)]
    cfgs = {parse_packet(p)["config"] for p, _ in pkts}
    if not cfgs <= set(range(12, 16)) or len(cfgs) != 1:
        pytest.skip(f"encoder did not emit uniform hybrid packets: {cfgs}")
    streams = [opus_ref.build_ogg_opus(pkts, channels=channels, preskip=0),
               opus_ref.build_ogg_opus(pkts[:5], channels=channels,
                                       preskip=120)]
    dec = BatchDecoder(streams)
    got = dec.decode_all()
    assert dec.stats["windows"] >= 5 and dec.stats["group_demotions"] == 0
    for data, g in zip(streams, got):
        st = af.AudioStream()
        st.open_from_memory(data)
        ref = st.read_samples_float(st.get_length_in_frames())
        assert g.shape == ref.shape
        peak = np.abs(ref).max() + 1e-9
        assert np.abs(g - ref).max() / peak < 1e-5


@needs_oracle
def test_mode_switch_batch_equals_facade():
    """A mode-switching stream (SILK -> CELT -> SILK -> hybrid, the
    common VBR speech+music shape) rides the mixed-mode lockstep group
    (batch.py _decode_opus_mixed_group) with zero demotions, matching
    the per-stream facade: the group replays the facade's own packet
    generator, so transitions/redundancy cannot diverge
    (dopus.d:6400)."""
    import audio_formats_tpu as af
    from audio_formats_tpu.parallel import BatchDecoder

    O = opus_oracle
    lib = O.get_lib()
    rng = np.random.default_rng(21)
    N = 960
    npkt = 12
    t = np.arange(N * npkt) / 48000.0
    sig = (6000 * np.sin(2 * np.pi * 220 * t) *
           (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) +
           2500 * np.sin(2 * np.pi * 4500 * t) +
           600 * rng.standard_normal(t.size))
    sig = np.clip(sig, -32000, 32000).astype(np.int16)[:, None]
    enc = O.OracleEncoder(48000, 1, bitrate=24000,
                          application=O.OPUS_APPLICATION_AUDIO)
    # OPUS_SET_FORCE_MODE (opus_private.h, exposed through the public
    # ctl vararg entry in release builds): MODE_SILK_ONLY=1000,
    # MODE_HYBRID=1001, MODE_CELT_ONLY=1002
    FORCE_MODE = 11002
    seq = [1000, 1000, 1000, 1002, 1002, 1002,
           1000, 1000, 1001, 1001, 1002, 1000]
    bw = {1000: O.OPUS_BANDWIDTH_WIDEBAND,
          1001: O.OPUS_BANDWIDTH_SUPERWIDEBAND,
          1002: O.OPUS_BANDWIDTH_FULLBAND}
    pkts = []
    for n in range(npkt):
        lib.opus_encoder_ctl(ctypes.c_void_p(enc._enc),
                             O.OPUS_SET_BANDWIDTH, bw[seq[n]])
        lib.opus_encoder_ctl(ctypes.c_void_p(enc._enc),
                             FORCE_MODE, seq[n])
        pkts.append((enc.encode(sig[n * N : (n + 1) * N]), N))
    modes = {parse_packet(p)["mode"] for p, _ in pkts}
    if len(modes) < 2:
        pytest.skip(f"encoder refused to switch modes: {modes}")
    streams = [opus_ref.build_ogg_opus(pkts, channels=1, preskip=312),
               opus_ref.build_ogg_opus(pkts[:7], channels=1, preskip=120)]
    dec = BatchDecoder(streams)
    got = dec.decode_all()
    assert dec.stats.get("opus_mixed_lanes", 0) == 2
    assert dec.stats["group_demotions"] == 0
    for data, g in zip(streams, got):
        st = af.AudioStream()
        st.open_from_memory(data)
        ref = st.read_samples_float(st.get_length_in_frames())
        assert g.shape == ref.shape
        peak = np.abs(ref).max() + 1e-9
        assert np.abs(g - ref).max() / peak < 1e-5


@needs_oracle
def test_hybrid_eos_drain_includes_celt_fifo():
    """The EOS drain must carry the hybrid CELT delay FIFO (and any
    unfinished redundancy fade) into the drained tail — not just the
    SILK resampler flush (dopus.d:6424-6466 delayed-samples timeline).
    Without it the final `delayed` samples of a hybrid stream lose the
    CELT layer entirely (measured ~24 dB tail SNR vs libopus; with the
    FIFO ~33 dB).  Facade and batch must agree."""
    import audio_formats_tpu as af
    from audio_formats_tpu.models.opus import parse_packet as _pp
    from audio_formats_tpu.parallel import BatchDecoder

    O = opus_oracle
    rng = np.random.default_rng(5)
    N = 960
    t = np.arange(N * 8) / 48000.0
    sig = (6000 * np.sin(2 * np.pi * 220 * t) *
           (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) +
           2000 * np.sin(2 * np.pi * 5000 * t) +
           700 * rng.standard_normal(t.size))
    sig = np.clip(sig, -32000, 32000).astype(np.int16)[:, None]
    enc = O.OracleEncoder(48000, 1, bitrate=36000,
                          application=O.OPUS_APPLICATION_VOIP,
                          signal=O.OPUS_SIGNAL_VOICE,
                          bandwidth=O.OPUS_BANDWIDTH_FULLBAND)
    pkts = [(enc.encode(sig[n * N : (n + 1) * N]), N) for n in range(8)]
    if not {_pp(p)["config"] for p, _ in pkts} <= set(range(12, 16)):
        pytest.skip("encoder did not emit hybrid packets")
    dec48 = O.OracleDecoder(48000, 1)
    g = 10.0 ** (-1024 / 5120.0)
    ref = np.concatenate([dec48.decode(p) for p, _ in pkts]) * g
    data = opus_ref.build_ogg_opus(pkts, channels=1, preskip=0)
    st = af.AudioStream()
    st.open_from_memory(data)
    got = st.read_samples_float(st.get_length_in_frames())
    m = min(len(got), len(ref))
    tail = slice(m - 300, m)
    err = got[tail] - ref[tail]
    snr = 10 * np.log10((ref[tail] ** 2).mean()
                        / max(1e-20, (err ** 2).mean()))
    assert snr > 28.0, f"tail SNR {snr:.1f} dB (CELT FIFO dropped?)"
    bat = BatchDecoder([data]).decode_all()[0]
    assert bat.shape == got.shape
    peak = np.abs(got).max() + 1e-9
    assert np.abs(bat - got).max() / peak < 1e-5


@needs_oracle
def test_silk_redundancy_tail_lane_demotes():
    """A SILK packet with an unconsumed tail (the facade decodes it as a
    mode-transition CELT redundancy frame, opus.py SILK-only branch /
    dopus.d:6340) cannot ride the lockstep SILK group: the lane must
    demote to the facade path and still match it exactly, while clean
    lanes stay grouped."""
    import audio_formats_tpu as af
    from audio_formats_tpu.parallel import BatchDecoder

    O = opus_oracle
    rng = np.random.default_rng(9)
    N = 960
    t = np.arange(N * 6) / 48000.0
    sig = np.clip(6000 * np.sin(2 * np.pi * 220 * t)
                  + 700 * rng.standard_normal(t.size),
                  -32000, 32000).astype(np.int16)[:, None]
    enc = O.OracleEncoder(48000, 1, bitrate=24000,
                          application=O.OPUS_APPLICATION_VOIP,
                          signal=O.OPUS_SIGNAL_VOICE,
                          bandwidth=O.OPUS_BANDWIDTH_WIDEBAND)
    pkts = []
    for n in range(6):
        pkt = enc.encode(sig[n * N : (n + 1) * N])
        info = parse_packet(pkt)
        if info["config"] >= 12 or len(info["frames"]) != 1:
            pytest.skip("encoder did not produce single-frame SILK packets")
        pkts.append((pkt, N))
    # graft a fake redundancy tail onto packet 3 of stream B (extra
    # bytes after the SILK payload read as the redundancy region)
    tweaked = list(pkts)
    tweaked[3] = (tweaked[3][0] + bytes(8), N)
    streams = [opus_ref.build_ogg_opus(pkts, channels=1, preskip=312),
               opus_ref.build_ogg_opus(tweaked, channels=1, preskip=312),
               opus_ref.build_ogg_opus(pkts[:4], channels=1, preskip=312)]
    dec = BatchDecoder(streams)
    got = dec.decode_all()
    for data, g in zip(streams, got):
        st = af.AudioStream()
        st.open_from_memory(data)
        ref = st.read_samples_float(st.get_length_in_frames())
        if g is None:
            assert st.is_error()
            continue
        assert g.shape == ref.shape
        peak = np.abs(ref).max() + 1e-9
        assert np.abs(g - ref).max() / peak < 1e-5


@needs_oracle
def test_multistream_silk_eos_drain():
    """5.1 SILK multistream: the EOS drain must flush EVERY substream's
    resampler through the channel map (not repeat stream 0's columns),
    so the final `delayed` samples of all 6 channels stay correct and
    the stream reaches its granule-declared length."""
    import struct

    import audio_formats_tpu as af
    from audio_formats_tpu.io import ogg as aogg

    O = opus_oracle
    lib = O.get_lib()
    lib.opus_multistream_encoder_create.restype = ctypes.c_void_p
    lib.opus_multistream_encoder_create.argtypes = [
        ctypes.c_int32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.opus_multistream_encode.restype = ctypes.c_int32
    lib.opus_multistream_encode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32]
    lib.opus_multistream_decoder_create.restype = ctypes.c_void_p
    lib.opus_multistream_decoder_create.argtypes = [
        ctypes.c_int32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)]
    lib.opus_multistream_decode_float.restype = ctypes.c_int
    lib.opus_multistream_decode_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]

    CH, streams, coupled = 6, 4, 2
    mapping = (ctypes.c_ubyte * CH)(0, 4, 1, 2, 3, 5)
    err = ctypes.c_int(0)
    enc = lib.opus_multistream_encoder_create(
        48000, CH, streams, coupled, mapping, 2048, ctypes.byref(err))
    assert err.value == 0
    lib.opus_multistream_encoder_ctl(ctypes.c_void_p(enc), 4002, 48000)
    lib.opus_multistream_encoder_ctl(ctypes.c_void_p(enc), 4024, 3001)
    lib.opus_multistream_encoder_ctl(ctypes.c_void_p(enc), 4008, 1103)
    rng = np.random.default_rng(3)
    N, npkt = 960, 6
    t = np.arange(N * npkt) / 48000.0
    sig = np.stack(
        [np.clip(6000 * np.sin(2 * np.pi * (200 + 90 * c) * t)
                 * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
                 + 300 * rng.standard_normal(t.size), -32000, 32000)
         for c in range(CH)], 1).astype(np.int16)
    pkts = []
    for n in range(npkt):
        block = np.ascontiguousarray(sig[n * N : (n + 1) * N])
        out = np.zeros(8000, np.uint8)
        ln = lib.opus_multistream_encode(
            ctypes.c_void_p(enc),
            block.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), N,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size)
        assert ln > 0
        pkts.append((bytes(out[:ln]), N))
    if parse_packet(pkts[2][0])["mode"] != "silk":
        pytest.skip("encoder did not choose SILK for the substreams")
    dec = lib.opus_multistream_decoder_create(
        48000, CH, streams, coupled, mapping, ctypes.byref(err))
    refs = []
    for p, _ in pkts:
        buf = (ctypes.c_uint8 * len(p)).from_buffer_copy(p)
        o = np.zeros(5760 * CH, np.float32)
        n = lib.opus_multistream_decode_float(
            ctypes.c_void_p(dec),
            ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), len(p),
            o.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 5760, 0)
        refs.append(o[: n * CH].reshape(n, CH))
    ref = np.concatenate(refs)
    head = (b"OpusHead" + bytes([1, CH]) + struct.pack("<H", 312) +
            struct.pack("<I", 48000) + struct.pack("<h", 0) + bytes([1]) +
            bytes([streams, coupled]) + bytes(mapping))
    vendor = b"af-ref"
    tags = (b"OpusTags" + struct.pack("<I", len(vendor)) + vendor +
            struct.pack("<I", 0))
    pages = [aogg.build_page([head], 99, 0, 0, bos=True),
             aogg.build_page([tags], 99, 1, 0)]
    g, seq = 0, 2
    for i, (p, n) in enumerate(pkts):
        g += n
        pages.append(aogg.build_page([p], 99, seq, g,
                                     eos=(i == npkt - 1)))
        seq += 1
    st = af.AudioStream()
    st.open_from_memory(b"".join(pages))
    out = st.read_samples_float(st.get_length_in_frames())
    assert out.shape[0] == N * npkt - 312  # reaches granule length
    refc = ref[312:]
    m = min(len(out), len(refc))
    tail = slice(m - 300, m)
    e = out[tail] - refc[tail]
    snr = 10 * np.log10((refc[tail] ** 2).mean()
                        / max(1e-20, (e ** 2).mean()))
    assert snr > 40.0, f"tail SNR {snr:.1f} dB (per-stream drain broken?)"


def test_corrupt_granule_drain_is_bounded():
    """A corrupt last-page granule declaring an absurd stream length must
    neither materialize the declared remainder (MemoryError out of the
    public API) nor zero-fill toward it forever under a read-until-empty
    consumer: the EOS drain is bounded by the resamplers' OWED tail, so
    the stream simply ends early — facade AND batch."""
    import audio_formats_tpu as af
    from audio_formats_tpu.parallel import BatchDecoder
    from golden import opus_ref

    pkts = [(bytes.fromhex(h), 960) for h in SILK_PACKETS]
    data = opus_ref.build_ogg_opus(pkts, channels=1, preskip=0,
                                   final_granule=1 << 40)
    st = af.AudioStream()
    st.open_from_memory(data)
    assert not st.is_error(), st.error_message()
    total = 0
    for _ in range(8):
        out = st.read_samples_float(65536)
        assert np.isfinite(out).all()
        if out.shape[0] == 0:
            break
        total += out.shape[0]
    # content + a small resampler tail, then EOS — no endless zero-fill
    n_content = len(pkts) * 960
    assert n_content <= total <= n_content + 4096
    # the batch lattice path must stay bounded too (this drives the
    # mixed/SILK group drains)
    res = BatchDecoder([data]).decode_all()
    assert res[0] is None or (
        np.isfinite(np.asarray(res[0])).all()
        and res[0].shape[0] <= n_content + 4096)
