"""BatchDecoder: batched lockstep decode must equal the single-stream facade
bit-for-bit, with per-lane error isolation."""

import numpy as np

from audio_formats_tpu import AudioStream
from audio_formats_tpu.parallel import BatchDecoder

from golden import flac_ref, mp3_ref, qoa_ref, wav_ref


def _facade(data, frames=10**6):
    s = AudioStream().open_from_memory(data)
    assert not s.is_error(), s.error_message()
    return s.read_samples_float(frames)


def _mp3(rng, n_frames=5, channels=1):
    qs = []
    for _ in range(2 * n_frames):
        q = np.zeros(576, np.int64)
        idx = rng.choice(380, size=40, replace=False)
        q[idx] = rng.integers(-30, 31, size=40)
        qs.append(q)
    frames = []
    for i in range(0, 2 * n_frames, 2):
        frames.append([
            [{"q": qs[i]} for _ in range(channels)],
            [{"q": qs[i + 1]} for _ in range(channels)],
        ])
    return mp3_ref.build_mp3(frames, channels=channels)


def _flac(rng, frames=5000, stereo="mid_side"):
    t = np.arange(frames)[:, None]
    pcm = np.clip(
        np.round(9000 * np.sin(2 * np.pi * 300 * t * [1, 1.4] / 44100)
                 + 300 * rng.standard_normal((frames, 2))),
        -32768, 32767,
    ).astype(np.int64)
    return flac_ref.build_flac(pcm, 44100, 16, block_size=1024,
                               stereo_mode=stereo, modes=["lpc8", "fixed3"])


def test_mp3_batch_equals_facade(rng):
    streams = [_mp3(rng, n_frames=3 + i) for i in range(5)]  # ragged lengths
    batch = BatchDecoder(streams).decode_all()
    for data, got in zip(streams, batch):
        ref = _facade(data)
        assert got.shape == ref.shape
        # float pipeline: XLA reduction order differs between the facade's
        # per-granule DSP and the batch scan-free matmul/Toeplitz forms
        scale = np.max(np.abs(ref)) + 1e-9
        assert np.max(np.abs(got - ref)) / scale < 4e-6


def test_flac_batch_equals_facade(rng):
    streams = [_flac(rng, frames=4000 + 997 * i) for i in range(4)]
    batch = BatchDecoder(streams).decode_all()
    for data, got in zip(streams, batch):
        ref = _facade(data)
        np.testing.assert_array_equal(got, ref)


def test_mixed_formats_concurrent_groups(rng, monkeypatch):
    """Format groups decoding on concurrent threads
    (AF_TPU_GROUP_THREADS=2, the multi-core-host default) must produce
    exactly the sequential outputs — disjoint lane sets, locked stats."""
    monkeypatch.setenv("AF_TPU_GROUP_THREADS", "1")
    items = [_mp3(rng), _flac(rng, 3000), _mp3(rng), _flac(rng, 2500)]
    ref = BatchDecoder(items).decode_all()
    monkeypatch.setenv("AF_TPU_GROUP_THREADS", "2")
    dec = BatchDecoder(items)
    got = dec.decode_all()
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    assert dec.stats["decoded_seconds"] > 0
    assert dec.stats["windows"] > 0


def test_mixed_formats_and_error_isolation(rng):
    s16 = np.clip(
        np.round(12000 * np.sin(2 * np.pi * 440 * np.arange(3000) / 44100)),
        -32768, 32767,
    ).astype(np.int64)
    qoa_data = qoa_ref.encode(s16.reshape(-1, 1).astype(np.int16), 44100)
    wav_data = wav_ref.build_wav(wav_ref.pack_pcm(s16, 16), fmt_tag=1,
                                 channels=1, sample_rate=44100, bits=16)
    items = [
        _mp3(rng), b"NOT AUDIO" * 10, _flac(rng, 3000), qoa_data, wav_data,
    ]
    dec = BatchDecoder(items)
    out = dec.decode_all()
    assert out[1] is None and dec.errors[1] is not None
    for i in (2, 3, 4):  # FLAC/QOA/WAV integer paths: bit-exact
        assert out[i] is not None
        ref = _facade(items[i])
        np.testing.assert_array_equal(out[i], ref)
    ref0 = _facade(items[0])  # MP3 float path: tight relative
    assert out[0].shape == ref0.shape
    assert np.max(np.abs(out[0] - ref0)) / (np.max(np.abs(ref0)) + 1e-9) < 1e-6
    assert dec.stats["decoded_seconds"] > 0


def test_batch_layer2_matches_facade(rng):
    """Layer I/II streams bypass the Layer III lockstep group (they ride
    their own subband group) and still decode correctly."""
    from golden import mp3_ref

    gq = rng.integers(0, 16, size=(3, 3, 30, 12)).tolist()
    scfs = rng.integers(0, 60, size=(3, 30)).tolist()
    data, _ = mp3_ref.build_mp3_l2(gq, scfs, ba=4)
    s = AudioStream()
    s.open_from_memory(data)
    ref = s.read_samples_float(10 ** 6)
    out = np.asarray(BatchDecoder([data]).decode_all()[0])
    assert out.shape == ref.shape
    # same einsum, different batch shape: reduction order differs
    peak = np.abs(ref).max() + 1e-9
    assert np.abs(out - ref).max() / peak < 4e-6


def test_flac_wasted_bits_overflow_rejected():
    """A subframe claiming wasted >= bps must raise AudioFormatError, not a
    bare ValueError from a negative shift (reference behavior is a decode
    error, drflac.d wasted-bits handling)."""
    import pytest

    from audio_formats_tpu.errors import AudioFormatError
    from audio_formats_tpu.io.bits import BitReaderMSB
    from audio_formats_tpu.models.flac import FlacDecoder

    # subframe header: type CONSTANT, wasted flag set (0x01), then a unary
    # run of 16 zeros + stop bit -> wasted = 17 >= bps 16
    bits = bytes([0x01, 0x00, 0x00, 0x80, 0x00, 0x00, 0x00])
    b = BitReaderMSB(bits)
    with pytest.raises(AudioFormatError):
        FlacDecoder._parse_subframe.__get__(object.__new__(FlacDecoder))(
            b, 256, 16
        )


def test_group_failure_demotes_to_per_stream(rng, monkeypatch):
    """A failure inside a lockstep group path must not abort the batch: the
    group's lanes demote to the per-stream fallback and still decode
    (the per-lane error lattice)."""
    streams = [_flac(rng, 3000 + 577 * i) for i in range(3)]
    dec = BatchDecoder(streams)

    def boom(decs, nch):
        raise RuntimeError("device path exploded")

    monkeypatch.setattr(dec, "_decode_flac_group", boom)
    out = dec.decode_all()
    for data, got in zip(streams, out):
        ref = _facade(data)
        np.testing.assert_array_equal(got, ref)
    assert all(e is None for e in dec.errors)


def test_device_resident_output_equals_numpy(rng):
    """decode_all(output="device") keeps PCM on the accelerator; its
    to_numpy() must equal the numpy path exactly, and the per-stage stats
    split must be populated (SURVEY.md §5 observability)."""
    streams = [_mp3(rng, n_frames=4), _flac(rng, 5000), _flac(rng, 3000)]
    ref = BatchDecoder(streams).decode_all()
    dec = BatchDecoder(streams)
    res = dec.decode_all(output="device")
    res.sync()
    got = res.to_numpy()
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
    assert dec.stats["windows"] > 0
    assert dec.stats["h2d_bytes"] > 0
    assert dec.stats["host_ms"] > 0
    assert dec.stats["decoded_seconds"] > 0
    assert set(dec.stats["decoded_seconds_by_format"]) == {"mp3", "flac"}


def test_qoa_batched_group_bit_exact(rng):
    """QOA lanes decode through the frame-parallel device group (LMS state
    is in-band, qoa.d:488-503) and must equal the facade bit-for-bit,
    including short final frames and stereo."""
    from golden import qoa_ref

    streams = []
    for i in range(4):
        n = 4000 + 3333 * i  # exercises short final frames
        ch = 2 if i % 2 else 1
        t = np.arange(n)[:, None]
        x = np.clip(np.round(
            11000 * np.sin(2 * np.pi * (200 + 60 * i) * t
                           * ([1, 1.3] if ch == 2 else [1]) / 44100)
            + 500 * rng.standard_normal((n, ch))), -32768, 32767
        ).astype(np.int16)
        streams.append(qoa_ref.encode(x, 44100))
    dec = BatchDecoder(streams)
    out = dec.decode_all()
    for data, got in zip(streams, out):
        ref = _facade(data)
        np.testing.assert_array_equal(got, ref)
    assert dec.stats["decoded_seconds_by_format"].get("qoa", 0) > 0
    assert dec.stats["windows"] > 0


def test_wav_batched_group_bit_exact(rng):
    """WAV integer-PCM lanes batch as concatenated flat device calls and
    must equal the facade bit-for-bit (u8/s16/s24 kinds, ragged lengths)."""
    from golden import wav_ref

    streams = []
    for bits in (8, 16, 24):
        for k in range(2):
            n = 2000 + 777 * k
            x = np.clip(np.round(
                (2 ** (bits - 1) - 1) * 0.7
                * np.sin(2 * np.pi * 300 * np.arange(n) / 44100)),
                -(2 ** (bits - 1)), 2 ** (bits - 1) - 1).astype(np.int64)
            if bits == 8:
                x = x + 128  # u8 storage
            streams.append(wav_ref.build_wav(
                wav_ref.pack_pcm(x, bits), fmt_tag=1, channels=1,
                sample_rate=44100, bits=bits))
    dec = BatchDecoder(streams)
    out = dec.decode_all()
    for data, got in zip(streams, out):
        ref = _facade(data)
        np.testing.assert_array_equal(got, ref)
    assert dec.stats["decoded_seconds_by_format"].get("wav", 0) > 0


def test_vorbis_batched_group_equals_facade(rng):
    """Vorbis lanes decode via the lockstep group (host entropy + batched
    device IMDCT + host lap) and must match the facade, including mixed
    long/short windows and ragged lane lengths."""
    from golden import vorbis_ref

    streams = []
    for i in range(3):
        fix = vorbis_ref.Fixture(channels=1, bs0=512, bs1=2048)
        count = 6 + 2 * i
        pattern = [(j // 2) % 2 for j in range(count)]
        frames = []
        ch = fix.channels
        for j in range(count):
            lb = bool(pattern[j])
            n2 = (fix.bs1 if lb else fix.bs0) // 2
            posts = [[int(rng.integers(40, 100)) for _ in range(4)]]
            r = np.zeros(n2)
            idx = rng.choice(n2, size=n2 // 4, replace=False)
            r[idx] = rng.integers(-5, 6, size=idx.size) * fix.vq_delta
            prev_long = bool(pattern[j - 1]) if j > 0 else True
            next_long = bool(pattern[j + 1]) if j + 1 < count else True
            frames.append(fix.audio_packet(
                posts, [r], long_block=lb,
                prev_flag=1 if prev_long else 0,
                next_flag=1 if next_long else 0))
        streams.append(fix.build(frames))
    dec = BatchDecoder(streams)
    out = dec.decode_all()
    for data, got in zip(streams, out):
        ref = _facade(data)
        assert got.shape == ref.shape
        peak = np.abs(ref).max() + 1e-9
        assert np.abs(got - ref).max() / peak < 4e-6
    assert dec.stats["decoded_seconds_by_format"].get("vorbis", 0) > 0


def test_vorbis_device_resident_group_equals_facade(rng):
    """output="device": Vorbis windowing (IMDCT + lapped OLA) runs entirely
    on device with carried lap state (ops/vorbis_win) and PCM stays
    device-resident; to_numpy() must match the facade, including mixed
    long/short windows, stereo coupling, and ragged lane lengths."""
    from golden import vorbis_ref

    streams = []
    for i in range(3):
        ch = 2 if i == 2 else 1
        fix = vorbis_ref.Fixture(channels=ch, bs0=512, bs1=2048,
                                 coupling=(ch == 2))
        count = 6 + 2 * i
        pattern = [(j // 2) % 2 for j in range(count)]
        frames = []
        for j in range(count):
            lb = bool(pattern[j])
            n2 = (fix.bs1 if lb else fix.bs0) // 2
            posts = [[int(rng.integers(40, 100)) for _ in range(4)]
                     for _ in range(ch)]
            rs = []
            for _c in range(ch):
                r = np.zeros(n2)
                idx = rng.choice(n2, size=n2 // 4, replace=False)
                r[idx] = rng.integers(-5, 6, size=idx.size) * fix.vq_delta
                rs.append(r)
            prev_long = bool(pattern[j - 1]) if j > 0 else True
            next_long = bool(pattern[j + 1]) if j + 1 < count else True
            frames.append(fix.audio_packet(
                posts, rs, long_block=lb,
                prev_flag=1 if prev_long else 0,
                next_flag=1 if next_long else 0))
        streams.append(fix.build(frames))
    dec = BatchDecoder(streams)
    res = dec.decode_all(output="device")
    assert dec.stats["d2h_bytes"] == 0, "device mode must not download"
    out = res.to_numpy()
    for data, got in zip(streams, out):
        ref = _facade(data)
        assert got.shape == ref.shape
        peak = np.abs(ref).max() + 1e-9
        assert np.abs(got - ref).max() / peak < 4e-6
    assert dec.stats["decoded_seconds_by_format"].get("vorbis", 0) > 0


def test_mixed_batch_no_per_stream_fallback(rng, monkeypatch):
    """A mixed MP3/FLAC/QOA/WAV/Vorbis batch must decode entirely through
    the device groups: the per-stream fallback (decoder.read) must never
    run (SURVEY §2.4 uniform-dispatch requirement)."""
    from golden import qoa_ref, vorbis_ref, wav_ref

    s16 = np.clip(np.round(
        11000 * np.sin(2 * np.pi * 440 * np.arange(4000) / 44100)),
        -32768, 32767).astype(np.int64)
    fix = vorbis_ref.Fixture(channels=1)
    posts = [[60, 70, 80, 90]]
    r = np.zeros(fix.bs0 // 2)
    r[rng.choice(len(r), 40, replace=False)] = \
        rng.integers(-5, 6, 40) * fix.vq_delta
    vorbis_data = fix.build([fix.audio_packet(posts, [r])
                             for _ in range(5)])
    items = [
        _mp3(rng, n_frames=4, channels=2),
        # multi-window ragged FLAC: the last window's smaller lane bucket
        # caught a worker-closure capture bug once — keep it ragged
        _flac(rng, 30000),
        _flac(rng, 4000),
        qoa_ref.encode(s16.reshape(-1, 1).astype(np.int16), 44100),
        wav_ref.build_wav(wav_ref.pack_pcm(s16, 16), fmt_tag=1,
                          channels=1, sample_rate=44100, bits=16),
        vorbis_data,
    ]
    dec = BatchDecoder(items)
    for d in dec.decoders:
        monkeypatch.setattr(
            type(d), "read",
            lambda self, *a, **k: (_ for _ in ()).throw(
                AssertionError("per-stream fallback used")),
        )
    out = dec.decode_all()
    assert dec.stats["group_demotions"] == 0
    for data, got in zip(items, out):
        assert got is not None and got.shape[0] > 0
    assert set(dec.stats["decoded_seconds_by_format"]) >= \
        {"mp3", "flac", "qoa", "wav", "vorbis"}


def test_flac_split_width_plane_matches_plain(rng, monkeypatch):
    """The split residual upload (pack-small + raw overflow plane merged
    by flac_merge_overflow) must stay bit-exact vs the plain max-width
    packing.  Test windows are too small to trigger the split on cost,
    so force a tiny packed width: the loud lanes overflow into the raw
    plane while quiet ones stay packed."""
    from audio_formats_tpu.parallel import batch as batch_mod

    streams = [_flac(rng, frames=4000 + 997 * i) for i in range(3)]
    ref = BatchDecoder(streams).decode_all()

    def forced(w_l, wmax, Ln, bs):
        assert wmax > 4
        return 4, 512
    monkeypatch.setattr(batch_mod, "_flac_width_plan", forced)
    got = BatchDecoder(streams).decode_all()
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_flac_width_plan_cost_model():
    from audio_formats_tpu.parallel.batch import _flac_width_plan

    bs = 4096
    w_l = np.full(512, 9, np.int32)
    w_l[:6] = 25                 # heavy tail forces bucket 26 when plain
    wb, lb = _flac_width_plan(w_l, 25, 512, bs)
    assert (wb, lb) == (10, 128)
    wb, lb = _flac_width_plan(np.full(512, 9, np.int32), 9, 512, bs)
    assert (wb, lb) == (10, 0)
    # tiny windows: padding beats a whole raw plane
    wb, lb = _flac_width_plan(np.full(8, 25, np.int32), 25, 8, bs)
    assert lb == 0 and wb == 26


def test_flac_24bit_batch_equals_facade(rng):
    """>16 bps FLAC lanes batch through the exact int32-limb LPC path
    instead of falling back to the per-stream loop."""
    t = np.arange(6000)[:, None]
    pcm = np.clip(
        np.round(2_000_000 * np.sin(2 * np.pi * 220 * t * [1, 1.3] / 44100)
                 + 50_000 * rng.standard_normal((6000, 2))),
        -(1 << 23), (1 << 23) - 1,
    ).astype(np.int64)
    data = flac_ref.build_flac(pcm, 44100, 24, block_size=1024,
                               stereo_mode="left_side",
                               modes=["lpc8", "fixed2"])
    got = BatchDecoder([data]).decode_all()[0]
    ref = _facade(data)
    np.testing.assert_array_equal(got, ref)


def test_silk_batch_equals_facade():
    """SILK-only Opus lanes batch: host entropy+synth per lane, ONE device
    polyphase conv per packet step (BatchedFittedUpsampler).  Ragged
    lengths exercise the early per-lane EOS drain."""
    from test_opus_silk import SILK_PACKETS
    from golden import opus_ref

    pkts = [(bytes.fromhex(h), 960) for h in SILK_PACKETS]
    streams = [
        opus_ref.build_ogg_opus(pkts, channels=1, preskip=0),
        opus_ref.build_ogg_opus(pkts[:3], channels=1, preskip=0),
        opus_ref.build_ogg_opus(pkts[:2], channels=1, preskip=100),
    ]
    dec = BatchDecoder(streams)
    got = dec.decode_all()
    assert dec.stats["windows"] >= 4  # the conv path actually ran
    for data, g in zip(streams, got):
        ref = _facade(data)
        assert g.shape == ref.shape
        peak = np.abs(ref).max() + 1e-9
        # facade resamples per-lane in f64; the batched conv runs f32
        assert np.abs(g - ref).max() / peak < 1e-5


def test_profile_trace_capture(rng, monkeypatch, tmp_path):
    """AF_TPU_PROFILE records the scheduler's stage spans as Chrome-trace
    JSON (SURVEY §5.1): the file materializes, spans cover every stage
    that reported time, and the decode result is unchanged."""
    import json

    data = _flac(rng, 3000)
    ref = BatchDecoder([data]).decode_all()[0]
    path = tmp_path / "trace.json"
    monkeypatch.setenv("AF_TPU_PROFILE", str(path))
    dec = BatchDecoder([data])
    got = dec.decode_all()[0]
    np.testing.assert_array_equal(got, ref)
    tr = json.loads(path.read_text())
    names = {e["name"] for e in tr["traceEvents"]}
    assert "host" in names and "enqueue" in names
    total = sum(e["dur"] for e in tr["traceEvents"]
                if e["name"] == "host") / 1e3
    assert abs(total - dec.stats["host_ms"]) < 1.0


def test_layer12_batch_equals_facade(rng):
    """Layer I/II lanes batch through the lockstep subband group (one
    synthesis FIR per window) instead of the per-stream loop."""
    streams = []
    for n_frames in (3, 7):
        gq = rng.integers(0, 16, size=(n_frames, 3, 30, 12)).tolist()
        scfs = rng.integers(0, 60, size=(n_frames, 30)).tolist()
        streams.append(mp3_ref.build_mp3_l2(gq, scfs, ba=4)[0])
    for n_frames in (4, 2):
        gq = rng.integers(0, 64, size=(n_frames, 32, 12)).tolist()
        scfs = rng.integers(0, 60, size=(n_frames, 32)).tolist()
        streams.append(mp3_ref.build_mp3_l1(gq, scfs, ba=6)[0])
    dec = BatchDecoder(streams)
    got = dec.decode_all()
    assert dec.stats["group_demotions"] == 0
    for data, g in zip(streams, got):
        ref = _facade(data)
        assert g.shape == ref.shape
        peak = np.abs(ref).max() + 1e-9
        # same einsum, different batch shape: XLA reduction order differs
        assert np.abs(g - ref).max() / peak < 4e-6


def test_opus_celt_batch_equals_facade():
    """CELT-only Opus lanes through the lockstep group vs the facade
    (completes batch==facade coverage across the decode formats)."""
    from test_opus_celt import PACKETS
    from golden import opus_ref

    pkts = [(bytes.fromhex(h), 480) for h in PACKETS]
    streams = [opus_ref.build_ogg_opus(pkts, channels=1, preskip=130),
               opus_ref.build_ogg_opus(pkts[:2], channels=1, preskip=0)]
    got = BatchDecoder(streams).decode_all()
    for data, g in zip(streams, got):
        ref = _facade(data)
        assert g.shape == ref.shape
        peak = np.abs(ref).max() + 1e-9
        assert np.abs(g - ref).max() / peak < 1e-5


def test_module_batch_equals_facade(rng):
    """MOD/XM modules decode through BatchDecoder (per-stream synthesis
    engines — inherently sequential tracker playback) identically to the
    facade, mixed with device-group formats in one batch."""
    from golden import mod_ref, xm_ref

    pat = mod_ref.empty_pattern()
    pat[0][0] = mod_ref.cell(sample=1, period=428, effect=0, param=0)
    mod_data = mod_ref.build_mod(
        [pat], [0], [(mod_ref.saw_sample(64), 64, 0, 0, 64)])
    xm_data = _xm_fixture(rng)
    streams = [mod_data, xm_data, _flac(rng, 3000)]
    got = BatchDecoder(streams).decode_all()
    for data, g in zip(streams, got):
        # modules are length-fuzzy by reference design (XM reads zero-pad
        # to the requested count, stream.d:604) -> chunk like the batch
        s = AudioStream().open_from_memory(data)
        chunks = []
        while True:
            c = s.read_samples_float(1 << 16)
            if len(c) == 0:
                break
            chunks.append(np.asarray(c))
        ref = np.concatenate(chunks)
        assert g.shape == ref.shape
        np.testing.assert_allclose(g, ref, rtol=0, atol=1e-7)


def _xm_fixture(rng):
    from golden import xm_ref
    import importlib.util as _iu

    spec = _iu.spec_from_file_location(
        "txm", __file__.replace("test_batch.py", "test_xm.py"))
    m = _iu.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m._simple_xm(rows=16)


def test_silk_multiframe_packets_batch():
    """Code-3 VBR SILK packets (several 20 ms frames per packet — common
    VoIP packing) ride the lockstep group too."""
    from test_opus_silk import SILK_PACKETS
    from golden import opus_ref

    singles = [bytes.fromhex(h) for h in SILK_PACKETS]
    toc = singles[0][0] & 0xFC  # same config, code 0 -> rebuild as code 3
    pkts = []
    for a, b in zip(singles[::2], singles[1::2]):
        fa, fb = a[1:], b[1:]
        assert len(fa) < 252 and len(fb) < 252
        pkt = bytes([toc | 3, 0x80 | 2, len(fa)]) + fa + fb
        pkts.append((pkt, 2 * 960))
    streams = [opus_ref.build_ogg_opus(pkts, channels=1, preskip=0),
               opus_ref.build_ogg_opus(pkts[:1], channels=1, preskip=0)]
    dec = BatchDecoder(streams)
    got = dec.decode_all()
    assert dec.stats["windows"] >= 2  # lockstep conv ran
    for data, g in zip(streams, got):
        ref = _facade(data)
        assert g.shape == ref.shape
        peak = np.abs(ref).max() + 1e-9
        assert np.abs(g - ref).max() / peak < 1e-5


def test_ogg_flac_batch_equals_facade(rng):
    """Ogg-encapsulated FLAC rides the same batch group (the decoder's
    frame cursor works over the reassembled packet stream) bit-exactly,
    with zero demotions."""
    from golden import flac_ref
    from audio_formats_tpu.io import ogg as oggmod

    frames = 3000
    t = np.arange(frames)[:, None]
    pcm = np.clip(np.round(
        9000 * np.sin(2 * np.pi * 300 * t * [1, 1.4] / 44100)
        + 300 * rng.standard_normal((frames, 2))),
        -32768, 32767).astype(np.int64)
    native = flac_ref.build_flac(pcm, 44100, 16, block_size=1024,
                                 stereo_mode="left_side",
                                 modes=["lpc4", "fixed2"])
    pos = 4
    while True:
        hdr = int.from_bytes(native[pos : pos + 4], "big")
        pos += 4 + (hdr & 0xFFFFFF)
        if hdr >> 31:
            break
    header_pkt = (b"\x7fFLAC" + bytes([1, 0]) + (0).to_bytes(2, "big")
                  + native[:pos])
    body = native[pos:]
    pages = [oggmod.build_page([header_pkt], serial=42, seq=0, granule=0,
                               bos=True)]
    seq = 1
    for i in range(0, len(body), 4000):
        pages.append(oggmod.build_page(
            [body[i : i + 4000]], serial=42, seq=seq,
            granule=frames if i + 4000 >= len(body) else 0,
            eos=i + 4000 >= len(body)))
        seq += 1
    data = b"".join(pages)
    dec = BatchDecoder([data])
    out = dec.decode_all()[0]
    assert dec.stats["group_demotions"] == 0
    np.testing.assert_array_equal(out, _facade(data))


def test_fresh_format_thread_boost_matches_serial(rng, monkeypatch):
    """First sight of a format kind in a process boosts group threads to
    overlap device-program loads (cold latency); outputs must equal the
    forced-serial decode and the seen-set must disarm the boost after."""
    monkeypatch.delenv("AF_TPU_GROUP_THREADS", raising=False)
    s16 = np.clip(
        np.round(11000 * np.sin(2 * np.pi * 330 * np.arange(2500) / 44100)),
        -32768, 32767,
    ).astype(np.int64)
    qoa_data = qoa_ref.encode(s16.reshape(-1, 1).astype(np.int16), 44100)
    wav_data = wav_ref.build_wav(wav_ref.pack_pcm(s16, 16), fmt_tag=1,
                                 channels=1, sample_rate=44100, bits=16)
    # 4 distinct group kinds -> the widest boost (conc = min(4, jobs))
    items = [_mp3(rng), _flac(rng, 3000), qoa_data, wav_data,
             _mp3(rng), _flac(rng, 2500)]
    monkeypatch.setenv("AF_TPU_GROUP_THREADS", "1")
    ref = BatchDecoder(items).decode_all()
    monkeypatch.delenv("AF_TPU_GROUP_THREADS", raising=False)
    seen = BatchDecoder._SEEN_GROUP_KINDS
    monkeypatch.setattr(BatchDecoder, "_SEEN_GROUP_KINDS", set())
    got = BatchDecoder(items).decode_all()   # boost path (all kinds fresh)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    assert {"_decode_mp3_group", "_decode_flac_group",
            "_decode_qoa_group", "_decode_wav_group"} <= \
        BatchDecoder._SEEN_GROUP_KINDS
    BatchDecoder._SEEN_GROUP_KINDS |= seen   # restore for other tests
