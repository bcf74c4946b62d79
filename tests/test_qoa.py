"""QOA conformance: bit-exact decode & encode vs the independent golden
model, streaming reads, O(1) seek, and the probe/encode round-trip."""

import numpy as np
import pytest

from audio_formats_tpu import (
    AudioFileFormat,
    AudioStream,
    EncodingOptions,
)
from audio_formats_tpu.ops import lms as lms_ops

from golden import qoa_ref


def _sig(frames, channels, rng, amp=0.7):
    """Band-limited-ish but LMS-stressing test signal in s16."""
    t = np.arange(frames)[:, None]
    f = 220.0 * (1 + np.arange(channels))[None, :]
    x = amp * np.sin(2 * np.pi * f * t / 44100.0)
    x += 0.1 * rng.standard_normal((frames, channels))
    return np.clip(np.round(x * 20000), -32768, 32767).astype(np.int16)


def test_tables_match_spec_literals():
    np.testing.assert_array_equal(
        lms_ops.DEQUANT_TAB, np.array(qoa_ref.DEQUANT_TAB, np.int32)
    )
    np.testing.assert_array_equal(
        lms_ops.SCALEFACTOR_TAB, np.array(qoa_ref.SCALEFACTOR_TAB, np.int32)
    )
    np.testing.assert_array_equal(
        lms_ops.RECIPROCAL_TAB, np.array(qoa_ref.RECIPROCAL_TAB, np.int32)
    )
    np.testing.assert_array_equal(
        lms_ops.QUANT_TAB, np.array(qoa_ref.QUANT_TAB, np.int32)
    )


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("frames", [123, 5120, 5121, 7000])
def test_decode_bit_exact_vs_golden(rng, channels, frames):
    s16 = _sig(frames, channels, rng)
    data = qoa_ref.encode(s16, 44100)
    golden, rate = qoa_ref.decode(data)
    assert rate == 44100

    s = AudioStream().open_from_memory(data)
    assert not s.is_error(), s.error_message()
    assert s.get_format() == AudioFileFormat.qoa
    assert s.get_length_in_frames() == frames
    assert s.get_num_channels() == channels
    out = s.read_samples_float(frames + 100)
    assert out.shape == (frames, channels)
    # float output == s16 * f32(1/32767) (qoa.d:825)
    ref = golden.astype(np.float32) * (np.float32(1.0) / np.float32(32767.0))
    np.testing.assert_array_equal(out, ref)


def test_chunked_equals_whole(rng):
    s16 = _sig(11000, 2, rng)
    data = qoa_ref.encode(s16, 44100)
    whole = AudioStream().open_from_memory(data).read_samples_float(11000)
    s = AudioStream().open_from_memory(data)
    parts = []
    while True:
        c = s.read_samples_float(777)
        if c.shape[0] == 0:
            break
        parts.append(c)
    np.testing.assert_array_equal(np.concatenate(parts), whole)


def test_seek_contract(rng):
    frames = 6000  # crosses a frame boundary (5120)
    s16 = _sig(frames, 1, rng)
    data = qoa_ref.encode(s16, 44100)
    s = AudioStream().open_from_memory(data)
    L = s.get_length_in_frames()
    assert s.tell_position() == 0
    assert s.seek_position(0)
    assert not s.seek_position(-1)
    assert not s.seek_position(L + 1)
    assert s.seek_position(L - 1)
    assert s.read_samples_float(10).shape[0] == 1
    assert s.seek_position(L)
    assert s.read_samples_float(10).shape[0] == 0
    assert not s.is_error()
    # mid-file seek lands sample-accurately (incl. into second frame)
    whole = AudioStream().open_from_memory(data).read_samples_float(frames)
    for target in (1, 19, 20, 2500, 5119, 5120, 5500):
        assert s.seek_position(target), target
        assert s.tell_position() == target
        got = s.read_samples_float(32)
        np.testing.assert_array_equal(got, whole[target : target + 32])


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("frames", [60, 5120, 5130, 10240])
def test_encode_byte_exact_vs_golden(rng, channels, frames):
    s16 = _sig(frames, channels, rng)
    ref_bytes = qoa_ref.encode(s16, 44100)

    x = s16.astype(np.float64) / 32767.0  # exact: quantizes back to s16
    s = AudioStream().open_to_buffer(AudioFileFormat.qoa, 44100, channels)
    assert not s.is_error()
    s.write_samples_double(x)
    got = s.finalize_and_get_encoded_result()
    assert got == ref_bytes


def test_encode_chunked_writes_byte_exact(rng):
    s16 = _sig(8000, 2, rng)
    ref_bytes = qoa_ref.encode(s16, 48000)
    x = s16.astype(np.float64) / 32767.0
    s = AudioStream().open_to_buffer(AudioFileFormat.qoa, 48000, 2)
    for i in range(0, 8000, 300):
        s.write_samples_double(x[i : i + 300])
    assert s.finalize_and_get_encoded_result() == ref_bytes


def test_roundtrip_via_own_encoder(rng):
    """Encode with the framework, decode with the framework AND the golden
    decoder: all three byte/sample paths must agree."""
    frames = 5200
    s16 = _sig(frames, 2, rng)
    x = s16.astype(np.float64) / 32767.0
    s = AudioStream().open_to_buffer(AudioFileFormat.qoa, 44100, 2)
    s.write_samples_double(x)
    data = s.finalize_and_get_encoded_result()

    golden, _ = qoa_ref.decode(data)
    out = AudioStream().open_from_memory(data).read_samples_float(frames)
    ref = golden.astype(np.float32) * (np.float32(1.0) / np.float32(32767.0))
    np.testing.assert_array_equal(out, ref)
    # lossy but close on this signal
    err = out - x.astype(np.float32)
    assert np.max(np.abs(err)) < 0.15


def test_float_input_quantization_matches_double(rng):
    """float32 staged input must quantize identically to the double path
    (device TwoSum rounding vs host f64)."""
    x32 = (rng.random(4096, dtype=np.float32) * 2 - 1).reshape(-1, 1)
    a = AudioStream().open_to_buffer(AudioFileFormat.qoa, 44100, 1)
    a.write_samples_float(x32)
    b = AudioStream().open_to_buffer(AudioFileFormat.qoa, 44100, 1)
    b.write_samples_double(x32.astype(np.float64))
    assert (
        a.finalize_and_get_encoded_result()
        == b.finalize_and_get_encoded_result()
    )


def test_probe_rejects_corrupt_magic():
    s = AudioStream().open_from_memory(b"qoaX" + b"\0" * 32)
    assert s.is_error()


def test_lms_scan_matches_golden_lms():
    """The device LMS decode scan equals the golden per-sample predictor
    and sign-sign update (qoa_ref.Lms), wraparound included."""
    import numpy as np

    from golden import qoa_ref

    rng = np.random.default_rng(7)
    L, T = 9, 641
    history = rng.integers(-32768, 32768, (L, 4)).astype(np.int32)
    weights = rng.integers(-(1 << 14), 1 << 14, (L, 4)).astype(np.int32)
    deq = rng.integers(-2000, 2000, (L, T)).astype(np.int32)
    got = np.asarray(lms_ops.qoa_decode_scan(history, weights, deq))
    for lane in range(L):
        lms = qoa_ref.Lms()
        lms.history = [int(v) for v in history[lane]]
        lms.weights = [int(v) for v in weights[lane]]
        ref = []
        for r in deq[lane]:
            s = qoa_ref._clamp_s16(lms.predict() + int(r))
            lms.update(s, int(r))
            ref.append(s)
        np.testing.assert_array_equal(got[lane], ref)
