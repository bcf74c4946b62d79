"""FLAC decode conformance.  FLAC is lossless, so decoding a golden-encoder
file must reproduce the source PCM bit-exactly (after drflac's s32 alignment
and double-scaling to float, which we replicate)."""

import numpy as np
import pytest

from audio_formats_tpu import AudioFileFormat, AudioStream
from audio_formats_tpu.ops import lpc as lpc_ops

from golden import flac_ref


def _pcm(frames, channels, bps, rng, smooth=True):
    lim = 1 << (bps - 1)
    if smooth:
        t = np.arange(frames)[:, None]
        x = 0.6 * np.sin(2 * np.pi * 313.0 * (1 + np.arange(channels))[None, :] * t / 44100.0)
        x += 0.05 * rng.standard_normal((frames, channels))
        return np.clip(np.round(x * (lim * 0.8)), -lim, lim - 1).astype(np.int64)
    return rng.integers(-lim, lim, size=(frames, channels)).astype(np.int64)


def _expected_float(pcm, bps):
    s32 = (pcm.astype(np.int64) << (32 - bps)).astype(np.int32)
    return (s32.astype(np.float64) * (1.0 / 2147483647.0)).astype(np.float32)


def _decode(data, frames):
    s = AudioStream().open_from_memory(data)
    assert not s.is_error(), s.error_message()
    assert s.get_format() == AudioFileFormat.flac
    return s, s.read_samples_float(frames + 64)


@pytest.mark.parametrize("mode", ["constant", "verbatim", "fixed0", "fixed1",
                                  "fixed2", "fixed3", "fixed4", "lpc1",
                                  "lpc4", "lpc8", "lpc32"])
def test_subframe_types_bit_exact(rng, mode):
    frames, bps = 768, 16
    if mode == "constant":
        pcm = np.full((frames, 1), -1234, dtype=np.int64)
    elif mode == "verbatim":
        pcm = _pcm(frames, 1, bps, rng, smooth=False)
    else:
        pcm = _pcm(frames, 1, bps, rng)
    data = flac_ref.build_flac(pcm, 44100, bps, block_size=256,
                               modes=[mode])
    s, out = _decode(data, frames)
    assert s.get_length_in_frames() == frames
    np.testing.assert_array_equal(out, _expected_float(pcm, bps))


@pytest.mark.parametrize("stereo", ["independent", "left_side", "right_side",
                                    "mid_side"])
def test_stereo_modes_bit_exact(rng, stereo):
    frames, bps = 1024, 16
    pcm = _pcm(frames, 2, bps, rng)
    data = flac_ref.build_flac(pcm, 48000, bps, block_size=512,
                               stereo_mode=stereo, modes=["fixed2", "fixed2"])
    s, out = _decode(data, frames)
    assert s.get_num_channels() == 2
    assert s.get_samplerate() == 48000.0
    np.testing.assert_array_equal(out, _expected_float(pcm, bps))


@pytest.mark.parametrize("bps", [8, 12, 16, 20, 24])
def test_bit_depths_bit_exact(rng, bps):
    frames = 512
    pcm = _pcm(frames, 2, bps, rng)
    data = flac_ref.build_flac(pcm, 44100, bps, block_size=256,
                               modes=["fixed1", "lpc2"])
    s, out = _decode(data, frames)
    np.testing.assert_array_equal(out, _expected_float(pcm, bps))


def test_rice2_and_partitions(rng):
    frames, bps = 2048, 16
    pcm = _pcm(frames, 1, bps, rng)
    data = flac_ref.build_flac(pcm, 44100, bps, block_size=1024,
                               modes=["fixed2"], partition_order=3,
                               rice2=True)
    _, out = _decode(data, frames)
    np.testing.assert_array_equal(out, _expected_float(pcm, bps))


def test_escape_partitions(rng):
    frames, bps = 512, 16
    pcm = _pcm(frames, 1, bps, rng)
    data = flac_ref.build_flac(pcm, 44100, bps, block_size=256,
                               modes=["fixed1"], escape_bits=18)
    _, out = _decode(data, frames)
    np.testing.assert_array_equal(out, _expected_float(pcm, bps))


def test_wasted_bits(rng):
    frames, bps = 512, 16
    pcm = _pcm(frames, 2, bps - 3, rng) << 3  # 3 wasted bits per sample
    data = flac_ref.build_flac(pcm, 44100, bps, block_size=256,
                               modes=["fixed2", "lpc2"], wasted=3)
    _, out = _decode(data, frames)
    np.testing.assert_array_equal(out, _expected_float(pcm, bps))


def test_24bit_lpc_needs_64bit_path(rng):
    """bps>16 routes through the exact int64 predictor (drflac.d:1101)."""
    frames, bps = 768, 24
    pcm = _pcm(frames, 2, bps, rng)
    data = flac_ref.build_flac(pcm, 96000, bps, block_size=256,
                               stereo_mode="mid_side", modes=["lpc8", "lpc8"])
    _, out = _decode(data, frames)
    np.testing.assert_array_equal(out, _expected_float(pcm, bps))


def test_chunked_equals_whole(rng):
    frames = 3000
    pcm = _pcm(frames, 2, 16, rng)
    data = flac_ref.build_flac(pcm, 44100, 16, block_size=1024,
                               stereo_mode="left_side", modes=["fixed2", "fixed3"])
    whole = AudioStream().open_from_memory(data).read_samples_float(frames)
    s = AudioStream().open_from_memory(data)
    parts = []
    while True:
        c = s.read_samples_float(389)
        if c.shape[0] == 0:
            break
        parts.append(c)
    np.testing.assert_array_equal(np.concatenate(parts), whole)


@pytest.mark.parametrize("seektable", [False, True])
def test_seek_contract(rng, seektable):
    frames = 5000
    pcm = _pcm(frames, 1, 16, rng)
    data = flac_ref.build_flac(pcm, 44100, 16, block_size=1024,
                               modes=["fixed2"], seektable=seektable)
    s = AudioStream().open_from_memory(data)
    L = s.get_length_in_frames()
    assert L == frames
    assert s.tell_position() == 0
    assert s.seek_position(0)
    assert not s.seek_position(-1)
    assert not s.seek_position(L + 1)
    assert s.seek_position(L - 1)
    assert s.read_samples_float(10).shape[0] == 1
    assert s.seek_position(L)  # end: always succeeds (stream.d:1123-1125)
    assert s.read_samples_float(10).shape[0] == 0
    assert not s.is_error()
    whole = AudioStream().open_from_memory(data).read_samples_float(frames)
    for target in (1, 1023, 1024, 2500, 4999, 100):
        assert s.seek_position(target), target
        assert s.tell_position() == target
        got = s.read_samples_float(16)
        np.testing.assert_array_equal(got, whole[target : target + 16])


def test_device_lpc_matches_int64_oracle(rng):
    """Device int32 scan == exact int64 host model on safe inputs."""
    L, B = 8, 512
    order = rng.integers(1, 33, size=L).astype(np.int32)
    shift = rng.integers(0, 15, size=L).astype(np.int32)
    coeffs = np.zeros((L, 32), np.int32)
    for l in range(L):
        coeffs[l, : order[l]] = rng.integers(-(1 << 10), 1 << 10, size=order[l])
    residual = rng.integers(-(1 << 12), 1 << 12, size=(L, B)).astype(np.int32)
    got = np.asarray(lpc_ops.flac_lpc_scan(residual, coeffs, order, shift))
    ref = lpc_ops.flac_lpc_np(residual, coeffs, order, shift)
    # int64 result may exceed int32 in contrived cases; mask lanes that stay
    # in range (valid FLAC files are in range by construction).
    in_range = (np.abs(ref).max(axis=1) < 2**31).nonzero()[0]
    assert in_range.size > 0
    np.testing.assert_array_equal(got[in_range], ref[in_range].astype(np.int32))


def test_truncated_and_garbage():
    s = AudioStream().open_from_memory(b"fLaC\x00\x00\x00")
    assert s.is_error()
    rng = np.random.default_rng(0)
    pcm = _pcm(1000, 1, 16, rng)
    data = flac_ref.build_flac(pcm, 44100, 16, block_size=512, modes=["fixed2"])
    s = AudioStream().open_from_memory(data[: len(data) // 2])
    if not s.is_error():
        out = s.read_samples_float(1000)
        assert out.shape[0] < 1000  # short read, no crash


def test_ogg_encapsulated_flac(rng):
    """Ogg-FLAC (drflac.d:2196): mapping header packet + frame packets."""
    from audio_formats_tpu.io import ogg as oggmod
    frames = 3000
    pcm = _pcm(frames, 2, 16, rng)
    native = flac_ref.build_flac(pcm, 44100, 16, block_size=1024,
                                 stereo_mode="left_side",
                                 modes=["lpc4", "fixed2"])
    # split the native stream into (metadata, frames...) packets
    import struct
    pos = 4
    while True:
        hdr = int.from_bytes(native[pos : pos + 4], "big")
        size = hdr & 0xFFFFFF
        last = hdr >> 31
        pos += 4 + size
        if last:
            break
    header_pkt = b"\x7fFLAC" + bytes([1, 0]) + (0).to_bytes(2, "big") + native[:pos]
    # one packet per FLAC frame: frames start with 0xFF F8 sync
    body = native[pos:]
    starts = [i for i in range(len(body) - 1)
              if body[i] == 0xFF and (body[i + 1] & 0xFE) == 0xF8]
    # keep only frame starts at increasing boundaries (first is real; use
    # block alignment: every frame here starts after the previous one)
    pkts = []
    prev = 0
    for i in starts[1:]:
        # heuristic split is fine for this fixture: sync bytes inside frame
        # data are possible but rare with this content; validate via decode
        pass
    # simpler: single audio packet containing all frames (legal: packets
    # may hold any number of frames per the mapping's framing rules here)
    pages = [oggmod.build_page([header_pkt], serial=42, seq=0, granule=0,
                               bos=True)]
    CHUNK = 4000
    seq = 1
    for i in range(0, len(body), CHUNK):
        pages.append(oggmod.build_page(
            [body[i : i + CHUNK]], serial=42, seq=seq,
            granule=frames if i + CHUNK >= len(body) else 0,
            eos=i + CHUNK >= len(body),
        ))
        seq += 1
    data = b"".join(pages)
    s = AudioStream().open_from_memory(data)
    assert not s.is_error(), s.error_message()
    assert s.get_format() == AudioFileFormat.flac
    out = s.read_samples_float(frames)
    np.testing.assert_array_equal(out, _expected_float(pcm, 16))


def _lpc_case(seed, L, B):
    rng = np.random.default_rng(seed)
    residual = rng.integers(-(1 << 17), 1 << 17, (L, B)).astype(np.int32)
    coeffs = np.zeros((L, 32), np.int32)
    order = rng.integers(0, 33, L).astype(np.int32)
    for l in range(L):
        coeffs[l, : order[l]] = rng.integers(-(1 << 14), 1 << 14, order[l])
    shift = rng.integers(0, 16, L).astype(np.int32)
    exact = rng.integers(0, 2, L).astype(bool)
    return residual, coeffs, order, shift, exact


def test_pallas_lpc_matches_scan():
    """The GPU LPC kernel (Pallas, Triton route) is bit-identical to the
    lax.scan reference, here in interpret mode: lane and step counts that
    are not multiples of its block exercise the wrapper's padding."""
    from audio_formats_tpu.ops import lpc

    args = _lpc_case(11, 13, 777)
    a = np.asarray(lpc.flac_lpc_scan(*args))
    b = np.asarray(lpc.flac_lpc_pallas(*args, interpret=True))
    np.testing.assert_array_equal(a, b)


def test_pallas_lpc_sharded_runs_per_shard(cpu_mesh_devices):
    """A lane-sharded batch runs the kernel under shard_map, one shard per
    device, with the same result as the unsharded scan."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from audio_formats_tpu.ops import lpc
    from audio_formats_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(4, data=4, model=1, devices=cpu_mesh_devices)
    args = _lpc_case(5, 4 * 24, 136)
    placed = [jax.device_put(x, NamedSharding(mesh, P("data")))
              for x in args]
    got = lpc.flac_lpc_pallas(*placed, interpret=True)
    assert got.sharding.spec[0] == "data"
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(lpc.flac_lpc_scan(*args)))


def test_lpc_dispatch_by_platform(monkeypatch):
    """flac_lpc picks the scan on cpu and the kernel on gpu, and never
    swallows a kernel failure into a fallback."""
    from audio_formats_tpu.ops import lpc

    args = _lpc_case(3, 5, 64)

    def boom(*a, **k):
        raise RuntimeError("kernel called")

    monkeypatch.setattr(lpc, "flac_lpc_pallas", boom)
    assert lpc.default_platform() == "cpu"
    np.testing.assert_array_equal(np.asarray(lpc.flac_lpc(*args)),
                                  np.asarray(lpc.flac_lpc_scan(*args)))
    monkeypatch.setattr(lpc, "default_platform", lambda: "gpu")
    with pytest.raises(RuntimeError, match="kernel called"):
        lpc.flac_lpc(*args)


def _exact_lanes(seed, L, B, bits):
    """Residuals of a random signal of `bits` bits per sample under random
    FLAC predictors (coefficients of up to 15 bits, shift 0..15), computed
    in int64: the lanes need drflac's 64-bit prediction."""
    rng = np.random.default_rng(seed)
    lim = 1 << (bits - 1)
    sig = rng.integers(-lim, lim, (L, B)).astype(np.int64)
    order = rng.integers(1, 33, L).astype(np.int32)
    shift = rng.integers(0, 16, L).astype(np.int32)
    coeffs = np.zeros((L, 32), np.int32)
    for l in range(L):
        coeffs[l, : order[l]] = rng.integers(-(1 << 14), 1 << 14, order[l])
    residual = sig.copy()
    for t in range(B):
        hist = np.zeros((L, 32), np.int64)  # hist[:, j] = s[t-1-j]
        k = min(t, 32)
        hist[:, :k] = sig[:, t - k : t][:, ::-1]
        pred = (hist * coeffs).sum(axis=1) >> shift
        residual[:, t] = np.where(t < order, sig[:, t], sig[:, t] - pred)
    keep = np.abs(residual).max(axis=1) < (1 << 31)
    return (residual[keep].astype(np.int32), coeffs[keep], order[keep],
            shift[keep], sig[keep])


@pytest.mark.parametrize("impl", ["scan", "kernel"])
@pytest.mark.parametrize("bits", [17, 18])
def test_lpc_exact_lanes_match_int64(impl, bits):
    """Lanes above 16 bps (drflac's 64-bit prediction) through the int32
    limb split equal the int64 reference and the original signal, up to
    the 18-bit limit models/flac.py routes to the device."""
    from audio_formats_tpu.ops import lpc

    residual, coeffs, order, shift, sig = _exact_lanes(bits, 12, 96, bits)
    assert len(sig) >= 6
    exact = np.ones(len(sig), bool)
    ref = lpc.flac_lpc_np(residual, coeffs, order, shift)
    np.testing.assert_array_equal(ref, sig)
    if impl == "scan":
        got = lpc.flac_lpc_scan(residual, coeffs, order, shift, exact)
    else:
        got = lpc.flac_lpc_pallas(residual, coeffs, order, shift, exact,
                                  interpret=True)
    np.testing.assert_array_equal(np.asarray(got), sig)


@pytest.mark.gpu
def test_lpc_kernel_compiled_matches_scan(gpu_device):
    """The kernel as compiled for the card equals the scan."""
    from audio_formats_tpu.ops import lpc

    args = _lpc_case(17, 300, 1100)
    np.testing.assert_array_equal(
        np.asarray(lpc.flac_lpc_pallas(*args)),
        np.asarray(lpc.flac_lpc_scan(*args)))


def test_mixed_wide_device_frames_keep_order(rng):
    """A window mixing >18-bit (host-redo) and device frames must
    interleave outputs at frame positions: 18-bit stereo alternating
    independent (sub_bps 18, device) and mid-side (side 19, host).
    Regression: host frames used to append before the window's device
    placeholders, scrambling PCM frame order (drflac.d decodes strictly
    in frame order)."""
    from audio_formats_tpu.parallel import BatchDecoder

    B, NF = 256, 6
    pcm = rng.integers(-2**17, 2**17, (B * NF, 2)).astype(np.int64)
    out = bytearray(b"fLaC")
    si = flac_ref._BW()
    si.w(B, 16); si.w(B, 16); si.w(0, 24); si.w(0, 24)
    si.w(44100, 20); si.w(1, 3); si.w(17, 5); si.w(B * NF, 36)
    streaminfo = bytes(si.bytes) + b"\0" * 16
    out += bytes([0x80]) + len(streaminfo).to_bytes(3, "big") + streaminfo
    for fi in range(NF):
        mode = "independent" if fi % 2 == 0 else "mid_side"
        out += flac_ref.encode_frame(pcm[fi * B:(fi + 1) * B], fi,
                                     44100, 18, mode)
    data = bytes(out)
    s = AudioStream()
    s.open_from_memory(data)
    assert not s.is_error(), s.error_message()
    ref = s.read_samples_float(10**8)
    dec = BatchDecoder([data])
    got = dec.decode_all()[0]
    assert dec.stats["group_demotions"] == 0
    np.testing.assert_array_equal(got[: len(ref)], ref)
