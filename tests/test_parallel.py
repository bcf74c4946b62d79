"""Data-parallel BatchDecoder over a device mesh (SURVEY.md §2.4): the
batch axis shards across the mesh 'data' axis; results must equal the
unsharded decode.  Runs on the 8 virtual CPU devices from conftest."""

import numpy as np
import jax

from audio_formats_tpu.parallel import BatchDecoder
from audio_formats_tpu.parallel.mesh import make_mesh

from golden import flac_ref, mp3_ref


def _mp3_streams(rng, n):
    frames = []
    for i in range(8):
        q = np.zeros(576, np.int64)
        q[rng.choice(300, 40, replace=False)] = rng.integers(-20, 21, 40)
        q2 = np.zeros(576, np.int64)
        q2[rng.choice(300, 40, replace=False)] = rng.integers(-20, 21, 40)
        frames.append([[{"q": q}], [{"q": q2}]])
    return [mp3_ref.build_mp3(frames, channels=1)] * n


def test_mesh_sharded_mp3_matches_unsharded(rng):
    streams = _mp3_streams(rng, 8)
    base = BatchDecoder(streams).decode_all()
    mesh = make_mesh(8, data=8, model=1,
                     devices=jax.devices("cpu"))
    sharded = BatchDecoder(streams, mesh=mesh).decode_all()
    for a, b in zip(base, sharded):
        a = np.asarray(a)
        b = np.asarray(b)
        peak = np.abs(a).max() + 1e-30
        # SPMD partitioning reassociates float reductions: compare
        # relative to peak
        assert np.abs(a - b).max() / peak < 1e-5


def test_mesh_sharded_flac_matches_unsharded(rng):
    x = np.clip(
        np.round(9000 * np.sin(2 * np.pi * 330 * np.arange(4096 * 6)[:, None]
                               / 44100.0)), -32768, 32767).astype(np.int64)
    data = flac_ref.build_flac(x, 44100, 16, block_size=4096,
                               modes=["lpc8"])
    streams = [data] * 8
    base = BatchDecoder(streams).decode_all()
    mesh = make_mesh(8, data=8, model=1, devices=jax.devices("cpu"))
    sharded = BatchDecoder(streams, mesh=mesh).decode_all()
    for a, b in zip(base, sharded):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_mesh_sharded_vorbis_device_matches_unsharded(rng):
    """The device-resident Vorbis window chain shards its lane-channel
    axis over 'data' (ops/vorbis_win via _shard_batch_axis1); the sharded
    device-mode decode must match the unsharded one."""
    from golden import vorbis_ref

    fix = vorbis_ref.Fixture(channels=1, bs0=512, bs1=2048)
    frames = []
    for j in range(6):
        lb = bool((j // 2) % 2)
        n2 = (fix.bs1 if lb else fix.bs0) // 2
        r = np.zeros(n2)
        idx = rng.choice(n2, size=n2 // 4, replace=False)
        r[idx] = rng.integers(-5, 6, size=idx.size) * fix.vq_delta
        prev_long = bool(((j - 1) // 2) % 2) if j > 0 else True
        next_long = bool(((j + 1) // 2) % 2) if j + 1 < 6 else True
        frames.append(fix.audio_packet(
            [[60, 70, 80, 90]], [r], long_block=lb,
            prev_flag=1 if prev_long else 0,
            next_flag=1 if next_long else 0))
    streams = [fix.build(frames)] * 8
    base = BatchDecoder(streams).decode_all(output="device").to_numpy()
    mesh = make_mesh(8, data=8, model=1, devices=jax.devices("cpu"))
    sharded = BatchDecoder(streams, mesh=mesh) \
        .decode_all(output="device").to_numpy()
    for a, b in zip(base, sharded):
        peak = np.abs(a).max() + 1e-30
        assert np.abs(np.asarray(a) - np.asarray(b)).max() / peak < 1e-5


def test_opus_celt_lockstep_matches_facade():
    """CELT-only Opus lanes decode through the batched device synthesis
    (ops/celt_dsp.celt_imdct_ola) and must match the per-stream facade."""
    import pytest

    from golden import opus_oracle, opus_ref
    from audio_formats_tpu import AudioStream

    try:
        if opus_oracle.get_lib() is None:
            pytest.skip("libopus unavailable")
    except Exception:
        pytest.skip("libopus unavailable")
    O = opus_oracle
    rng = np.random.default_rng(3)
    N, npkt = 960, 8
    t = np.arange(N * npkt) / 48000.0
    sig = np.clip(7000 * np.sin(2 * np.pi * 440 * t) +
                  1200 * rng.standard_normal(t.size),
                  -32000, 32000).astype(np.int16)[:, None]
    enc = O.OracleEncoder(48000, 1, bitrate=96000,
                          signal=O.OPUS_SIGNAL_MUSIC,
                          bandwidth=O.OPUS_BANDWIDTH_FULLBAND)
    pkts = [(enc.encode(sig[n * N : (n + 1) * N]), N) for n in range(npkt)]
    data = opus_ref.build_ogg_opus(pkts, channels=1, preskip=312)
    st = AudioStream()
    st.open_from_memory(data)
    ref = st.read_samples_float(st.get_length_in_frames())
    outs = BatchDecoder([data] * 4).decode_all()
    for o in outs:
        o = np.asarray(o)[: len(ref)]
        assert np.abs(o - ref).max() < 1e-6


def test_make_mesh_raises_when_devices_are_short():
    """A mesh larger than the devices given (or the default platform's)
    raises; it is never filled with devices of another platform."""
    import pytest

    cpus = jax.devices("cpu")
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_mesh(16, devices=cpus)
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_mesh(8, data=8, model=2, devices=cpus)
    mesh = make_mesh(4, data=2, model=2, devices=cpus)
    assert mesh.devices.shape == (2, 2)
    assert {d.platform for d in mesh.devices.flat} == {"cpu"}
