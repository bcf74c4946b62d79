#!/usr/bin/env python3
"""Smoke test of the batched decode/encode pipeline on one GPU.

    python chip_smoke.py                # phases 0-3 on one card
    python chip_smoke.py --four-cards   # phase 0, then phase 4 only

Phases run in order and any failure exits non-zero; nothing is caught and
turned into a pass.

0. Device: JAX's first device must be a GPU; prints its kind and count,
   the card's name and power limit (nvidia-smi), JAX's version and the
   compile-cache directory, and requires the native host stage.
1. The FLAC LPC kernel as compiled for the card, at a headline window's
   width (12,288 lanes x 4,096 steps), bit-exact against the lax.scan
   reference and the int64 numpy reference.
2. The headline batch (bench.build_corpus(512, 512): 512 stereo MP3 + 512
   stereo FLAC) through BatchDecoder(...).decode_all(output="device"),
   once with the library defaults and once with the exact-wire modes
   (device-Rice FLAC, pooled MP3 bit planes): no lane group may raise,
   every output window lives on the GPU, both modes decode the same audio
   seconds, and 32 MP3 + 32 FLAC lanes match the same decode on the CPU
   backend (FLAC bit-exact, MP3 within 1e-5 of peak: the GPU sums in
   another order, every f32 matmul on the path asks for HIGHEST).
3. The in-repo golden accuracy gauges, the mixed-format batch of every
   other device group against the per-stream facade, and the batched
   QOA / WAV s24 encoders byte-exact against the streaming encoders.
4. (--four-cards) The headline batch sharded over a 4-card 'data' mesh
   against the single-card decode (FLAC bit-exact, MP3 within 4e-6 of
   peak), and the batched encoders sharded, byte-exact.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

import argparse
import json
import os
import time

import numpy as np

#: headline window of the FLAC lockstep group: 512 streams x 12 frames x
#: 2 channels LPC lanes, 4096-sample blocks
LPC_LANES, LPC_STEPS = 512 * 12 * 2, 4096
#: bounds against a reference computed in another summation order
MP3_REL_CPU = 1e-5
MP3_REL_SHARDED = 4e-6
FACADE_REL = 1e-5


def log(msg):
    print(msg, flush=True)


def phase0_device():
    """Returns bench.device_record(): platform, kind, count and the card's
    name and power limit."""
    import jax

    import bench
    from audio_formats_tpu.host import native
    from audio_formats_tpu.utils.compile_cache import enable_compile_cache

    dev = bench.device_record()
    cache = enable_compile_cache()
    log(f"device_kind {dev['kind']}, count {dev['count']}")
    log(f"nvidia-smi name, power.limit: {dev['name_power_limit']}")
    log(f"jax {jax.__version__}, compile cache {cache}")
    if native.get_lib() is None:
        raise RuntimeError(f"native host stage unavailable: "
                           f"{native.build_error()}")
    return dev


def _lpc_valid_lanes(rng, L, B):
    """Signals with residuals computed in int64 (FLAC's definition): half
    the lanes 16-bit with predictions that fit int32 (the wrap path), half
    18-bit with sums past 2^31 (the exact path), coefficients scaled with
    the shift so that every residual fits int32."""
    exact = np.arange(L) % 2 == 1
    bits = np.where(exact, 18, 16)
    lim = (1 << (bits - 1))[:, None]
    sig = rng.integers(-lim, lim, (L, B))
    order = rng.integers(0, 33, L).astype(np.int32)
    shift = rng.integers(0, 16, L).astype(np.int32)
    cmax = np.where(exact, 1 << np.minimum(7 + shift, 14), 1 << 10)[:, None]
    coeffs = rng.integers(-cmax, cmax, (L, 32))
    coeffs = np.where(np.arange(32)[None, :] < order[:, None], coeffs, 0)
    residual = np.empty((L, B), np.int64)
    hist = np.zeros((L, 32), np.int64)
    for t in range(B):
        pred = (hist * coeffs).sum(axis=1) >> shift
        residual[:, t] = np.where(t < order, sig[:, t], sig[:, t] - pred)
        hist[:, 1:] = hist[:, :-1]
        hist[:, 0] = sig[:, t]
    return (residual.astype(np.int32), coeffs.astype(np.int32), order,
            shift, exact), sig


def phase1_lpc_kernel():
    import jax

    from audio_formats_tpu.ops import lpc

    rng = np.random.default_rng(1)
    # (a) the test suite's draw (residuals within +-2^17, arbitrary
    # wraparound): the kernel's arithmetic must be the scan's, bit for bit
    L, B = LPC_LANES, LPC_STEPS
    residual = rng.integers(-(1 << 17), 1 << 17, (L, B)).astype(np.int32)
    order = rng.integers(0, 33, L).astype(np.int32)
    coeffs = rng.integers(-(1 << 14), 1 << 14, (L, 32)).astype(np.int32)
    coeffs = np.where(np.arange(32)[None, :] < order[:, None], coeffs, 0)
    shift = rng.integers(0, 16, L).astype(np.int32)
    exact = rng.integers(0, 2, L).astype(bool)
    args = [jax.device_put(x) for x in
            (residual, coeffs.astype(np.int32), order, shift, exact)]
    compiled = lpc._lpc_kernel_call.lower(*args, interpret=False).compile()
    log(f"lpc kernel memory_analysis: {compiled.memory_analysis()}")
    times = {}
    for name, fn in (("kernel", lambda: lpc.flac_lpc_pallas(*args)),
                     ("scan", lambda: lpc.flac_lpc_scan(*args))):
        out = fn().block_until_ready()
        t0 = time.perf_counter()
        out = fn().block_until_ready()
        times[name] = time.perf_counter() - t0
        if name == "kernel":
            got = np.asarray(out)
        else:
            ref = np.asarray(out)
    if not np.array_equal(got, ref):
        raise AssertionError(
            f"LPC kernel != scan on {np.count_nonzero(got != ref)} samples")
    # (b) valid FLAC lanes: kernel == scan == int64 numpy == the signal
    vargs, sig = _lpc_valid_lanes(rng, L, B)
    got = np.asarray(lpc.flac_lpc_pallas(*vargs))
    scan = np.asarray(lpc.flac_lpc_scan(*vargs))
    ref = lpc.flac_lpc_np(*vargs[:4])
    for name, x in (("kernel", got), ("scan", scan), ("int64 numpy", ref)):
        if not np.array_equal(x, sig):
            raise AssertionError(f"LPC {name} != signal on valid lanes")
    log(f"phase 1 ok: LPC kernel bit-exact at {L} lanes x {B} steps "
        f"(warm kernel {times['kernel'] * 1e3:.3f} ms, "
        f"scan {times['scan'] * 1e3:.3f} ms)")


def _device_platforms(result):
    return {d.platform for _kind, arrs in result.windows() for a in arrs
            for d in a.devices()}


def _decode(items, what, mesh=None):
    """One device-resident decode of items; returns (decoder, result,
    wall seconds).  Any demotion or lane error fails."""
    import bench
    from audio_formats_tpu.parallel import BatchDecoder

    t0 = time.perf_counter()
    dec = BatchDecoder(items, mesh=mesh)
    res = dec.decode_all(output="device").sync()
    wall = time.perf_counter() - t0
    bench.require_clean(dec, what)
    return dec, res, wall


def _compare_lanes(got, ref, idx, n_mp3, mp3_bound, what):
    """FLAC lanes (index >= n_mp3) bit-exact, MP3 lanes within mp3_bound
    of their peak."""
    worst = 0.0
    for i in idx:
        g, r = got[i], ref[i]
        if g is None or r is None or g.shape != r.shape:
            raise AssertionError(f"{what}: lane {i} missing or reshaped")
        if i >= n_mp3:
            if not np.array_equal(g, r):
                raise AssertionError(f"{what}: FLAC lane {i} not bit-exact")
        else:
            rel = float(np.abs(g - r).max()) / (float(np.abs(r).max())
                                                 + 1e-12)
            worst = max(worst, rel)
            if rel > mp3_bound:
                raise AssertionError(
                    f"{what}: MP3 lane {i} off by {rel:.3g} of peak")
    return worst


def phase2_headline(card, corpus):
    import jax

    from audio_formats_tpu.parallel import BatchDecoder

    mp3, _, flac, _, _ = corpus
    items = mp3 + flac
    n_mp3 = len(mp3)
    walls, secs = {}, {}
    exact_wire = {"AF_TPU_FLAC_DEVICE_RICE": "1", "AF_TPU_MP3_POOL_BITS": "1"}
    for mode, env in (("defaults", {}), ("exact-wire", exact_wire)):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            _, _, cold = _decode(items, f"headline {mode} (cold)")
            dec, res, warm = _decode(items, f"headline {mode}")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        plats = _device_platforms(res)
        if plats != {"gpu"}:
            raise AssertionError(f"headline {mode}: windows on {plats}")
        walls[mode] = (cold, warm)
        secs[mode] = dec.stats["decoded_seconds"]
        if mode == "defaults":
            got = res.to_numpy()
    if abs(secs["defaults"] - secs["exact-wire"]) > 1e-6:
        raise AssertionError(f"decoded seconds differ by mode: {secs}")
    # the same lanes on the CPU backend: a global default device (the
    # scheduler's worker threads do not see a thread-local one)
    idx = list(range(0, n_mp3, max(1, n_mp3 // 32)))[:32] + list(range(
        n_mp3, len(items), max(1, (len(items) - n_mp3) // 32)))[:32]
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    try:
        dec = BatchDecoder([items[i] for i in idx])
        cres = dec.decode_all(output="device").sync()
        plats = _device_platforms(cres)
        ref_sub = cres.to_numpy()
    finally:
        jax.config.update("jax_default_device", None)
    if plats != {"cpu"}:
        raise AssertionError(f"CPU reference ran on {plats}")
    ref = {i: r for i, r in zip(idx, ref_sub)}
    worst = _compare_lanes(got, ref, idx, n_mp3, MP3_REL_CPU,
                           "GPU vs CPU backend")
    for mode, (cold, warm) in walls.items():
        log(f"headline {mode} on {card}: cold {cold:.3f} s, warm "
            f"{warm:.3f} s, {secs[mode]:.1f} s of audio "
            f"({secs[mode] / warm:.1f}x realtime warm)")
    log(f"phase 2 ok: {len(items)} lanes, 0 demotions, GPU == CPU on "
        f"{len(idx)} lanes (worst MP3 {worst:.3g} of peak)")


def _encode_inputs():
    rng = np.random.default_rng(7)
    pcms = []
    for i in range(12):
        n = 6000 + 1280 * i if i < 10 else 44100 * 3 + 77 * i
        t = np.arange(n)[:, None]
        x = (0.4 * np.sin(2 * np.pi * (180 + 40 * i) * t * [1.0, 1.31]
                          / 44100)
             + 0.02 * rng.standard_normal((n, 2)))
        pcms.append(x[:, : 1 + i % 2].astype(np.float32))
    return pcms


def _streaming_encode(cls, pcm, options):
    from audio_formats_tpu.io.source import ByteSink

    sink = ByteSink()
    enc = cls(sink, 44100, pcm.shape[1], options)
    enc.write(pcm)
    enc.finalize()
    return sink.getvalue()


def phase3_groups_and_encoders(corpus):
    import bench
    from audio_formats_tpu.config import AudioSampleFormat, EncodingOptions
    from audio_formats_tpu.models.qoa import QoaEncoder
    from audio_formats_tpu.models.wav import WavEncoder
    from audio_formats_tpu.parallel import encode as penc

    gauges = bench.golden_gauges()
    for key, row in gauges.items():
        log(f"gauge {key}: {row['value']:.3g} (bound {row['bound']})")
        if not row["ok"]:
            raise AssertionError(f"gauge {key} out of bound: {row}")
    mp3, _, flac, _, _ = corpus
    streams, check_idx, n_opus = bench.build_mixed_streams(mp3, flac)
    dec, res, wall = _decode(streams, "mixed batch")
    if dec.stats.get("opus_mixed_lanes", 0) != n_opus:
        raise AssertionError(
            f"mode-switching lanes: {dec.stats.get('opus_mixed_lanes')} "
            f"of {n_opus} rode the mixed group")
    dev = bench.facade_deviation(streams, check_idx, res.to_numpy())
    bad = {i: v for i, v in dev.items() if v > FACADE_REL}
    if bad:
        raise AssertionError(f"mixed lanes off the facade: {bad}")
    log(f"mixed batch ok: {len(streams)} lanes in {wall:.3f} s, "
        f"worst facade deviation {max(dev.values()):.3g}")
    pcms = _encode_inputs()
    qoa = penc.encode_qoa_batch(pcms, 44100, parallel_frames=False)
    opt = EncodingOptions(sample_format=AudioSampleFormat.s24)
    wav = penc.encode_wav_batch(pcms, 44100, opt)
    for i, pcm in enumerate(pcms):
        if qoa[i] != _streaming_encode(QoaEncoder, pcm, EncodingOptions()):
            raise AssertionError(f"QOA batch encode lane {i} differs")
        if wav[i] != _streaming_encode(WavEncoder, pcm, opt):
            raise AssertionError(f"WAV s24 batch encode lane {i} differs")
    log(f"phase 3 ok: gauges, mixed batch, QOA/WAV s24 encode byte-exact "
        f"on {len(pcms)} lanes")


def phase4_four_cards(corpus):
    import jax

    from audio_formats_tpu.config import AudioSampleFormat, EncodingOptions
    from audio_formats_tpu.parallel import encode as penc
    from audio_formats_tpu.parallel.mesh import make_mesh

    gpus = jax.devices("gpu")
    mesh = make_mesh(4, data=4, model=1, devices=gpus)
    mp3, _, flac, _, _ = corpus
    items = mp3 + flac
    _, one, t_one = _decode(items, "headline, one card")
    _, four, t_four = _decode(items, "headline, 4-card mesh", mesh=mesh)
    plats = {d.id for _k, arrs in four.windows() for a in arrs
             for d in a.devices()}
    log(f"sharded windows span devices {sorted(plats)}")
    ref, got = one.to_numpy(), four.to_numpy()
    worst = _compare_lanes(got, ref, range(len(items)), len(mp3),
                           MP3_REL_SHARDED, "sharded vs one card")
    pcms = _encode_inputs()
    opt = EncodingOptions(sample_format=AudioSampleFormat.s24)
    for name, fn in (("QOA", lambda m: penc.encode_qoa_batch(
                          pcms, 44100, mesh=m)),
                     ("WAV s24", lambda m: penc.encode_wav_batch(
                          pcms, 44100, opt, mesh=m))):
        if fn(None) != fn(mesh):
            raise AssertionError(f"sharded {name} encode not byte-exact")
    log(f"phase 4 ok: {len(items)} lanes sharded == one card (worst MP3 "
        f"{worst:.3g} of peak); one card {t_one:.3f} s, 4 cards "
        f"{t_four:.3f} s (cold); QOA/WAV s24 sharded encode byte-exact")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run phase 0, then the 4-card mesh phase only")
    args = ap.parse_args()
    dev = phase0_device()
    import bench

    t0 = time.perf_counter()
    corpus = bench.build_corpus(512, 512)
    log(f"corpus: {len(corpus[0])} MP3 + {len(corpus[2])} FLAC lanes, "
        f"{sum(corpus[1]) + sum(corpus[3]):.1f} s of audio, built in "
        f"{time.perf_counter() - t0:.1f} s")
    if args.four_cards:
        if dev["count"] < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, JAX sees "
                             f"{dev['count']}")
        phase4_four_cards(corpus)
    else:
        phase1_lpc_kernel()
        phase2_headline(dev["name_power_limit"], corpus)
        phase3_groups_and_encoders(corpus)
    print(json.dumps({"ok": True, "device": {
        k: dev[k] for k in ("platform", "kind", "count")}}))


if __name__ == "__main__":
    main()
