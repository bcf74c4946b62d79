"""Offline fuzz sweep over every format's facade open/read/seek path.

Contract under test (reference parity, stream.d:424-427 /
internals.d:16-23): malformed input NEVER raises out of the public API —
it either fails the open with a sticky error, truncates the read, or
decodes garbage; outputs must stay finite.

Usage:  python tools/fuzz_facade.py [iterations-per-format] [seed]
Prints one line per crash (format, mutation seed, exception) and a
summary; exit code 1 if any crash was found.  Runs JAX on CPU for
throughput (facade correctness is backend-independent).
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import traceback

import numpy as np


def _mutate(data: bytes, rng) -> bytes:
    """One random structural mutation (superset of the test suite's)."""
    b = bytearray(data)
    L = len(b)
    kind = rng.integers(0, 8)
    if kind == 0:      # random byte flips
        for pos in rng.integers(0, L, rng.integers(1, 64)):
            b[pos] ^= int(rng.integers(1, 256))
    elif kind == 1:    # zero a run
        i = int(rng.integers(0, L))
        n = int(min(rng.integers(1, 2048), L - i))
        b[i : i + n] = b"\x00" * n
    elif kind == 2:    # 0xFF a run
        i = int(rng.integers(0, L))
        n = int(min(rng.integers(1, 2048), L - i))
        b[i : i + n] = b"\xff" * n
    elif kind == 3:    # truncate
        return bytes(b[: rng.integers(0, L)])
    elif kind == 4:    # splice out a chunk
        i, j = sorted(rng.integers(0, L, 2))
        return bytes(b[:i]) + bytes(b[j:])
    elif kind == 5:    # duplicate a chunk in place
        i, j = sorted(rng.integers(0, L, 2))
        j = min(j, i + 4096)
        return bytes(b[:j]) + bytes(b[i:j]) + bytes(b[j:])
    elif kind == 6:    # random prefix (resync torture)
        return bytes(rng.integers(0, 256, int(rng.integers(1, 128)),
                                  dtype=np.uint8)) + bytes(b)
    else:              # header-area byte flips (first 256 bytes)
        for pos in rng.integers(0, min(256, L), rng.integers(1, 16)):
            b[pos] ^= int(rng.integers(1, 256))
    return bytes(b)


def main():
    from audio_formats_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    rng = np.random.default_rng(seed)

    import audio_formats_tpu as af
    from test_robustness import _fixtures  # reuses the golden builders

    fixtures = _fixtures(rng)
    crashes = []
    tried = 0
    for kind, data in fixtures.items():
        for it in range(iters):
            bad = _mutate(data, rng)
            tried += 1
            try:
                s = af.AudioStream()
                s.open_from_memory(bad)
                if s.is_error():
                    assert isinstance(s.error_message(), str)
                    continue
                total = 0
                for _ in range(64):
                    out = s.read_samples_float(4096)
                    assert np.isfinite(np.asarray(out)).all(), \
                        "non-finite output"
                    if out.shape[0] == 0:
                        break
                    total += out.shape[0]
                # the seek contract must hold even on damaged streams
                n = s.get_length_in_frames()
                if n and n > 0:
                    s.seek_position(max(0, n // 2))
                    out = s.read_samples_float(256)
                    assert np.isfinite(np.asarray(out)).all()
            except Exception as e:
                crashes.append((kind, it, repr(e)))
                print(f"CRASH {kind} iter={it}: {e!r}", flush=True)
                traceback.print_exc()
    # phase 2: the BATCH lattice under the same mutations — corrupt lanes
    # mixed with clean ones through the grouped device paths (pool-mode
    # MP3 wire + concurrent format groups forced on), asserting decode_all
    # never raises and clean lanes still decode to finite PCM
    os.environ["AF_TPU_MP3_POOL_BITS"] = "1"
    os.environ["AF_TPU_GROUP_THREADS"] = "2"
    from audio_formats_tpu.parallel import BatchDecoder

    goods = list(fixtures.values())
    batch_rounds = max(1, iters // 8)
    for it in range(batch_rounds):
        bads = [_mutate(d, rng) for d in goods]
        tried += len(bads)
        try:
            dec = BatchDecoder(goods + bads)
            out = dec.decode_all()
            for i in range(len(goods)):
                assert out[i] is not None, f"clean lane {i} lost"
                assert np.isfinite(np.asarray(out[i])).all()
            for j in range(len(goods), len(out)):
                assert out[j] is None or \
                    np.isfinite(np.asarray(out[j])).all()
        except Exception as e:
            crashes.append(("batch", it, repr(e)))
            print(f"CRASH batch iter={it}: {e!r}", flush=True)
            traceback.print_exc()
    print(f"fuzz_facade: {tried} mutations, {len(crashes)} crashes")
    sys.exit(1 if crashes else 0)


if __name__ == "__main__":
    main()
