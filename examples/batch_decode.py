"""Batched device decode — the API this framework adds over the reference.

The reference is strictly single-stream (stream.d:31-33); its "batch" is a
shell loop around examples/transcode (main.d:71-78).  Here N compressed
streams of mixed formats decode in lockstep on the accelerator, and the
PCM can stay device-resident — the natural sink of a decode pipeline is a
model on the same card, and downloading PCM costs more than decoding it.

    python examples/batch_decode.py song1.mp3 take2.flac voice.opus ...

Prints per-stream results and the scheduler's per-stage split.  Set
AF_TPU_PROFILE=/tmp/trace.json to also capture a Perfetto-loadable stage
trace.
"""

import sys

import numpy as np

from audio_formats_tpu.parallel import BatchDecoder


def main(paths):
    if not paths:
        print(__doc__)
        return 1
    dec = BatchDecoder(paths)

    # device-resident decode: PCM windows stay on the accelerator; sync()
    # blocks until every window is materialized on-chip
    result = dec.decode_all(output="device").sync()

    # hand the device arrays to a model here via result.windows(), or
    # download everything:
    pcms = result.to_numpy()
    for path, pcm, err in zip(paths, pcms, dec.errors):
        if err is not None or pcm is None:
            print(f"{path}: ERROR: {err}")
            continue
        d = dec.decoders[paths.index(path)]
        secs = pcm.shape[0] / max(1, d.sample_rate)
        peak = float(np.abs(pcm).max()) if pcm.size else 0.0
        print(f"{path}: {pcm.shape[0]} frames x {pcm.shape[1]} ch "
              f"({secs:.2f} s, peak {peak:.3f})")

    s = dec.stats
    print(f"\ndecoded {s['decoded_seconds']:.1f} s total "
          f"({', '.join(f'{k}: {v:.1f}s' for k, v in sorted(s['decoded_seconds_by_format'].items()))})")
    print(f"stage split: host {s['host_ms']:.0f} ms | enqueue "
          f"{s['enqueue_ms']:.0f} ms | fetch {s['fetch_ms']:.0f} ms | "
          f"{s['windows']} device windows | "
          f"h2d {s['h2d_bytes'] / 1e6:.1f} MB, d2h {s['d2h_bytes'] / 1e6:.1f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
