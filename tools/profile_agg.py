"""Profile the aggregate MP3+FLAC e2e decode (bench.py's headline shape)
with the fine-grained enqueue sub-timers.  Usage:
  python tools/profile_agg.py [--mp3 512] [--flac 512] [--reps 2]
Env mirrors bench: AF_TPU_MP3_POOL_BITS=1; set AF_TPU_FLAC_DEVICE_RICE
explicitly to pick the wire mode."""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

os.environ.setdefault("AF_TPU_MP3_POOL_BITS", "1")
import bench  # noqa: E402
from audio_formats_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402,E501
from audio_formats_tpu.parallel import BatchDecoder  # noqa: E402


def main():
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--mp3", type=int, default=512)
    ap.add_argument("--flac", type=int, default=512)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--cold", action="store_true")
    args = ap.parse_args()

    t0 = time.time()
    mp3, _, flac, _, _ = bench.build_corpus(args.mp3, args.flac)
    print(f"# corpus loaded {time.time()-t0:.0f}s", file=sys.stderr)
    up, down = bench.measure_link()
    print(f"# link up {up/1e6:.1f} down {down/1e6:.1f} MB/s",
          file=sys.stderr)

    def one(tag):
        t0 = time.perf_counter()
        dec = BatchDecoder(mp3 + flac)
        t_probe = time.perf_counter() - t0
        res = dec.decode_all(output="device")
        t_call = time.perf_counter() - t0 - t_probe
        res.sync()
        dt = time.perf_counter() - t0
        s = dec.stats
        secs = s["decoded_seconds"]
        out = {
            "wall_s": round(dt, 2), "rtx": round(secs / dt, 1),
            "probe_s": round(t_probe, 2),
            "call_s": round(t_call, 2),
            "sync_s": round(dt - t_probe - t_call, 2),
            "host_s": round(s["host_ms"] / 1e3, 2),
            "enqueue_s": round(s["enqueue_ms"] / 1e3, 2),
            "host_cpu_s": round(s["host_cpu_ms"] / 1e3, 2),
            "h2d_MB": round(s["h2d_bytes"] / 1e6, 1),
            "h2d_by_fmt": {k: round(v / 1e6, 1) for k, v in
                           s.get("h2d_bytes_by_format", {}).items()},
            "host_by_fmt": {k: round(v / 1e3, 2) for k, v in
                            s["host_ms_by_format"].items()},
            "enq_by_fmt": {k: round(v / 1e3, 2) for k, v in
                           s["enqueue_ms_by_format"].items()},
            "sub": {k: round(v / 1e3, 2) for k, v in s.items()
                    if k.startswith(("enq_", "disp_"))},
            "windows": s["windows"],
            "implied_h2d_s": round(s["h2d_bytes"] / up, 2),
        }
        print(f"[{tag}] {json.dumps(out)}")

    if args.cold:
        one("cold")
    for r in range(args.reps):
        one(f"rep{r}")


if __name__ == "__main__":
    main()
