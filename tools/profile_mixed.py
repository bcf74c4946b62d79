"""Profile the mixed-content gauge batch: where does the wall go?

Runs bench.build_mixed_streams lanes through BatchDecoder and prints the
full stats split (host/enqueue/fetch per format) for cold + warm passes.
Usage: python tools/profile_mixed.py [--device] [--reps N]
"""
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


def main():
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", action="store_true",
                    help="decode_all(output='device') + sync")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    mp3, _, flac, _, _ = bench.build_corpus(12, 12)
    streams, check_idx, n_opus, err = bench.build_mixed_streams(mp3, flac)
    print(f"lanes={len(streams)} opus={n_opus} err={err}")

    from audio_formats_tpu.parallel import BatchDecoder

    def one_pass(tag):
        t0 = time.perf_counter()
        dec = BatchDecoder(list(streams))
        t_probe = time.perf_counter() - t0
        if args.device:
            res = dec.decode_all(output="device")
            res.sync()
        else:
            res = dec.decode_all()
        dt = time.perf_counter() - t0
        secs = dec.stats["decoded_seconds"]
        s = dec.stats
        split = {
            "wall_s": round(dt, 3),
            "probe_s": round(t_probe, 3),
            "rtx": round(secs / dt, 1),
            "audio_s": round(secs, 1),
            "host_s": round(s["host_ms"] / 1e3, 3),
            "enqueue_s": round(s["enqueue_ms"] / 1e3, 3),
            "fetch_s": round(s["fetch_ms"] / 1e3, 3),
            "host_cpu_s": round(s["host_cpu_ms"] / 1e3, 3),
            "host_s_by_format": {k: round(v / 1e3, 3) for k, v in
                                 s["host_ms_by_format"].items()},
            "enqueue_s_by_format": {k: round(v / 1e3, 3) for k, v in
                                    s["enqueue_ms_by_format"].items()},
            "host_cpu_s_by_format": {k: round(v / 1e3, 3) for k, v in
                                     s["host_cpu_ms_by_format"].items()},
            "secs_by_format": {k: round(v, 1) for k, v in
                               s["decoded_seconds_by_format"].items()},
            "h2d_MB": round(s["h2d_bytes"] / 1e6, 2),
            "h2d_MB_by_format": {k: round(v / 1e6, 2) for k, v in
                                 s.get("h2d_bytes_by_format", {}).items()},
            "extra": {k: round(v / 1e3, 3) for k, v in s.items()
                      if k.startswith(("enq_", "disp_"))},
            "d2h_MB": round(s["d2h_bytes"] / 1e6, 2),
            "windows": s["windows"],
            "demotions": s["group_demotions"],
        }
        print(f"[{tag}] {json.dumps(split)}")
        return dt

    one_pass("cold")
    for r in range(args.reps):
        one_pass(f"warm{r}")


if __name__ == "__main__":
    main()
