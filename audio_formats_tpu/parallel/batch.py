"""BatchDecoder — the batched decode API.

The reference is strictly single-stream (stream.d:31-33).  This is the new
core object: N independent compressed streams decode in lockstep, with all
device tensors carrying a leading [batch] axis (shardable over a mesh's
'data' axis) and per-stream carried state (MP3 overlap/slot-history, FLAC
LPC warm-up, QOA LMS) held in device arrays between steps.

Scheduling: the host entropy stage parses a *window* of W frames per stream,
stacks them into [B, ...] tensors, and issues ONE device call per window —
amortizing dispatch latency and keeping the device fed.  Lanes that end (or hit
reservoir underflow) freeze their carried state via per-granule active masks,
matching the reference's skip-without-decode behavior.

Error lattice: a corrupt stream only poisons its own lane — it stops
producing frames and its `errors` entry is set; other lanes are unaffected
(SURVEY.md §5 requirement).
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from .. import models
from ..config import AudioFileFormat
from ..errors import AudioFormatError
from ..io.source import ByteSource, FileSource, MemorySource
from ..models.flac import FlacDecoder
from ..models.mp3 import Mp3Decoder
from ..models.opus import OpusDecoder, parse_packet as _opus_parse
from ..models.qoa import QoaDecoder
from ..models.vorbis import VorbisDecoder
from ..models.wav import WavDecoder, _LINEAR_PCM
from ..ops import lms as lms_ops
from ..ops import lpc as lpc_ops
from ..ops import mp3_dsp

#: frames per device call in the MP3 lockstep scheduler (env-tunable:
#: bigger windows amortize the per-transfer/dispatch fixed cost over more
#: audio at the price of device memory per call)
MP3_WINDOW_FRAMES = int(os.environ.get("AF_TPU_MP3_WINDOW", "24"))
#: FLAC frames per device call
FLAC_WINDOW_FRAMES = int(os.environ.get("AF_TPU_FLAC_WINDOW", "12"))


def pcm_ops_int_to_float_dev(seg, kind: str):
    """Device-resident variant of ops.pcm.int_pcm_to_float (no download)."""
    from ..ops import pcm as pcm_ops

    n = seg.shape[0]
    xp = np.zeros(pcm_ops._pad_len(n), np.int32)
    xp[:n] = seg
    return pcm_ops._int_to_f32(xp, kind)


#: FLAC packed-residual width buckets (static jit arg)
_FLAC_W_BUCKETS = (4, 6, 8, 10, 12, 14, 17, 20, 26, 32)
#: overflow raw-plane row buckets for _flac_width_plan
_FLAC_OVF_BUCKETS = (128, 512, 2048)


def _flac_width_plan(w_l, wmax: int, Ln: int, bs: int):
    """Pick the packed residual width for a FLAC window: (wb, Lb).

    Lb == 0: every row packs at wb (the max-width bucket, today's plain
    layout).  Lb > 0: rows pack at the smaller wb and the few rows wider
    than wb ship raw int32 in an [Lb, bs] plane (flac_merge_overflow).
    Minimizes uploaded words over the static bucket grid."""
    def stride(w):
        return (bs * w + 31) // 32 + 1

    wb_plain = next((x for x in _FLAC_W_BUCKETS if wmax <= x), 32)
    plans = [(Ln * stride(wb_plain), wb_plain, 0)]
    for ws in _FLAC_W_BUCKETS:
        if ws >= wb_plain:
            break
        nov = int(np.count_nonzero(w_l > ws))
        for lb in _FLAC_OVF_BUCKETS:
            if nov + 1 <= lb:
                plans.append(
                    (Ln * stride(ws) + lb * stride(wb_plain), ws, lb))
                break
    _, wb, lb = min(plans)
    return wb, lb



def _prefetch(arr, to_device: bool):
    """Start the async device->host PCM copy ONLY when the caller will
    download it.  With output="device" the copy must NOT start: the PCM
    windows are huge and the background transfers saturate the downlink,
    serializing everything behind them."""
    if to_device:
        return
    try:
        arr.copy_to_host_async()
    except AttributeError:
        pass


def _open_source(item) -> ByteSource:
    if isinstance(item, (bytes, bytearray, memoryview)):
        return MemorySource(item)
    return FileSource(item)


def _shard_batch(mesh, *arrays):
    """Place window tensors with the leading batch axis sharded over the
    mesh's 'data' axis (pure stream data-parallelism; the jitted DSP then
    runs SPMD and XLA inserts any collectives).  No-op without a mesh."""
    if mesh is None:
        return arrays
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    out = []
    for a in arrays:
        spec = P("data") if a.ndim and a.shape[0] % mesh.shape["data"] == 0 \
            else P()
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)


def _shard_batch_axis1(mesh, x, carry0):
    """Placement for the Vorbis device window chain: the window tensor's
    LANE axis is axis 1 ([K packets, L lanes, ...]) while the carried lap
    is lane-leading — shard both over 'data' when they divide evenly."""
    if mesh is None:
        return x, carry0
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    ok = x.shape[1] % mesh.shape["data"] == 0
    sx = P(None, "data", None) if ok else P()
    sc = P("data", None) if ok else P()
    return (jax.device_put(x, NamedSharding(mesh, sx)),
            jax.device_put(carry0, NamedSharding(mesh, sc)))


def _lane_chunks(lanes, n_workers):
    """Contiguous lane chunks for the parse pool: ~4 chunks per worker
    rides out variable per-lane parse cost without paying per-lane task
    dispatch (and per-lane thread-CPU probe) overhead.  Order-preserving
    so chunked results zip back against the live-lane list."""
    n = max(1, -(-len(lanes) // max(1, n_workers * 4)))
    return [lanes[i: i + n] for i in range(0, len(lanes), n)]


class _StageTrace:
    """Chrome-trace (Perfetto) recorder for the batch scheduler's stage
    timers (SURVEY §5.1).  Spans derive from the same accumulators as
    ``BatchDecoder.stats`` — the trace and the reported split always
    agree.  Written on decode_all exit as trace-event JSON."""

    _TIDS = {"host_ms": 1, "enqueue_ms": 2, "fetch_ms": 3}

    def __init__(self, path: str):
        self.path = path
        self.events = []
        self.t0 = time.perf_counter()
        self.xla = False

    def wrap(self, stats):
        trace = self

        class _Recording(dict):
            def __setitem__(self, key, value):
                if key in _StageTrace._TIDS:
                    old = self.get(key, 0.0)
                    dur_us = (value - old) * 1e3
                    if dur_us > 0:
                        now_us = (time.perf_counter() - trace.t0) * 1e6
                        trace.events.append({
                            "name": key[:-3], "ph": "X", "pid": 1,
                            "tid": _StageTrace._TIDS[key],
                            "ts": now_us - dur_us, "dur": dur_us,
                        })
                dict.__setitem__(self, key, value)

        return _Recording(stats)

    def flush(self):
        import json
        import os as _os

        if self.xla:
            import jax as _jax

            _jax.profiler.stop_trace()
            self.xla = False
        d = _os.path.dirname(self.path)
        if d:
            _os.makedirs(d, exist_ok=True)
        with open(self.path, "w") as f:
            json.dump({
                "traceEvents": self.events,
                "metadata": {"tool": "audio_formats_tpu BatchDecoder",
                             "tids": {v: k for k, v in self._TIDS.items()}},
            }, f)


class _PendingGroup:
    """A lockstep group whose PCM windows are still device-resident.
    ``finalize()`` downloads and assembles the per-lane numpy PCM (cached)."""

    def __init__(self, owner, kind, decs, pending, fin, args):
        self.owner = owner
        self.kind = kind
        self.decs = decs
        self.pending = pending
        self._fin = fin
        self._args = args
        self._result = None

    def seconds(self) -> float:
        tot = 0.0
        for d in self.decs:
            sr = max(1, d.sample_rate)
            if self.kind == "mp3":
                tot += d._cur_sample / max(1, d.channels) / sr
            elif self.kind in ("qoa", "vorbis"):
                tot += d._pos / sr
            else:
                tot += d._frame_pos / sr
        return tot

    def last_arrays(self):
        return [self.pending[-1][0]] if self.pending else []

    def finalize(self):
        if self._result is None:
            self._result = self._fin(*self._args)
        return self._result


class DeviceBatchResult:
    """Result of ``BatchDecoder.decode_all(output="device")``: decoded PCM
    window tensors stay on the accelerator (the natural sink for a
    decode pipeline — decoded audio feeds models on the same devices).

    * ``windows()`` — raw device arrays per group (window-major layout)
    * ``sync()`` — block until every device window is materialized
    * ``to_numpy()`` — download everything; identical to output="numpy"
    """

    def __init__(self, owner, out, finalizers):
        self._owner = owner
        self._out = out
        self._finalizers = finalizers
        for _, g in finalizers:
            owner._note_seconds(g.kind, g.seconds())
        for i, v in enumerate(out):
            if isinstance(v, np.ndarray) and owner.decoders[i] is not None:
                owner._note_seconds(
                    type(owner.decoders[i]).__name__.replace("Decoder", "").lower(),
                    v.shape[0] / max(1, owner.decoders[i].sample_rate),
                )

    def windows(self):
        return [
            (g.kind, [p[0] for p in g.pending]) for _, g in self._finalizers
        ]

    def sync(self):
        """Force completion of all device work.  The window chain within a
        group is state-dependent, so the last window's materialization
        implies the whole group ran, and fetching one element of it
        waits for that."""
        for _, g in self._finalizers:
            for arr in g.last_arrays():
                idx = tuple(0 for _ in arr.shape)
                np.asarray(arr[idx])
        return self

    def to_numpy(self):
        out = list(self._out)
        for chunk, g in self._finalizers:
            res = g.finalize()
            for i, pcm in zip(chunk, res):
                out[i] = pcm
        return out


class BatchDecoder:
    """Decode a batch of streams; formats may be mixed (grouped internally).

    Usage::

        dec = BatchDecoder([b1, b2, path3, ...])
        pcm_list = dec.decode_all()       # list of (frames, ch) float32
        dec.stats                         # decoded seconds, per-lane errors
    """

    #: format-group kinds whose device programs have loaded in this
    #: process (first-dispatch deserialize/load is latency; fresh kinds
    #: get a temporary group-thread boost in decode_all)
    _SEEN_GROUP_KINDS: set = set()

    def __init__(self, items: Sequence, mesh=None, group_size: int = None):
        self.decoders: List[Optional[object]] = []
        self.errors: List[Optional[str]] = []
        self._trace = None
        self._hyb_delayed = {}
        self._mesh = mesh  # jax.sharding.Mesh: batch axis shards on 'data'
        #: lockstep group width.  With device-resident output the whole
        #: batch can ride one group (no per-window PCM download); when PCM
        #: is downloaded per window, keep groups moderate so fetches overlap
        #: the next group's host stage.
        self._group_size = group_size
        for item in items:
            try:
                src = _open_source(item)
                dec = models.probe_all(src)
                if dec is None:
                    raise AudioFormatError(
                        "Cannot decode stream: unrecognized encoding."
                    )
                self.decoders.append(dec)
                self.errors.append(None)
            except AudioFormatError as e:
                self.decoders.append(None)
                self.errors.append(e.message)
        self._stats_lock = threading.Lock()
        self.stats = {
            "decoded_seconds": 0.0,
            "decoded_seconds_by_format": {},
            "lanes": len(items),
            # per-stage split (SURVEY.md §5 observability): host entropy
            # parse ms, device enqueue (upload+dispatch) ms, PCM fetch ms,
            # bytes over the link each way, device windows issued.
            # NOTE: the aggregate wall counters (host_ms/enqueue_ms) can
            # EXCEED the batch wall when groups run concurrently (the
            # mixed-Opus lockstep thread and AF_TPU_GROUP_THREADS>1 time
            # their stages on their own threads) — per-format splits stay
            # correct, and host_cpu_ms is the load-scalable quantity
            "host_ms": 0.0,
            "enqueue_ms": 0.0,
            "fetch_ms": 0.0,
            "host_ms_by_format": {},
            "enqueue_ms_by_format": {},
            # host-stage THREAD CPU (time.thread_time, summed across parse
            # workers): the per-core cost a real multi-core host pays.  The
            # wall counters above over-count on a core-starved box, where
            # the OS timeshares the parse thread with the dispatch worker.
            "host_cpu_ms": 0.0,
            "host_cpu_ms_by_format": {},
            "h2d_bytes": 0,
            "h2d_bytes_by_format": {},
            "d2h_bytes": 0,
            "windows": 0,
            "group_demotions": 0,
        }

    def _stat_add(self, key: str, val, fmt: str = None):
        """Thread-safe stats accumulation: format groups may decode
        CONCURRENTLY (AF_TPU_GROUP_THREADS), and a bare ``+=`` on a dict
        entry is a read-modify-write race across threads."""
        with self._stats_lock:
            if fmt is None:
                self.stats[key] = self.stats.get(key, 0) + val
            else:
                by = self.stats[key]
                by[fmt] = by.get(fmt, 0.0) + val

    def _note_seconds(self, fmt: str, seconds: float):
        self._stat_add("decoded_seconds", seconds)
        self._stat_add("decoded_seconds_by_format", seconds, fmt=fmt)

    def _note_stage(self, key: str, fmt: str, t0: float,
                    cpu_t0: float = None):
        """Close a stage timer opened at ``t0``: accumulate both the
        aggregate stage counter (host_ms / enqueue_ms) and its per-format
        split (SURVEY §5.5 observability — the bench needs to say WHERE
        host time goes, not just how much there is).  ``cpu_t0`` (a
        time.thread_time anchor) additionally closes the thread-CPU
        counter — valid only when the stage ran on the calling thread;
        pooled stages call _note_host_cpu per lane CHUNK instead.

        NOTE on aggregation: stage WALL counters sum per-thread walls,
        so when groups decode concurrently (AF_TPU_GROUP_THREADS, the
        overlapped mixed-Opus thread) the aggregate host_ms/enqueue_ms
        can exceed — i.e. no longer decompose — the batch wall clock.
        Per-format splits stay meaningful; host_cpu_ms is the
        load-invariant quantity to compare across runs."""
        dt = (time.perf_counter() - t0) * 1e3
        self._stat_add(key, dt)
        self._stat_add(key + "_by_format", dt, fmt=fmt)
        if cpu_t0 is not None and key == "host_ms":
            cdt = (time.thread_time() - cpu_t0) * 1e3
            self._stat_add("host_cpu_ms", cdt)
            self._stat_add("host_cpu_ms_by_format", cdt, fmt=fmt)

    def _note_host_cpu(self, fmt: str, cpu_t0: float):
        """Per-lane thread-CPU accumulation for host stages that run on a
        parse pool (each worker measures its own thread)."""
        cdt = (time.thread_time() - cpu_t0) * 1e3
        self._stat_add("host_cpu_ms", cdt)
        self._stat_add("host_cpu_ms_by_format", cdt, fmt=fmt)

    def _reprobe(self, i):
        """Fresh decoder for lane i (a failed grouped run leaves decoder
        state mid-window); sets the lane error when the re-probe fails."""
        d = self.decoders[i]
        try:
            src = getattr(d, "_src", None)
            self.decoders[i] = (
                models.probe_all(src) if src is not None else None
            )
        except Exception:
            self.decoders[i] = None
        if self.decoders[i] is None and self.errors[i] is None:
            self.errors[i] = "Cannot decode stream: data is corrupt."

    def _run_group(self, fn, chunk, *args, to_device: bool = False):
        """Run a lockstep group decode with the error lattice intact: a lane
        that raises inside the grouped device path must not abort the other
        lanes.  Demotion is PER-LANE, not per-group: on a failure the chunk
        bisects (each half re-probed to fresh decoders, then re-run grouped),
        so one poisoned lane costs O(log G) grouped re-runs — ~2x one
        group's work — while the innocent lanes stay on the device path.
        Only a failing single-lane chunk leaves the grouped path entirely
        (stats["lanes_demoted"]); the per-stream fallback then decodes it
        with its own error handling.  The exception class is recorded in
        stats["group_exceptions"] so genuine code bugs don't masquerade as
        corrupt data (the reference's analogue is the per-stream sticky
        error of stream.d:424-427, scaled to the batch lattice)."""
        try:
            return fn([self.decoders[i] for i in chunk], *args,
                      to_device=to_device)
        except Exception as e:
            self._stat_add("group_demotions", 1)
            with self._stats_lock:
                excs = self.stats.setdefault("group_exceptions", [])
                if len(excs) < 32:
                    excs.append(f"{type(e).__name__}: {e}")
            if len(chunk) == 1:
                self._stat_add("lanes_demoted", 1)
                self._reprobe(chunk[0])
                return [None]
            mid = len(chunk) // 2
            out = []
            for half in (chunk[:mid], chunk[mid:]):
                for i in half:
                    self._reprobe(i)
                live = [i for i in half if self.decoders[i] is not None]
                res = {i: None for i in half}
                if live:
                    sub = self._run_group(fn, live, *args,
                                          to_device=to_device)
                    if isinstance(sub, _PendingGroup):
                        sub = sub.finalize()
                    res.update(zip(live, sub))
                out.extend(res[i] for i in half)
            return out

    # ------------------------------------------------------------------ API
    def decode_all(self, output: str = "numpy"):
        """Decode every stream to completion.

        output="numpy" (default): returns per-lane PCM arrays (None for
        errored lanes) — every sample crosses back to the host.

        output="device": PCM stays resident on the accelerator (the natural
        sink for a decode pipeline: decoded audio feeds models on the
        same device).  Returns a :class:`DeviceBatchResult`; call ``.sync()``
        to block until all device work is done, ``.to_numpy()`` to download
        and get exactly the output="numpy" result.
        """
        import os as _os

        trace_path = _os.environ.get("AF_TPU_PROFILE")
        if trace_path and self._trace is None:
            # SURVEY §5.1 tracing: record per-stage spans (host parse,
            # enqueue, fetch, per group kind) as a Chrome-trace JSON --
            # open in Perfetto / chrome://tracing.  Events piggyback on
            # the stats stage timers, so the trace and the JSON split
            # always agree.  Set AF_TPU_PROFILE_XLA to a directory to also
            # capture a jax.profiler device trace.)
            self._trace = _StageTrace(trace_path)
            self.stats = self._trace.wrap(self.stats)
            xla_dir = _os.environ.get("AF_TPU_PROFILE_XLA")
            if xla_dir:
                import jax as _jax

                _jax.profiler.start_trace(xla_dir)
                self._trace.xla = True
        try:
            return self._decode_all_impl(output)
        finally:
            if self._trace is not None:
                self._trace.flush()

    def _decode_all_impl(self, output: str = "numpy"):
        to_device = output == "device"
        out: List[Optional[object]] = [None] * len(self.decoders)
        finalizers = []

        mp3_groups = {}
        l12_groups = {}
        flac_groups = {}
        opus_groups = {}
        silk_groups = {}
        hybrid_groups = {}
        opus_mixed_groups = {}
        qoa_groups = {}
        wav_groups = {}
        vorbis_groups = {}
        for i, d in enumerate(self.decoders):
            if isinstance(d, Mp3Decoder) and d._layer == 3:
                mp3_groups.setdefault((d.channels, d._mpeg1), []).append(i)
            elif isinstance(d, Mp3Decoder):
                # Layers I/II: no bit reservoir, so frames are independent
                # subband blocks — host parses, ONE synthesis FIR per window
                l12_groups.setdefault((d.channels, d._layer), []).append(i)
            elif isinstance(d, FlacDecoder):
                # >16 bps lanes ride the exact int32-limb LPC path and the
                # full-width output; frames beyond the device limb range
                # (shift > 18) demote per-frame inside the group
                flac_groups.setdefault(d.channels, []).append(i)
            elif isinstance(d, OpusDecoder) and self._opus_eligible(d):
                opus_groups.setdefault(d.channels, []).append(i)
            elif isinstance(d, OpusDecoder) and self._silk_eligible(d):
                pk0 = d._silk_lockstep[0]
                silk_groups.setdefault(
                    (d.channels, pk0["config"], pk0["stereo"],
                     len(pk0["frames"])), []
                ).append(i)
            elif isinstance(d, OpusDecoder) and self._hybrid_eligible(d):
                pk0 = d._silk_lockstep[0]
                hybrid_groups.setdefault(
                    (d.channels, pk0["config"], pk0["stereo"]), []
                ).append(i)
            elif isinstance(d, OpusDecoder) and \
                    self._opus_mixed_eligible(d):
                opus_mixed_groups.setdefault(d.channels, []).append(i)
            elif isinstance(d, QoaDecoder):
                qoa_groups.setdefault(d.channels, []).append(i)
            elif (isinstance(d, WavDecoder)
                  and d._audio_format == _LINEAR_PCM):
                kind = {1: "u8", 2: "s16", 3: "s24",
                        4: "s32"}[d._byte_per_sample]
                wav_groups.setdefault(kind, []).append(i)
            elif isinstance(d, VorbisDecoder):
                # block sizes join the key: the device window chain bakes
                # (bs0, bs1) into its static IMDCT/slope constants
                vorbis_groups.setdefault(
                    (d.channels, d._bs0, d._bs1), []).append(i)

        GROUP = self._group_size or (1024 if to_device else 256)

        def run(chunk, fn, *args):
            res = self._run_group(fn, chunk, *args, to_device=to_device)
            if isinstance(res, _PendingGroup):
                finalizers.append((chunk, res))
                for i in chunk:
                    out[i] = res  # placeholder: resolved by to_numpy()
            else:
                for i, pcm in zip(chunk, res):
                    out[i] = pcm

        jobs = []

        def plan(chunk, fn, *args):
            jobs.append((chunk, fn, args))

        for (nch, mpeg1), lanes in mp3_groups.items():
            for c in range(0, len(lanes), GROUP):
                plan(lanes[c : c + GROUP], self._decode_mp3_group, nch,
                     2 if mpeg1 else 1)
        for (nch, layer), lanes in l12_groups.items():
            for c in range(0, len(lanes), GROUP):
                plan(lanes[c : c + GROUP], self._decode_l12_group, nch)
        for nch, lanes in flac_groups.items():
            for c in range(0, len(lanes), GROUP):
                plan(lanes[c : c + GROUP], self._decode_flac_group, nch)
        for nch, lanes in qoa_groups.items():
            for c in range(0, len(lanes), GROUP):
                plan(lanes[c : c + GROUP], self._decode_qoa_group, nch)
        for kind, lanes in wav_groups.items():
            for c in range(0, len(lanes), GROUP):
                plan(lanes[c : c + GROUP], self._decode_wav_group, kind)
        for (nch, _bs0, _bs1), lanes in vorbis_groups.items():
            for c in range(0, len(lanes), GROUP):
                plan(lanes[c : c + GROUP], self._decode_vorbis_group, nch)
        # format groups run CONCURRENTLY on multi-core hosts (lane sets
        # are disjoint; stats ride _stat_add's lock): one group's host
        # parse and C entropy stage overlap another group's uploads and
        # device windows.  On a 1-core host concurrency contends instead,
        # so the default adapts to the core count (chosen on the previous
        # accelerator's host; not re-measured on the GPU host).
        default_threads = "2" if (os.cpu_count() or 1) > 1 else "1"
        conc = int(os.environ.get("AF_TPU_GROUP_THREADS",
                                  default_threads)) \
            if self._mesh is None else 1
        # First sight of a format-group kind in this process: its device
        # programs still deserialize/load at first dispatch — LATENCY,
        # not CPU — so group threads overlap those loads even where the
        # 1-core default is serial (same rationale as the mixed-Opus
        # thread below).  Warm batches see no fresh kinds and keep the
        # adaptive default.  Kept until a GPU cell shows whether it pays.
        kinds = {fn.__name__ for _c, fn, _a in jobs}
        fresh_kinds = kinds - BatchDecoder._SEEN_GROUP_KINDS
        if fresh_kinds and conc == 1 and self._mesh is None \
                and len(jobs) > 1 \
                and os.environ.get("AF_TPU_GROUP_THREADS") is None:
            # scale with the number of distinct groups: loads are round
            # trips, so wider overlap keeps helping while the CPU cost of
            # an extra idle-waiting thread is nil
            conc = min(4, len(jobs))
        # the mode-switching Opus lockstep blocks on one small device
        # round trip per window round — LATENCY, not CPU — so it overlaps
        # the other groups' host work even on a 1-core host.  Under a
        # mesh the collective order must stay deterministic across
        # participants, so it stays serial there.
        mixed_thread = None
        mixed_err = []
        if opus_mixed_groups and self._mesh is None:
            import threading

            def _run_mixed():
                try:
                    for nch, lanes in opus_mixed_groups.items():
                        for c in range(0, len(lanes), GROUP):
                            chunk = lanes[c : c + GROUP]
                            res = self._run_group(
                                self._decode_opus_mixed_group, chunk)
                            for i, pcm in zip(chunk, res):
                                out[i] = pcm
                except BaseException as e:  # re-raised on the main thread
                    mixed_err.append(e)

            mixed_thread = threading.Thread(
                target=_run_mixed, name="af-opus-mixed")
            mixed_thread.start()
        # the concurrent mixed-Opus thread must be joined even when a
        # serial group decode raises: an orphaned thread would keep
        # dispatching device work and mutating `out` during unwinding
        try:
            if conc > 1 and len(jobs) > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=conc) as ex:
                    list(ex.map(lambda j: run(j[0], j[1], *j[2]), jobs))
            else:
                for chunk, fn, args in jobs:
                    run(chunk, fn, *args)
            for nch, lanes in opus_groups.items():
                for c in range(0, len(lanes), GROUP):
                    chunk = lanes[c : c + GROUP]
                    res = self._run_group(self._decode_opus_group, chunk)
                    for i, pcm in zip(chunk, res):
                        out[i] = pcm
            for (nch, config, stereo, nfr), lanes in silk_groups.items():
                for c in range(0, len(lanes), GROUP):
                    chunk = lanes[c : c + GROUP]
                    res = self._run_group(
                        self._decode_silk_group, chunk, nch, config,
                        stereo, nfr)
                    for i, pcm in zip(chunk, res):
                        out[i] = pcm
            for (nch, config, stereo), lanes in hybrid_groups.items():
                for c in range(0, len(lanes), GROUP):
                    chunk = lanes[c : c + GROUP]
                    res = self._run_group(
                        self._decode_hybrid_group, chunk, nch, config,
                        stereo)
                    for i, pcm in zip(chunk, res):
                        out[i] = pcm
        finally:
            if mixed_thread is not None:
                mixed_thread.join()
        if mixed_thread is not None:
            if mixed_err:
                raise mixed_err[0]
        else:
            for nch, lanes in opus_mixed_groups.items():
                for c in range(0, len(lanes), GROUP):
                    chunk = lanes[c : c + GROUP]
                    res = self._run_group(
                        self._decode_opus_mixed_group, chunk)
                    for i, pcm in zip(chunk, res):
                        out[i] = pcm

        # every group decode succeeded: these kinds' device programs are
        # resident now — later batches keep the adaptive default
        BatchDecoder._SEEN_GROUP_KINDS |= kinds

        # remaining formats: per-stream streaming read
        for i, d in enumerate(self.decoders):
            if d is None or out[i] is not None:
                continue
            try:
                chunks = []
                while True:
                    c = d.read(1 << 16)
                    if c.shape[0] == 0:
                        break
                    chunks.append(c)
                out[i] = (
                    np.concatenate(chunks)
                    if chunks
                    else np.zeros((0, d.channels), np.float32)
                )
            except AudioFormatError as e:
                self.errors[i] = e.message

        if to_device:
            return DeviceBatchResult(self, out, finalizers)
        for i, pcm in enumerate(out):
            if pcm is not None and self.decoders[i] is not None:
                self._note_seconds(
                    type(self.decoders[i]).__name__.replace("Decoder", "").lower(),
                    pcm.shape[0] / max(1, self.decoders[i].sample_rate),
                )
        return out

    # ------------------------------------------------- batched MP3 lockstep
    def _decode_l12_group(self, decs, nch: int, to_device: bool = False):
        """Layer I/II lockstep: no bit reservoir, so frames are independent
        subband blocks (minimp3.d:286-486).  The host parses W frames per
        lane into scf-applied slot tensors; ONE batched synthesis FIR per
        window (ops/mp3_dsp.mp3_synth_slots) with carried slot history
        turns the whole group into PCM.  Corrupt frames vanish from a
        lane's slot sequence exactly like the facade (shist untouched)."""
        W = 24
        layer = decs[0]._layer
        spf_slots = 12 if layer == 1 else 36
        TS = W * spf_slots
        B = len(decs)
        Bp = max(8, 1 << (B - 1).bit_length()) if B <= 128 \
            else -(-B // 128) * 128
        shist = np.zeros((Bp, nch, 16, 32), np.float32)
        dev_state = {"shist": shist}
        offs = [d._offset for d in decs]
        active = np.ones(B, bool)
        pending = []
        while active.any():
            t_host = time.perf_counter()
            ct_host = time.thread_time()
            Sarr = np.zeros((Bp, nch, TS, 32), np.float32)
            n_slots = np.zeros(Bp, np.int32)
            for bi, d in enumerate(decs):
                if not active[bi]:
                    continue
                got = 0
                while got < W:
                    if offs[bi] >= len(d._view) - 4:
                        active[bi] = False
                        break
                    S2, fb = d._l12_parse_subbands(offs[bi])
                    if S2 is None:
                        if fb:
                            offs[bi] += fb
                            continue
                        active[bi] = False
                        break
                    offs[bi] += fb
                    Sarr[bi, :, got * spf_slots : got * spf_slots
                         + S2.shape[1]] = S2
                    got += 1
                n_slots[bi] = got * spf_slots
                d._cur_sample += got * d._spf * nch
                d._offset = offs[bi]
            self._note_stage("host_ms", "mp3_l12", t_host, ct_host)
            if not n_slots.any():
                break
            t_enq = time.perf_counter()
            (S_d, sh_d) = _shard_batch(self._mesh, Sarr,
                                       dev_state["shist"])
            pcm, sh2 = mp3_dsp.mp3_synth_slots(S_d, sh_d, nch=nch)
            dev_state["shist"] = sh2
            _prefetch(pcm, to_device)
            self._note_stage("enqueue_ms", "mp3_l12", t_enq)
            self._stat_add("h2d_bytes", Sarr.nbytes)
            self._stat_add("h2d_bytes_by_format", Sarr.nbytes, fmt="l12")
            self._stat_add("windows", 1)
            pending.append((pcm, n_slots.copy()))
        group = _PendingGroup(self, "mp3", decs, pending,
                              self._l12_finalize, (decs, pending, nch))
        return group if to_device else group.finalize()

    def _l12_finalize(self, decs, pending, nch):
        t0 = time.perf_counter()
        outs = [[] for _ in decs]
        for pcm_dev, n_slots in pending:
            arr = np.asarray(pcm_dev)  # [Bp, nch, TS*32]
            self._stat_add("d2h_bytes", arr.nbytes)
            for bi in range(len(decs)):
                k = int(n_slots[bi]) * 32
                if k:
                    outs[bi].append(arr[bi, :, :k].T)
        t_res = []
        for bi, d in enumerate(decs):
            full = np.concatenate(outs[bi]) if outs[bi] else \
                np.zeros((0, nch), np.float32)
            skip = d._start_delay // max(1, nch)
            full = full[skip:]
            if d._total_samples:
                full = full[: d._total_samples // max(1, nch)]
            t_res.append(np.ascontiguousarray(full.astype(np.float32)))
        self._stat_add("fetch_ms", (time.perf_counter() - t0) * 1e3)
        return t_res

    def _decode_mp3_group(self, decs: List[Mp3Decoder], nch: int, ngr: int,
                          to_device: bool = False):
        import os

        from ..host import native as _native

        lib = _native.get_lib()
        if lib is None:
            pending = self._decode_mp3_group_py(decs, nch, ngr, to_device)
            group = _PendingGroup(self, "mp3", decs, pending,
                                  self._mp3_finalize, (decs, pending, nch))
            return group if to_device else group.finalize()

        # device-Huffman path: intensity-stereo frames ride it too (the
        # per-band pan mix runs on device from the shipped ist plane,
        # ops/mp3_huff._intensity_abcd)
        use_packed = not os.environ.get("AF_TPU_NO_DEVICE_HUFF")
        packed = list(decs) if use_packed else []
        classic = [d for d in decs if id(d) not in {id(p) for p in packed}]
        pending, demoted = ([], [])
        if packed:
            pending, demoted = self._decode_mp3_group_packed(
                packed, nch, ngr, lib, to_device)
        redo = classic + [models.probe_all(d._src) for d in demoted]
        results = {}
        if redo:
            pend_c = self._decode_mp3_group_native(redo, nch, ngr, lib)
            res_c = self._mp3_finalize(redo, pend_c, nch)
            keys = [id(d) for d in classic] + [id(d) for d in demoted]
            for k, pcm in zip(keys, res_c):
                results[k] = pcm

        group = _PendingGroup(self, "mp3", decs, pending,
                              self._mp3_finalize_mixed,
                              (decs, packed, pending, results, nch))
        return group if to_device else group.finalize()

    def _mp3_finalize_mixed(self, decs, packed, pending, results, nch):
        """Merge device-window lanes (packed pending) with lanes decoded
        via the classic fallback (demoted or intensity streams)."""
        if pending:
            packed_res = self._mp3_finalize(packed, pending, nch)
            for d, pcm in zip(packed, packed_res):
                if id(d) not in results:  # demoted lanes keep classic result
                    results[id(d)] = pcm
        return [results[id(d)] for d in decs]

    def _decode_mp3_group_packed(self, decs, nch: int, ngr: int, lib,
                                 to_device: bool = False):
        """Device-Huffman scheduling: the host emits per-lane Huffman bit
        rows + side info (~compressed size); the device runs the vectorized
        Huffman FSM, dequant, reorder, mid/side mix and the window DSP
        (ops/mp3_huff.py).  Upload per window is ~35× smaller than the
        classic dequantized-spectrum path.

        Returns (pending, demoted): demoted decoders hit a mid-stream
        intensity-stereo frame and must re-decode via the classic path.
        """
        from ..host import native as _native
        from ..ops import mp3_huff

        B = len(decs)
        Bp = max(8, 1 << (B - 1).bit_length()) if B <= 128 \
            else -(-B // 128) * 128
        W = MP3_WINDOW_FRAMES
        G = W * ngr
        NL = G * nch
        LW = _native.LANE_WORDS
        overlap = np.zeros((Bp, nch, 32, 18), np.float32)
        shist = np.zeros((Bp, nch, 16, 32), np.float32)
        active = np.ones(B, bool)
        demoted = []
        states = []
        for d in decs:
            rb = np.zeros(511, np.uint8)
            rl = np.zeros(1, np.int32)
            cur = d._reserv_buf
            if cur:
                rb[: len(cur)] = np.frombuffer(cur, np.uint8)
                rl[0] = min(d._reserv, len(cur))
            states.append((rb, rl, d._ist_pos))

        pending = []
        # host/device overlap: the worker thread owns the device dispatch
        # (the arg upload blocks and releases the GIL), so window t+1's C
        # parse overlaps window t's upload+dispatch — the SURVEY §2.4
        # host-pool/pipelining requirement
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=1)
        dev_state = {"overlap": overlap, "shist": shist}

        def _dispatch(blob, n_act_arr, pats, spats, L, Wb, R, Lb, Wext,
                      nbig_b, nc1_b, ist_f, pool_w=None):
            t_put = time.perf_counter()
            (blob_d, ov, sh, n_act_d) = _shard_batch(
                self._mesh, blob, dev_state["overlap"], dev_state["shist"],
                n_act_arr)
            pw = 0
            pool_d = None
            if pool_w is not None:
                import jax

                # exact-size upload; bucket padding happens on device so
                # the wire carries only the copied maindata words
                pw = mp3_huff.pool_bucket(pool_w.size)
                pool_d = mp3_huff.pad_pool_words(jax.device_put(pool_w), pw)
            self._stat_add("disp_mp3_put_ms",
                           (time.perf_counter() - t_put) * 1e3)
            t_call = time.perf_counter()
            pcm, ov2, sh2 = mp3_huff.packed_window_blob(
                blob_d, ov, sh, n_act_d, pats=pats, spats=spats,
                L=L, Wb=Wb, R=R, B=Bp, G=G, nch=nch, Lb=Lb, Wext=Wext,
                NBIG=nbig_b, NC1=nc1_b, IST=ist_f, MPEG1=(ngr == 2),
                pool=pool_d, PW=pw,
            )
            dev_state["overlap"] = ov2
            dev_state["shist"] = sh2
            self._stat_add("disp_mp3_call_ms",
                           (time.perf_counter() - t_call) * 1e3)
            _prefetch(pcm, to_device)
            return pcm

        # host parse pool: SURVEY §2.4's multi-threaded host stage — the
        # C window parse releases the GIL, so lanes parse concurrently on
        # multi-core hosts (on a 1-core host it degenerates to serial)
        import os as _os

        n_workers = max(1, min(8, (_os.cpu_count() or 1)))
        parse_pool = ThreadPoolExecutor(max_workers=n_workers) \
            if n_workers > 1 else None
        # pooled exact-wire bit plane: opt-in (bench.py turns it on); the
        # mesh path keeps the L-major split planes, whose layout shards
        # cleanly on the batch axis
        pool_bits = (
            self._mesh is None
            and _os.environ.get("AF_TPU_MP3_POOL_BITS", "")
            not in ("", "0")
        )

        # multi-lane FFI surface: ONE C call per lane chunk
        # (af_mp3_parse_window_packed_multi).  Per-lane state lives as
        # batch-contiguous rows so C derives lane pointers from
        # base + lane * stride; the per-lane ctypes crossing this
        # replaces cost more Python marshalling than the C parse itself
        # (~1.5 s at batch 1024).
        multi = lib is not None and hasattr(
            lib, "af_mp3_parse_window_packed_multi")
        if multi:
            data_keep = []
            data_ptrs = np.zeros(Bp, np.uint64)
            data_lens = np.zeros(Bp, np.int64)
            offs_a = np.zeros(Bp, np.int64)
            hdr0s = np.zeros((Bp, 4), np.uint8)
            ffb = np.zeros(Bp, np.int32)
            rb_all = np.zeros((Bp, 511), np.uint8)
            rl_all = np.zeros(Bp, np.int32)
            ist_all = np.zeros((Bp, 2, 40), np.int32)
            for bi, d in enumerate(decs):
                addr, nb, keep = _native.buf_addr(d._view)
                data_keep.append(keep)
                data_ptrs[bi] = addr
                data_lens[bi] = nb
                offs_a[bi] = d._offset
                hdr0s[bi] = np.frombuffer(d._hdr0, np.uint8, 4)
                ffb[bi] = d._free_format_bytes
                rb, rl, ip = states[bi]
                rb_all[bi] = rb
                rl_all[bi] = rl[0]
                ist_all[bi] = ip
            flags_all = np.zeros((Bp, W), np.uint8)
            aa_all = np.zeros((Bp, G, nch), np.int32)
            wt_all = np.zeros((Bp, G, nch, 32), np.int32)
            n_out = np.zeros(Bp, np.int32)
            mw_all = np.zeros(Bp, np.int32)
            _idxW = np.arange(W)

        def _parse_chunk_multi(lanes):
            # thread-CPU sampled per CHUNK, not per lane: where
            # time.thread_time is a trapped syscall, two probes per lane
            # cost a visible share of the end-to-end wall
            _ct0 = time.thread_time()
            try:
                gated = []
                for bi in lanes:
                    d = decs[bi]
                    if offs_a[bi] >= data_lens[bi] - 4 or (
                        d._total_samples
                        and d._cur_sample >= d._total_samples
                    ):
                        active[bi] = False
                    else:
                        gated.append(bi)
                if gated:
                    _native.mp3_parse_window_packed_multi(
                        lib, gated, data_ptrs, data_lens, offs_a, hdr0s,
                        W, ffb, rb_all, rl_all, ist_all, bits, mw_all,
                        meta, scfq, ists if nch == 2 else None,
                        aa_all, wt_all, flags_all, n_out)
                return gated
            finally:
                self._note_host_cpu("mp3", _ct0)

        def _parse_chunk(lanes):
            # per-lane fallback (older .so without the multi symbol)
            _ct0 = time.thread_time()
            try:
                return [_parse_lane_inner(bi) for bi in lanes]
            finally:
                self._note_host_cpu("mp3", _ct0)

        def _parse_lane_inner(bi):
            d = decs[bi]
            if d._offset >= len(d._view) - 4 or (
                d._total_samples
                and d._cur_sample >= d._total_samples
            ):
                active[bi] = False
                return 16
            flags = np.zeros(W, np.uint8)
            aa_l = np.zeros((G, nch), np.int32)   # C fills; device rebuilds
            wt_l = np.zeros((G, nch, 32), np.int32)
            n, new_off, mw, has_ist = _native.mp3_parse_window_packed(
                lib, d._view, d._offset, d._hdr0, W, ngr, nch,
                states[bi], bits[bi], meta[bi], scfq[bi],
                aa_l, wt_l, flags,
                free_format_bytes=d._free_format_bytes,
                ist=ists[bi] if nch == 2 else None,
            )
            d._offset = new_off
            win_ist[bi] = has_ist
            if n == 0:
                active[bi] = False
                return 16
            fr_act = (flags[:n] & 1).astype(bool)
            n_fr = int(fr_act.sum())
            if n_fr and not fr_act[:n_fr].all():
                # compact silent-frame holes to the prefix contract
                li = np.flatnonzero(np.repeat(fr_act, ngr * nch))
                bits[bi, : len(li)] = bits[bi, li]
                meta[bi, : len(li)] = meta[bi, li]
                scfq[bi, : len(li)] = scfq[bi, li]
                meta[bi, len(li):] = 0
                gi = np.flatnonzero(np.repeat(fr_act, ngr))
                ists[bi, : len(gi)] = ists[bi, gi]
                ists[bi, len(gi):] = 0
            n_act[bi] = n_fr * ngr
            d._cur_sample += n_fr * ngr * 576 * nch
            if n < W:
                active[bi] = False
            return mw

        def _post_parse_multi(gated):
            """Vectorized post-pass over the chunk-parsed lanes: frame
            activity, intensity flags, rare silent-hole compaction, and
            the per-decoder scalar state — one numpy pass instead of a
            per-lane loop over lanes x windows."""
            if not gated:
                return 16
            g = np.asarray(gated, np.int64)
            ng = n_out[g]
            fl = flags_all[g]
            validm = _idxW[None, :] < ng[:, None]
            actm = ((fl & 1) != 0) & validm
            n_fr_g = actm.sum(1)
            win_ist[g] = (((fl & 4) != 0) & validm).any(1)
            n_act[g] = (n_fr_g * ngr).astype(np.int32)
            pref = actm.cumsum(1)
            hole = np.zeros(g.size, bool)
            nz = n_fr_g > 0
            hole[nz] = pref[nz, n_fr_g[nz] - 1] < n_fr_g[nz]
            for i in np.flatnonzero(hole):
                bi = int(g[i])
                # compact silent-frame holes to the prefix contract
                li = np.flatnonzero(np.repeat(actm[i], ngr * nch))
                bits[bi, : len(li)] = bits[bi, li]
                meta[bi, : len(li)] = meta[bi, li]
                scfq[bi, : len(li)] = scfq[bi, li]
                meta[bi, len(li):] = 0
                gi = np.flatnonzero(np.repeat(actm[i], ngr))
                ists[bi, : len(gi)] = ists[bi, gi]
                ists[bi, len(gi):] = 0
            ng_l = ng.tolist()
            nfr_l = n_fr_g.tolist()
            offs_l = offs_a[g].tolist()
            for i, bi in enumerate(gated):
                d = decs[bi]
                d._offset = offs_l[i]
                d._cur_sample += nfr_l[i] * ngr * 576 * nch
                if ng_l[i] < W:
                    active[bi] = False
            return max(16, int(mw_all[g].max()))

        try:
            while active.any():
                t_host = time.perf_counter()
                bits = np.empty((Bp, NL, LW), np.uint32)
                meta = np.zeros((Bp, NL, 16), np.int32)
                scfq = np.zeros((Bp, NL, 40), np.int16)
                ists = np.zeros((Bp, G, 40), np.int16)
                win_ist = np.zeros(Bp, bool)
                n_act = np.zeros(Bp, np.int32)
                live_lanes = [bi for bi in range(B) if active[bi]]
                if multi:
                    if parse_pool is not None:
                        gated = [bi for sub in parse_pool.map(
                            _parse_chunk_multi,
                            _lane_chunks(live_lanes, n_workers))
                            for bi in sub]
                    else:
                        gated = _parse_chunk_multi(live_lanes)
                    mw_max = _post_parse_multi(gated)
                elif parse_pool is not None:
                    mws = [m for sub in parse_pool.map(
                        _parse_chunk, _lane_chunks(live_lanes, n_workers))
                        for m in sub]
                    mw_max = max([16] + mws)
                else:
                    mw_max = max([16] + _parse_chunk(live_lanes))
                self._note_stage("host_ms", "mp3", t_host)
                if not n_act.any():
                    break
                t_enq = time.perf_counter()
                # static buckets kept coarse (row words / overflow rows) so the
                # compiled variant count stays tiny; the window's Huffman
                # breakpoint set rides as RUNTIME arrays padded to an R bucket
                lanew = meta[:, :, 0].reshape(-1)
                if pool_bits:
                    # pooled exact-wire bit plane (blob_layout PB): rows are
                    # rebuilt on device from per-lane spans, so no bit-plane
                    # plan is needed and Wb is just the window-max bucket
                    Wb = next(w for w in (16, 24, 32, 48, 64, 96, LW)
                              if mw_max <= w)
                    Lb = Wext = 0
                else:
                    Wb, Lb, Wext = mp3_huff.bits_plan(
                        lanew, mw_max, Bp * NL, LW)
                live = meta[:, :, 2] > 0
                # scan lengths sized to the window's actual big-values /
                # count1 region (static buckets; spec maxima only when needed)
                nbig_b, nc1_b = mp3_huff.scan_buckets(
                    meta[:, :, 3][live], mp3_huff.TOTAL_W[meta[:, :, 10][live]])
                pats = tuple(sorted(
                    int(p) for p in np.unique(meta[:, :, 10][live])
                )) or (0,)
                tabs = meta[:, :, 6:9]
                cids = {int(mp3_huff.CODE_ID[t])
                        for t in np.unique(tabs[live])} or {0}
                starts, d_pack, rank_of = \
                    mp3_huff.breakpoints_for_window(cids)
                spats = tuple(p for p in pats if p in mp3_huff.SHORT_PATTERNS)
                L = Bp * NL
                R = starts.size
                # ONE u32 blob per window (bits ‖ meta ‖ scf ‖ breakpoints):
                # every transfer pays a fixed cost, so the whole window
                # ships as one upload + one fused execute
                ranks = rank_of[tabs]                      # [Bp, NL, 3]
                lins = mp3_huff.LINBITS_TAB[tabs]
                meta16 = np.concatenate([
                    meta[:, :, [1, 2, 3, 4, 5]], ranks, lins,
                    meta[:, :, [9, 10, 11, 12]],
                    np.zeros((Bp, NL, 1), meta.dtype),     # col 15: ovf row
                ], axis=2).astype(np.int16).reshape(L, 16)
                ist_f = bool(win_ist.any()) and nch == 2
                self._stat_add("enq_mp3_plan_ms",
                               (time.perf_counter() - t_enq) * 1e3)
                t_poolw = time.perf_counter()
                pool_w = None
                if pool_bits:
                    flat = bits.reshape(L, LW)
                    sp = np.minimum(lanew, LW)
                    meta16[:, 15] = sp.astype(np.int16)
                    if lib is not None:
                        # one C pass copying each lane's true span —
                        # replaces the boolean fancy-index (mask temp +
                        # compaction pass over the full [L, LW] plane)
                        import ctypes as _ct

                        sp32 = np.ascontiguousarray(sp, np.int32)
                        pool_w = np.empty(int(sp32.sum()), np.uint32)
                        _u32p = _ct.POINTER(_ct.c_uint32)
                        lib.af_u32_pack_prefix_rows(
                            flat.ctypes.data_as(_u32p), L, LW,
                            sp32.ctypes.data_as(
                                _ct.POINTER(_ct.c_int32)),
                            pool_w.ctypes.data_as(_u32p))
                    else:
                        pool_w = flat[np.arange(LW)[None, :] < sp[:, None]]
                self._stat_add("enq_mp3_poolw_ms",
                               (time.perf_counter() - t_poolw) * 1e3)
                t_blob = time.perf_counter()
                n_bits, n_ovf, n_meta, n_scf, n_ist, n_bp, total = \
                    mp3_huff.blob_layout(L, Wb, R, Lb, Wext, ist_f, nch,
                                         PB=pool_bits)
                blob = np.empty(total, np.uint32)
                o = 0
                if not pool_bits:
                    blob[o : o + n_bits] = bits[:, :, :Wb].reshape(-1)
                    o += n_bits
                if Lb:
                    # tail words of the overflowing lanes (row 0 stays zero
                    # so non-overflowing lanes read zeros past their span)
                    flat = bits.reshape(L, LW)
                    over = np.flatnonzero(lanew > Wb)
                    ovf = np.zeros((Lb, Wext), np.uint32)
                    ovf[1 : 1 + over.size] = flat[over, Wb : Wb + Wext]
                    meta16[over, 15] = np.arange(
                        1, 1 + over.size, dtype=np.int16)
                    blob[o : o + n_ovf] = ovf.reshape(-1)
                    o += n_ovf
                blob[o : o + n_meta] = meta16.reshape(-1).view(np.uint32)
                o += n_meta
                blob[o : o + n_scf] = scfq.reshape(-1).view(np.uint32)
                o += n_scf
                if ist_f:
                    blob[o : o + n_ist] = ists.reshape(-1).view(np.uint32)
                    o += n_ist
                blob[o : o + n_bp] = np.ascontiguousarray(
                    np.stack([starts, d_pack], axis=1)
                ).reshape(-1).view(np.uint32)
                blob_nb = blob.nbytes
                poolw_nb = pool_w.nbytes if pool_w is not None else 0
                self._stat_add("enq_mp3_blob_ms",
                               (time.perf_counter() - t_blob) * 1e3)
                fut = pool.submit(_dispatch, blob, n_act.copy(), pats, spats,
                                  L, Wb, R, Lb, Wext, nbig_b, nc1_b, ist_f,
                                  pool_w)
                self._note_stage("enqueue_ms", "mp3", t_enq)
                self._stat_add("h2d_bytes",
                               blob_nb + n_act.nbytes + poolw_nb)
                self._stat_add("h2d_bytes_by_format", blob_nb + n_act.nbytes + poolw_nb, fmt="mp3")
                self._stat_add("windows", 1)
                pending.append((fut, n_act.copy()))
        finally:
            # a lane fault raising out of the window loop must not
            # leak the dispatch/parse workers (bisect recovery
            # re-invokes this function on a poisoned chunk)
            pool.shutdown(wait=True)
            if parse_pool is not None:
                parse_pool.shutdown(wait=True)
        if multi:
            # the multi path parses against the batch copy of the
            # persistent intensity positions; write back so chunked
            # reads continue correctly across groups
            for bi, d in enumerate(decs):
                d._ist_pos[:] = ist_all[bi]
        pending = [(f.result(), n) for f, n in pending]
        return pending, demoted

    def _decode_mp3_group_native(self, decs, nch: int, ngr: int, lib,
                                 to_device: bool = False):
        """Window-at-a-time native host stage: ONE C call per
        (stream, window) does header walk, side info, reservoir splice,
        scalefactors, Huffman, and stereo/reorder/window tensor assembly
        (af_host.cc:af_mp3_parse_window)."""
        from ..host import native as _native

        B = len(decs)
        Bp = max(8, 1 << (B - 1).bit_length()) if B <= 128 \
            else -(-B // 128) * 128
        W = MP3_WINDOW_FRAMES
        G = W * ngr
        overlap = np.zeros((Bp, nch, 32, 18), dtype=np.float32)
        shist = np.zeros((Bp, nch, 16, 32), dtype=np.float32)
        active = np.ones(B, dtype=bool)
        # per-lane host state mirrors: reservoir + intensity positions
        states = []
        for d in decs:
            rb = np.zeros(511, np.uint8)
            rl = np.zeros(1, np.int32)
            cur = d._reserv_buf
            if cur:
                rb[: len(cur)] = np.frombuffer(cur, np.uint8)
                rl[0] = min(d._reserv, len(cur))
            states.append((rb, rl, d._ist_pos))

        pending = []
        while active.any():
            t_host = time.perf_counter()
            ct_host = time.thread_time()
            xq = np.zeros((Bp, G, nch, 576), np.float32)
            aa = np.full((Bp, G, nch), 31, np.int32)
            wt = np.zeros((Bp, G, nch, 32), np.int32)
            n_act = np.zeros(Bp, np.int32)
            flags = np.zeros(W, np.uint8)
            has_short = False

            for bi, d in enumerate(decs):
                if not active[bi]:
                    continue
                if d._offset >= len(d._view) - 4 or (
                    d._total_samples
                    and d._cur_sample >= d._total_samples
                ):
                    active[bi] = False
                    continue
                n, new_off = _native.mp3_parse_window(
                    lib, d._view, d._offset, d._hdr0, W, ngr, nch,
                    states[bi], xq[bi], aa[bi], wt[bi], flags,
                    free_format_bytes=d._free_format_bytes,
                )
                d._offset = new_off
                if n == 0:
                    active[bi] = False
                    continue
                got = flags[:n]
                fr_act = (got & 1).astype(bool)
                n_fr = int(fr_act.sum())
                if n_fr and not fr_act[:n_fr].all():
                    # silent frames left holes: compact to the prefix the
                    # scan-free DSP requires (skipped frames neither decode
                    # nor advance state, matching the reference)
                    gi = np.flatnonzero(np.repeat(fr_act, ngr))
                    xq[bi, : len(gi)] = xq[bi, gi]
                    aa[bi, : len(gi)] = aa[bi, gi]
                    wt[bi, : len(gi)] = wt[bi, gi]
                n_act[bi] = n_fr * ngr
                if (got & 2).any():
                    has_short = True
                d._cur_sample += n_fr * ngr * 576 * nch
                if n < W:
                    active[bi] = False
            self._note_stage("host_ms", "mp3", t_host, ct_host)
            if not n_act.any():
                break
            t_enq = time.perf_counter()
            ph_f = np.zeros((1, G, 1, 1), np.float32)
            ph_i = np.zeros((1, G, 1, 1), np.int32)
            (xq_d, aa_d, wt_d, overlap, shist, n_act_d) = _shard_batch(
                self._mesh, xq, aa, wt, overlap, shist, n_act)
            pcm, overlap, shist = mp3_dsp.mp3_window_dsp(
                xq_d, ph_f, ph_f, ph_i, aa_d, wt_d, overlap, shist,
                n_act_d, nch=nch, ngr=G, use_perm=False,
                dequant=False, use_mix=False,
            )
            _prefetch(pcm, to_device)
            self._note_stage("enqueue_ms", "mp3", t_enq)
            self._stat_add(
                "h2d_bytes",
                xq.nbytes + aa.nbytes + wt.nbytes + n_act.nbytes,
            )
            self._stat_add("windows", 1)
            pending.append((pcm, n_act.copy()))
        return pending

    def _mp3_finalize(self, decs, pending, nch):
        """Download the pending device windows and assemble the per-lane
        trimmed PCM (delay skip + total-length clamp)."""
        B = len(decs)
        outputs = [[] for _ in range(B)]
        t0 = time.perf_counter()
        for pcm_dev, n_act in pending:
            pcm = np.asarray(pcm_dev)
            self._stat_add("d2h_bytes", pcm.nbytes)
            for bi in range(B):
                n = int(n_act[bi])
                if not n:
                    continue
                outputs[bi].append(
                    pcm[bi][:n].transpose(0, 2, 1).reshape(-1, nch)
                )
        self._stat_add("fetch_ms", (time.perf_counter() - t0) * 1e3)
        result = []
        for bi, d in enumerate(decs):
            if outputs[bi]:
                pcm = np.concatenate(outputs[bi])
            else:
                pcm = np.zeros((0, nch), np.float32)
            skip = d._start_delay // nch
            pcm = pcm[skip:]
            if d._total_samples:
                pcm = pcm[: d._total_samples // nch]
            result.append(pcm)
        return result

    def _decode_mp3_group_py(self, decs: List[Mp3Decoder], nch: int,
                             ngr: int, to_device: bool = False):
        B = len(decs)
        # pad the batch axis to power-of-two buckets: XLA specializes on B,
        # so buckets keep the compile cache hot across batch sizes
        Bp = max(8, 1 << (B - 1).bit_length())
        W = MP3_WINDOW_FRAMES
        G = W * ngr  # granules per device call
        overlap = np.zeros((Bp, nch, 32, 18), dtype=np.float32)
        shist = np.zeros((Bp, nch, 16, 32), dtype=np.float32)
        active = np.ones(B, dtype=bool)

        ident = np.arange(576, dtype=np.int32)
        pending = []  # (device pcm, n_act) per window; fetched by finalize
        while active.any():
            q = np.zeros((Bp, G, nch, 576), np.float32)
            scale = np.zeros((Bp, G, nch, 576), np.float32)
            mix = np.zeros((Bp, G, 4, 576), np.float32)
            mix[:, :, 0] = 1.0
            mix[:, :, 3] = 1.0
            perm = None  # materialized lazily on the first short block
            aa = np.full((Bp, G, nch), 31, np.int32)
            wt = np.zeros((Bp, G, nch, 32), np.int32)
            n_act = np.zeros(Bp, np.int32)
            has_short = False

            for bi, d in enumerate(decs):
                for w in range(W):
                    if not active[bi]:
                        break
                    if d._offset >= len(d._view) - 4 or (
                        d._total_samples
                        and d._cur_sample >= d._total_samples
                    ):
                        active[bi] = False
                        break
                    tensors, fb = d._parse_frame_tensors(d._offset)
                    if fb == 0:
                        active[bi] = False
                        break
                    d._offset += fb
                    if tensors is None:
                        continue  # silent frame: state frozen, no output
                    # write at the lane's next free slot: activity stays a
                    # prefix (the scan-free DSP's contract)
                    g0 = int(n_act[bi])
                    q[bi, g0 : g0 + ngr] = tensors["q"][0]
                    scale[bi, g0 : g0 + ngr] = tensors["scale"][0]
                    mix[bi, g0 : g0 + ngr] = tensors["mix"][0]
                    aa[bi, g0 : g0 + ngr] = tensors["aa_bands"][0]
                    wtg = tensors["wtype"][0]
                    wt[bi, g0 : g0 + ngr] = wtg
                    if (wtg == mp3_dsp.WIN_SHORT).any():
                        has_short = True
                        if perm is None:
                            perm = np.broadcast_to(
                                ident, (Bp, G, nch, 576)
                            ).copy()
                        perm[bi, g0 : g0 + ngr] = tensors["perm"][0]
                    n_act[bi] += ngr
            if not n_act.any():
                break
            if perm is None:
                perm = np.zeros((1, G, 1, 1), np.int32)
            pcm, overlap, shist = mp3_dsp.mp3_window_dsp(
                q, scale, mix, perm, aa, wt, overlap, shist,
                n_act, nch=nch, ngr=G, use_perm=has_short,
            )
            # start the device->host copy in the background and keep parsing
            # the next window; the transfer overlaps the host entropy stage
            # instead of serializing after it
            _prefetch(pcm, to_device)
            self._stat_add("windows", 1)
            pending.append((pcm, n_act.copy()))
            for bi in range(B):
                decs[bi]._cur_sample += int(n_act[bi]) * 576 * nch
        return pending

    # ------------------------------------------------ batched FLAC lockstep
    def _decode_flac_group(self, decs: List[FlacDecoder], nch: int,
                           to_device: bool = False):
        import os as _os

        from ..host import native as _native

        # Two grouped FLAC paths, both bit-exact:
        #  * packed residual planes (default): host Rice walk + packed
        #    upload, the device unpacks and runs LPC + stereo.
        #  * device-Rice (AF_TPU_FLAC_DEVICE_RICE=1): host runs only
        #    the sync index, raw frame bytes upload as-is (wire ==
        #    compressed, inflation ~1.0) and the FSM decodes on the
        #    device.  Which one wins end to end on a GPU host is not
        #    measured yet (bench.py picks per run from a probe).
        rice_env = _os.environ.get("AF_TPU_FLAC_DEVICE_RICE")
        if rice_env not in (None, "", "0") and \
                _native.get_lib() is not None:
            return self._decode_flac_group_rice(decs, nch, to_device)
        B = len(decs)
        W = FLAC_WINDOW_FRAMES
        outputs = [[] for _ in range(B)]
        active = np.ones(B, dtype=bool)
        pending = []  # (device out32, [(slot, si, blocksize), ...])
        import os as _os
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=1)
        n_workers = max(1, min(8, (_os.cpu_count() or 1)))
        parse_pool = ThreadPoolExecutor(max_workers=n_workers) \
            if n_workers > 1 else None

        parse_lib = _native.get_lib()

        def _host_frame(d, bi, bs, ca, residual, coeffs, order, shift,
                        wasted):
            # beyond the device limb range: exact int64 on host
            samples = lpc_ops.flac_lpc_np(
                residual, coeffs, order, shift
            ).astype(np.int32)
            out32 = np.asarray(lpc_ops.flac_post_stereo(
                samples, np.int32(ca), wasted.astype(np.int32),
                np.int32(32 - d.bits_per_sample)))
            outputs[bi].append(out32.T)

        # multi-lane FFI surface (af_flac_parse_window_multi): one C
        # call Rice-decodes a whole lane chunk into [B, W*ch, mb_g]
        # batch rows.  Requires a uniform streaminfo max_block across
        # the group (it doubles as the C parser's validation bound and
        # row stride) and a bounded parse buffer; otherwise the
        # per-lane path below runs unchanged.
        mb_vals = {d._max_block if 0 < d._max_block <= 65535 else 65535
                   for d in decs}
        mb_g = mb_vals.pop() if len(mb_vals) == 1 else 0
        fmulti = (parse_lib is not None
                  and hasattr(parse_lib, "af_flac_parse_window_multi")
                  and mb_g > 0
                  and all(d.channels == nch for d in decs)
                  and B * W * nch * mb_g * 4 <= (512 << 20))
        if fmulti:
            fkeep = []
            fptrs = np.zeros(B, np.uint64)
            flens = np.zeros(B, np.int64)
            fcb = np.zeros(B, np.int64)
            fbps = np.zeros(B, np.int32)
            for bi, d in enumerate(decs):
                addr, nb2, keep = _native.buf_addr(d._view)
                fkeep.append(keep)
                fptrs[bi] = addr
                flens[bi] = nb2
                fcb[bi] = d._cur_bit
                fbps[bi] = d.bits_per_sample
            res_buf = res_buf_first = np.empty((B, W * nch, mb_g),
                                               np.int32)
            # second residual buffer: the dispatch worker packs straight
            # from these rows (af_flac_pack_gather — no padded scatter
            # copy), so window k's rows must survive until its pack
            # completes while window k+1 parses into the OTHER buffer;
            # buf_futs[parity] gates reuse two windows later
            res_buf_alt = np.empty_like(res_buf)
            cf_buf = np.empty((B, W * nch, 32), np.int32)
            ord_buf = np.empty((B, W * nch), np.int32)
            shf_buf = np.empty((B, W * nch), np.int32)
            was_buf = np.empty((B, W * nch), np.int32)
            bpsb_buf = np.empty((B, W * nch), np.int32)
            meta_buf = np.empty((B, W, 4), np.int64)
            nf_buf = np.zeros(B, np.int32)

        def _parse_chunk_fmulti(lanes):
            _ct0 = time.thread_time()
            try:
                gated = []
                for bi in lanes:
                    d = decs[bi]
                    if d._frame_pos >= d.length_frames > 0:
                        active[bi] = False
                    else:
                        gated.append(bi)
                if gated:
                    _native.flac_parse_window_multi(
                        parse_lib, gated, fptrs, flens, fcb, fbps,
                        nch, mb_g, W, res_buf, cf_buf, ord_buf, shf_buf,
                        was_buf, bpsb_buf, meta_buf, nf_buf)
                gset = set(gated)
                return [_post_lane_fmulti(bi) if bi in gset
                        else ([], False, 0) for bi in lanes]
            finally:
                self._note_host_cpu("flac", _ct0)

        def _post_lane_fmulti(bi):
            """Per-lane post-pass over the chunk-parsed batch rows: the
            same frame loop as _parse_lane_inner, reading views of the
            batch buffers (consumed by this window's assembly before
            the next window's parse overwrites them)."""
            d = decs[bi]
            out, prog, mbs = [], False, 0
            n = int(nf_buf[bi])
            if n == 0:
                active[bi] = False
                return out, prog, mbs
            meta_l = meta_buf[bi, :n].tolist()
            maxbps = bpsb_buf[bi, : n * nch].reshape(n, nch)\
                .max(axis=1).tolist()
            res = res_buf[bi]
            cf = cf_buf[bi]
            orr = ord_buf[bi]
            sh = shf_buf[bi]
            wa = was_buf[bi]
            bpsr = bpsb_buf[bi]
            capped = False
            for f in range(n):
                if d._frame_pos >= d.length_frames > 0:
                    capped = True
                    break
                bs, ca = meta_l[f][0], meta_l[f][1]
                d._cur_bit = meta_l[f][3]
                rows = slice(f * nch, f * nch + nch)
                prog = True
                if maxbps[f] > 18:
                    _host_frame(d, bi, bs, ca, res[rows, :bs], cf[rows],
                                orr[rows], sh[rows], wa[rows])
                    d._frame_pos += bs
                    continue
                slot = [None]
                outputs[bi].append(slot)
                out.append((bs, ca, res[rows, :bs], cf[rows], orr[rows],
                            sh[rows], wa[rows], bpsr[rows], slot))
                d._frame_pos += bs
                mbs = max(mbs, bs)
            if capped or n < W:
                active[bi] = False
            fcb[bi] = d._cur_bit  # cap may take fewer frames than parsed
            return out, prog, mbs

        def _parse_chunk(lanes):
            # per-CHUNK thread-CPU probe (see the MP3 twin)
            _ct0 = time.thread_time()
            try:
                return [_parse_lane_inner(bi) for bi in lanes]
            finally:
                self._note_host_cpu("flac", _ct0)

        def _parse_lane_inner(bi):
            # per-lane WINDOW parse — ONE C call decodes up to W frames
            # (entropy stage releases the GIL; runs concurrently across
            # lanes on multi-core hosts).  The per-frame wrapper this
            # replaces spent more wall in numpy/ctypes marshalling than
            # in the Rice decode itself.
            d = decs[bi]
            out, prog, mbs = [], False, 0
            if not active[bi]:
                return out, prog, mbs
            if d._frame_pos >= d.length_frames > 0:
                active[bi] = False
                return out, prog, mbs
            if parse_lib is None:
                # pure-Python fallback (AF_TPU_NO_NATIVE): per-frame parse
                for _ in range(W):
                    if d._frame_pos >= d.length_frames > 0:
                        active[bi] = False
                        break
                    p = d._parse_frame_tensors()
                    if p is None:
                        active[bi] = False
                        break
                    prog = True
                    if int(np.max(p[7])) > 18:
                        _host_frame(d, bi, p[0], p[1], p[2], p[3], p[4],
                                    p[5], p[6])
                        d._frame_pos += p[0]
                        continue
                    # placeholder claimed HERE, in frame order: a window
                    # mixing host-redo (wide) and device frames must
                    # interleave outputs at parse positions, not append
                    # device frames after the window's host frames
                    slot = [None]
                    outputs[bi].append(slot)
                    out.append(p + (slot,))
                    d._frame_pos += p[0]
                    mbs = max(mbs, p[0])
                return out, prog, mbs
            max_block = d._max_block if 0 < d._max_block <= 65535 else 65535
            dch = d.channels
            n, res, cf, orr, sh, wa, bps, meta = _native.flac_parse_window(
                parse_lib, d._view, d._cur_bit, d.bits_per_sample, dch,
                max_block, W)
            capped = False
            # one vectorized pass instead of per-frame numpy reductions
            # (2,707 ndarray.max calls cost more than the C Rice decode)
            maxbps = bps[: n * dch].reshape(n, dch).max(axis=1).tolist() \
                if n else []
            meta_l = meta[:n].tolist()
            for f in range(n):
                if d._frame_pos >= d.length_frames > 0:
                    capped = True
                    break
                bs, ca = meta_l[f][0], meta_l[f][1]
                d._cur_bit = meta_l[f][3]
                rows = slice(f * dch, f * dch + dch)
                prog = True
                if maxbps[f] > 18:
                    _host_frame(d, bi, bs, ca, res[rows, :bs], cf[rows],
                                orr[rows], sh[rows], wa[rows])
                    d._frame_pos += bs
                    continue
                # placeholder claimed at the frame's parse position (see
                # the fallback branch: wide + device frames interleave)
                slot = [None]
                outputs[bi].append(slot)
                out.append((bs, ca, res[rows, :bs], cf[rows], orr[rows],
                            sh[rows], wa[rows], bps[rows], slot))
                d._frame_pos += bs
                mbs = max(mbs, bs)
            if capped or n < W:
                active[bi] = False
            return out, prog, mbs

        try:
            buf_futs = [None, None]   # dispatch future per buffer parity
            wpar = 0
            while active.any():
                if fmulti:
                    # rows of the window that used this buffer (two
                    # windows ago) must be packed before reuse
                    if buf_futs[wpar] is not None:
                        buf_futs[wpar].result()
                    res_buf = res_buf_alt if wpar else res_buf_first
                # host entropy stage: parse up to W frames per stream
                t_host = time.perf_counter()
                live = [bi for bi in range(B) if active[bi]]
                chunk_fn = _parse_chunk_fmulti if fmulti else _parse_chunk
                if parse_pool is not None:
                    res = [r for sub in parse_pool.map(
                        chunk_fn, _lane_chunks(live, n_workers))
                        for r in sub]
                else:
                    res = chunk_fn(live)
                parsed = [[] for _ in range(B)]
                max_bs = 0
                progress = False
                for bi, (out, prog, mbs) in zip(live, res):
                    parsed[bi] = out
                    progress = progress or prog
                    max_bs = max(max_bs, mbs)
                self._note_stage("host_ms", "flac", t_host)
                lanes = [(bi, p) for bi in range(B) for p in parsed[bi]]
                if not lanes:
                    if not progress:
                        break
                    continue
                t_enq = time.perf_counter()
                # bucket the lane count (multiples of 128 past 128: keeps the
                # compile cache small while cutting transfer padding vs pow2)
                # and block length to keep compiles cached
                n_l = len(lanes)
                S = max(8, 1 << (n_l - 1).bit_length()) if n_l <= 128 \
                    else -(-n_l // 128) * 128
                max_bs = -(-max_bs // 1024) * 1024
                from ..host import native as _native

                lib = _native.get_lib()
                coeffs = np.zeros((S * nch, 32), np.int32)
                order = np.full(S * nch, max_bs, np.int32)  # pad: pass-through
                shift = np.zeros(S * nch, np.int32)
                exact = np.zeros(S * nch, bool)
                assigns = np.zeros(S, np.int32)
                wasteds = np.zeros((S, nch), np.int32)
                out_shifts = np.zeros(S, np.int32)
                if lib is not None:
                    # NO padded residual scatter: the worker packs straight
                    # from the parser's output rows (af_flac_pack_gather).
                    # rows[l] = address of that (lane,channel)'s residual
                    # row, ns[l] its valid sample count (reads as 0
                    # beyond); rows left 0 are all-zero padding rows.
                    # This removes a full read+write pass over ~GB/rep of
                    # int32 residuals that the scatter layout cost.
                    rows = np.zeros(S * nch, np.int64)
                    ns = np.zeros(S * nch, np.int32)
                    keep = []          # keepalive for per-lane parse bufs
                    residual = None
                else:
                    rows = ns = keep = None
                    residual = np.zeros((S * nch, max_bs), np.int32)
                for si, (bi, p) in enumerate(lanes):
                    bs, ca, res, cf, orr, sh, wa, bps, _slot = p
                    if residual is None:
                        base = res.__array_interface__["data"][0]
                        st0 = res.strides[0]
                        for c in range(nch):
                            rows[si * nch + c] = base + c * st0
                        ns[si * nch : si * nch + nch] = bs
                        keep.append(res)
                    else:
                        residual[si * nch : si * nch + nch, :bs] = res
                    coeffs[si * nch : si * nch + nch] = cf
                    order[si * nch : si * nch + nch] = orr
                    shift[si * nch : si * nch + nch] = sh
                    exact[si * nch : si * nch + nch] = np.asarray(bps) > 16
                    assigns[si] = ca
                    wasteds[si] = wa
                    out_shifts[si] = 32 - decs[bi].bits_per_sample
                # upload diet: pack residuals at the window's uniform bit
                # width (warm-ups ride an int32 side channel); the device
                # unpacks with static shift arithmetic.  The pack + upload +
                # device chain runs on the worker thread (ctypes releases the
                # GIL, and so does the upload) so window t+1's host
                # frame parse overlaps window t's transfer — same pipelining
                # as the MP3 scheduler.
                Ln = S * nch
                use_s16 = all(decs[bi].bits_per_sample <= 16 for bi, _ in lanes)

                def _flac_dispatch(rows, ns, keep, residual, coeffs, order,
                                   shift, exact, assigns, wasteds,
                                   out_shifts, max_bs, S, use_s16):
                    # NOTE: everything per-window must arrive as an argument —
                    # the enclosing loop rebinds its locals while this runs.
                    # `rows`/`ns` address the parser's residual rows in
                    # place (gather pack — no scatter copy); `keep` holds
                    # the per-lane parse buffers alive until the pack
                    # reads them (fmulti rows live in the double-buffered
                    # res_buf, gated by buf_futs instead).
                    Ln = S * nch
                    h2d = 0
                    packed = None
                    if lib is not None:
                        import ctypes as _ct

                        _i32p = _ct.POINTER(_ct.c_int32)
                        _u32p = _ct.POINTER(_ct.c_uint32)
                        _i64p = _ct.POINTER(_ct.c_int64)
                        t_pk = time.perf_counter()
                        w_l = np.zeros(Ln, np.int32)
                        wmax = lib.af_flac_widths_gather(
                            rows.ctypes.data_as(_i64p), Ln, max_bs,
                            ns.ctypes.data_as(_i32p),
                            order.ctypes.data_as(_i32p),
                            w_l.ctypes.data_as(_i32p))
                        # residual widths are heavy-tailed (verbatim blocks,
                        # high-order partitions); pick the cheapest of "pad
                        # all rows to the max bucket" vs "pack small + ship
                        # the few wide rows raw" (flac_merge_overflow)
                        wb, Lb = _flac_width_plan(w_l, wmax, Ln, max_bs)
                        stride = (max_bs * wb + 31) // 32 + 1
                        packed = np.empty((Ln, stride), np.uint32)
                        warm = np.empty((Ln, 32), np.int32)
                        lib.af_flac_pack_gather(
                            rows.ctypes.data_as(_i64p), Ln, max_bs,
                            ns.ctypes.data_as(_i32p),
                            order.ctypes.data_as(_i32p), wb,
                            packed.ctypes.data_as(_u32p), stride,
                            warm.ctypes.data_as(_i32p))
                        if Lb:
                            # the few wide rows ship PACKED too, at the
                            # window-max bucket (was: raw int32)
                            over = np.flatnonzero(w_l > wb)
                            wb2 = next((x for x in _FLAC_W_BUCKETS
                                        if wmax <= x), 32)
                            stride2 = (max_bs * wb2 + 31) // 32 + 1
                            order2 = np.full(Lb, max_bs, np.int32)
                            order2[1 : 1 + over.size] = order[over]
                            packed2 = np.zeros((Lb, stride2), np.uint32)
                            warm2 = np.zeros((Lb, 32), np.int32)
                            if over.size:
                                rows_o = np.ascontiguousarray(rows[over])
                                ns_o = np.ascontiguousarray(ns[over])
                                lib.af_flac_pack_gather(
                                    rows_o.ctypes.data_as(_i64p),
                                    int(over.size), max_bs,
                                    ns_o.ctypes.data_as(_i32p),
                                    np.ascontiguousarray(order[over])
                                    .ctypes.data_as(_i32p), wb2,
                                    packed2[1:].ctypes.data_as(_u32p),
                                    stride2,
                                    warm2[1:].ctypes.data_as(_i32p))
                            ovf_idx = np.zeros(Ln, np.int32)
                            ovf_idx[over] = np.arange(1, 1 + over.size)
                        keep = None   # parser rows consumed
                        # runs on the dispatch worker, overlapped with the
                        # next window's parse — attribution, not wall split
                        self._stat_add("enq_flacp_pack_ms",
                                       (time.perf_counter() - t_pk) * 1e3)
                    if packed is not None:
                        (packed_d, warm_d, coeffs, order, shift, exact,
                         assigns, wasteds, out_shifts) = _shard_batch(
                            self._mesh, packed, warm, coeffs, order, shift,
                            exact, assigns, wasteds, out_shifts)
                        residual_d = lpc_ops.flac_unpack_residuals(
                            packed_d, warm_d, order, w=wb, n=max_bs)
                        h2d += packed.nbytes + warm.nbytes
                        if Lb:
                            (p2_d, w2_d, o2_d, idx_d) = _shard_batch(
                                self._mesh, packed2, warm2, order2, ovf_idx)
                            res_o = lpc_ops.flac_unpack_residuals(
                                p2_d, w2_d, o2_d, w=wb2, n=max_bs)
                            residual_d = lpc_ops.flac_merge_overflow(
                                residual_d, res_o, idx_d, Lb=Lb)
                            h2d += (packed2.nbytes + warm2.nbytes
                                    + order2.nbytes + ovf_idx.nbytes)
                    else:
                        (residual_d, coeffs, order, shift, exact, assigns,
                         wasteds, out_shifts) = _shard_batch(
                            self._mesh, residual, coeffs, order, shift, exact,
                            assigns, wasteds, out_shifts)
                        h2d += residual.nbytes
                    samples = lpc_ops.flac_lpc(
                        residual_d, coeffs, order, shift, exact
                    ).reshape(S, nch, max_bs)
                    # <=16-bit lanes (out_shift >= 16): ship int16 losslessly
                    # to halve device->host bytes
                    post = lpc_ops.flac_post_stereo_batch_s16 if use_s16 \
                        else lpc_ops.flac_post_stereo_batch
                    out32 = post(samples, assigns, wasteds, out_shifts)
                    _prefetch(out32, to_device)
                    return out32, h2d

                fut = pool.submit(
                    _flac_dispatch, rows, ns, keep, residual, coeffs,
                    order, shift, exact, assigns, wasteds, out_shifts,
                    max_bs, S, use_s16)
                self._note_stage("enqueue_ms", "flac", t_enq)
                self._stat_add("windows", 1)
                # placeholders were claimed at parse time (frame order —
                # wide host-redo frames interleave with device frames);
                # p[8] is the frame's slot
                pending.append((fut, [(p[8], si, p[0]) for si, (bi, p)
                                      in enumerate(lanes)]))
                if fmulti and lib is not None:
                    # this window's rows live in res_buf[wpar]; flip
                    # parity so the next window parses the other buffer
                    buf_futs[wpar] = fut
                    wpar ^= 1

        finally:
            # see _decode_mp3_group_packed: no worker leaks on a
            # lane fault mid-window
            pool.shutdown(wait=True)
            if parse_pool is not None:
                parse_pool.shutdown(wait=True)
        resolved = []
        for fut, slots in pending:
            out32, h2d = fut.result()
            self._stat_add("h2d_bytes", h2d)
            self._stat_add("h2d_bytes_by_format", h2d, fmt="flac")
            resolved.append((out32, slots))
        pending[:] = resolved
        group = _PendingGroup(self, "flac", decs, pending,
                              self._flac_finalize,
                              (decs, outputs, pending, nch))
        return group if to_device else group.finalize()

    #: shared-pool block buckets for the device-Rice mode (x256 bytes).
    #: VERY coarse on purpose: each (S, NPOOL, NSAMP) combination is a
    #: separate compile + executable load.  Pool padding is FREE on the
    #: wire — the exact-size pool uploads and pads to the bucket on device
    #: (flac_rice.pad_pool) — so one bucket should cover every full
    #: window of a run (the top bucket is 134 MB of device memory)
    _RICE_POOL_BUCKETS = (1024, 8192, 65536, 524288)
    #: lane-count buckets (same trade-off; padded lanes decode zeros)
    _RICE_S_BUCKETS = (64, 512, 1536, 6144, 12288)

    def _decode_flac_group_rice(self, decs: List[FlacDecoder], nch: int,
                                to_device: bool = False):
        """Wire-optimal FLAC: the host runs ONLY the byte-level frame
        sync index (af_flac_sync_index — no Rice walk); raw frame bytes
        upload as-is (h2d inflation == 1.0) and the device FSM
        (ops/flac_rice.flac_frame_entropy) decodes subframe headers +
        residuals, feeding the same LPC/stereo device stages.  Frames the
        FSM flags (corrupt, >18-bit effective width, chain mismatch)
        re-decode on the host at frame granularity."""
        from concurrent.futures import ThreadPoolExecutor

        from ..host import native as _native
        from ..ops import flac_rice

        lib = _native.get_lib()
        B = len(decs)
        W = FLAC_WINDOW_FRAMES
        outputs = [[] for _ in range(B)]
        active = np.ones(B, dtype=bool)
        pending = []
        pool_w = ThreadPoolExecutor(max_workers=1)
        max_block = 65535
        for d in decs:
            if not hasattr(d, "_rice_state"):
                d._rice_state = np.array([-1, 0, d._cur_bit // 8],
                                         np.int64)

        # device-resident corpus for the on-device pool gather
        # (flac_rice.gather_frame_pool): every stream's raw bytes
        # upload ONCE per group call, then each window's shared pool
        # assembles on the chip from two tiny index arrays — the host
        # drops its per-window memcpy+byteswap pool build AND the
        # per-window pool device_put.  Single-device only (a
        # mesh would replicate the corpus on every device) and only
        # while absolute byte offsets stay int32-safe (<2 GiB).
        blk_b = flac_rice.BLK_W * 4
        total = sum(len(d._view) for d in decs)
        pool_mode = os.environ.get("AF_TPU_FLAC_POOL", "auto")
        # auto: gather for big groups (where the host pool build is
        # seconds of enqueue wall), host pool for small ones — tiny
        # batches (the mixed gauge's buckets) would pay a fresh
        # (NPOOL, S) gather compile for a sub-ms host build
        use_gather = pool_mode == "gather" or (
            pool_mode == "auto" and total >= (8 << 20))
        if (self._mesh is None and use_gather
                and total + 3 * blk_b < (1 << 31)):
            import jax as _jax

            pad = (-total) % 4 + 2 * blk_b
            buf = np.zeros(total + pad, np.uint8)
            stream_base = np.zeros(B, np.int64)
            cur = 0
            for bi, d in enumerate(decs):
                nb = len(d._view)
                buf[cur : cur + nb] = np.frombuffer(d._view, np.uint8,
                                                    nb, 0)
                stream_base[bi] = cur
                cur += nb
            # start of the 4-aligned zero tail: gather reads blk_b+4
            # bytes from zero_off, the tail holds 2*blk_b zeros
            zero_off = total + (-total) % 4
            # async upload: streams over the wire while the first
            # window's sync index runs on the host
            corpus_dev = _jax.device_put(buf.view(np.uint32))
            self._rice_corpus = (corpus_dev, stream_base, zero_off)
            self._stat_add("h2d_bytes", buf.nbytes)
            self._stat_add("h2d_bytes_by_format", buf.nbytes,
                           fmt="flac")

        try:
            return self._flac_rice_windows(
                decs, nch, to_device, lib, B, W, outputs, active,
                pending, pool_w, max_block)
        finally:
            # a lane fault raising out of the window loop must not leak
            # the dispatch worker (the bisect recovery re-invokes this
            # function O(log G) times on a poisoned chunk)
            self._rice_corpus = None
            pool_w.shutdown(wait=True)

    def _flac_rice_windows(self, decs, nch, to_device, lib, B, W,
                           outputs, active, pending, pool_w, max_block):
        from ..host import native as _native
        from ..ops import flac_rice

        # multi-lane FFI surface (af_flac_sync_index_multi): one C call
        # frame-indexes every live lane; per-lane results are [B, W]
        # rows and the persistent sync state is a [B, 3] batch copy
        # (written back after the loop — a lane fault re-probes to
        # fresh decoders, so mid-group staleness can't leak).  The
        # per-lane ctypes crossing this replaces cost ~1.4 s/rep at
        # batch 512, on par with the C scan itself.
        multi = lib is not None and hasattr(lib, "af_flac_sync_index_multi")
        if multi:
            data_keep = []
            ptrs_a = np.zeros(B, np.uint64)
            lens_a = np.zeros(B, np.int64)
            bps_in = np.zeros(B, np.int32)
            st_all = np.zeros((B, 3), np.int64)
            for bi, d in enumerate(decs):
                addr, nb2, keep = _native.buf_addr(d._view)
                data_keep.append(keep)
                ptrs_a[bi] = addr
                lens_a[bi] = nb2
                bps_in[bi] = d.bits_per_sample
                st_all[bi] = d._rice_state
            offs_w = np.zeros((B, W), np.int64)
            dbits_w = np.zeros((B, W), np.int64)
            bs_w = np.zeros((B, W), np.int32)
            ca_w = np.zeros((B, W), np.int32)
            bpsf_w = np.zeros((B, W), np.int32)
            n_w = np.zeros(B, np.int32)
        lens_l = [len(d._view) for d in decs]

        while active.any():
            t_host = time.perf_counter()
            ct_host = time.thread_time()
            lanes = []   # (bi, off, size, rel_bit, bs, ca, bps, chk)
            if multi:
                live = []
                for bi in range(B):
                    if not active[bi]:
                        continue
                    d = decs[bi]
                    if d._frame_pos >= d.length_frames > 0:
                        active[bi] = False
                    else:
                        live.append(bi)
                if live:
                    _native.flac_sync_index_multi(
                        lib, live, ptrs_a, lens_a, bps_in, nch,
                        max_block, W, st_all, offs_w, dbits_w, bs_w,
                        ca_w, bpsf_w, n_w)
                for bi in live:
                    d = decs[bi]
                    n = int(n_w[bi])
                    if n == 0:
                        active[bi] = False
                        continue
                    end = int(st_all[bi, 2])
                    o = offs_w[bi, :n]
                    if n == W and end + 16 <= lens_l[bi]:
                        # st[2] is the already-synced successor offset
                        nxt = np.append(o[1:], end)
                        chk_last = True
                    else:
                        # stream end: no successor — ship through EOF
                        # (st[2] is a search cursor that stops short of
                        # the last bytes) and skip the chain check
                        nxt = np.append(o[1:], lens_l[bi])
                        chk_last = False
                    sizes_l = (nxt - o).tolist()
                    rel_l = (dbits_w[bi, :n] - o * 8).tolist()
                    o_l = o.tolist()
                    bsl = bs_w[bi, :n].tolist()
                    cal = ca_w[bi, :n].tolist()
                    bpsl = bpsf_w[bi, :n].tolist()
                    for i in range(n):
                        lanes.append((bi, o_l[i], sizes_l[i], rel_l[i],
                                      bsl[i], cal[i], bpsl[i],
                                      chk_last if i == n - 1 else True))
                    d._frame_pos += sum(bsl)
                    if n < W:
                        active[bi] = False
                self._note_stage("host_ms", "flac_rice", t_host, ct_host)
                if not lanes:
                    break
                self._flac_rice_enqueue(decs, lanes, nch, outputs,
                                        pending, pool_w, to_device,
                                        lane_addrs=ptrs_a)
                continue
            for bi in range(B):
                if not active[bi]:
                    continue
                d = decs[bi]
                if d._frame_pos >= d.length_frames > 0:
                    active[bi] = False
                    continue
                st = d._rice_state
                n, offs, dbits, bsA, caA, bpsA = _native.flac_sync_index(
                    lib, d._view, int(st[2]), d.bits_per_sample, nch,
                    max_block, W, st)
                if n == 0:
                    active[bi] = False
                    continue
                end = int(st[2])
                for i in range(n):
                    if i + 1 < n:
                        nxt, chk = int(offs[i + 1]), True
                    elif n == W and end + 16 <= len(d._view):
                        # st[2] is the already-synced successor offset
                        nxt, chk = end, True
                    else:
                        # stream end: no successor — ship through EOF
                        # (st[2] is a search cursor that stops short of
                        # the last bytes) and skip the chain check
                        nxt, chk = len(d._view), False
                    lanes.append((bi, int(offs[i]), nxt - int(offs[i]),
                                  int(dbits[i] - offs[i] * 8), int(bsA[i]),
                                  int(caA[i]), int(bpsA[i]), chk))
                    d._frame_pos += int(bsA[i])
                if n < W:
                    active[bi] = False
            self._note_stage("host_ms", "flac_rice", t_host, ct_host)
            if not lanes:
                break
            self._flac_rice_enqueue(decs, lanes, nch, outputs,
                                    pending, pool_w, to_device)
        if multi:
            # persistent sync state: the multi path works on the batch
            # copy; write back so chunked reads continue across groups
            for bi, d in enumerate(decs):
                d._rice_state[:] = st_all[bi]
        pool_w.shutdown(wait=True)
        resolved = []
        fetched = [f.result() for f, _ in pending]
        # start EVERY window's flag downloads before blocking on any:
        # each np.asarray is a full round trip, and a serial loop over
        # windows paid it windows x 3 times
        for out32, bad_parts, _h2d in fetched:
            for a in bad_parts[:3]:
                try:
                    a.copy_to_host_async()
                except AttributeError:
                    pass
        for (fut, slots), (out32, bad_parts, h2d) in zip(pending, fetched):
            self._stat_add("h2d_bytes", h2d)
            self._stat_add("h2d_bytes_by_format", h2d, fmt="flac")
            # frame-chain validation, deferred from the dispatch (the
            # downloads block; by now every window is enqueued, so the
            # device pipeline stayed full): a mismatched end position
            # means a mis-parse — those frames redo on the host
            err_d, endb_d, subbps_d, base_arr, sizes = bad_parts
            err = np.asarray(err_d)
            endb = np.asarray(endb_d).astype(np.int64) - base_arr
            wide = np.asarray(subbps_d).max(axis=1) > 18
            chain = (((endb + 7) // 8) * 8 + 16 != sizes * 8) \
                & (sizes > 0)
            bad = err | wide | chain
            resolved.append((out32, bad, slots))
        pending[:] = resolved
        group = _PendingGroup(self, "flac", decs, pending,
                              self._flac_finalize_rice,
                              (decs, outputs, pending, nch))
        return group if to_device else group.finalize()

    def _flac_rice_enqueue(self, decs, lanes, nch, outputs, pending,
                           pool_w, to_device, lane_addrs=None):
        """Split a window's lane list into int32-safe dispatches.  The
        kernel's bit cursors are int32, so one dispatch's pool must stay
        under 2^31 bits — the 524288-block top bucket (2^30 bits).
        Windows wider than that (possible at GROUP=1024 with 24-bit
        frames) split into several dispatches, each int32-safe."""
        from ..ops import flac_rice

        blk_b = flac_rice.BLK_W * 4
        chunks, cur, blocks = [], [], 0
        for p in lanes:
            nb = -(-p[2] // blk_b)
            if cur and blocks + nb + 2 > 524288:
                chunks.append(cur)
                cur, blocks = [], 0
            cur.append(p)
            blocks += nb
        chunks.append(cur)
        for sub in chunks:
            self._rice_dispatch_lanes(
                decs, sub, nch, outputs, pending, pool_w, to_device,
                lane_addrs=lane_addrs)

    def _rice_dispatch_lanes(self, decs, lanes, nch, outputs, pending,
                             pool_w, to_device, lane_addrs=None):
        """Build and submit ONE device-Rice dispatch for a lane chunk
        (pool + per-lane arrays + the worker-thread device call)."""
        from ..ops import flac_rice

        t_enq = time.perf_counter()
        n_l = len(lanes)
        S = next((x for x in self._RICE_S_BUCKETS if n_l <= x),
                 -(-n_l // 12288) * 12288)
        max_bs = max(p[4] for p in lanes)
        max_bs = next((x for x in (256, 1024, 4096) if max_bs <= x),
                      -(-max_bs // 4096) * 4096)
        need = flac_rice.pool_blocks_needed([p[2] for p in lanes])
        NPOOL = next((x for x in self._RICE_POOL_BUCKETS
                      if need <= x), -(-need // 524288) * 524288)
        t_pb = time.perf_counter()
        corpus_state = getattr(self, "_rice_corpus", None)
        if corpus_state is not None and self._mesh is None:
            # device-side pool assembly: the host builds only the two
            # index arrays; the worker's gather_frame_pool dispatch
            # assembles the pool from the resident corpus on the chip
            corpus_dev, stream_base, zero_off = corpus_state
            lane_src, cum_dst, base_bits = flac_rice.gather_pool_meta(
                stream_base, lanes, S, zero_off)
            pool = ("gather", corpus_dev, lane_src, cum_dst,
                    np.int32(zero_off))
        elif lane_addrs is not None:
            from ..host import native as _native

            pool, base_bits = flac_rice.build_frame_pool_native(
                _native.get_lib(), lane_addrs, lanes, NPOOL)
        else:
            pool, base_bits = flac_rice.build_frame_pool(
                [(decs[p[0]]._view, p[1], p[2]) for p in lanes], NPOOL)
        self._stat_add("enq_flac_poolbuild_ms",
                       (time.perf_counter() - t_pb) * 1e3)
        t_cols = time.perf_counter()
        # transpose the lane tuples once; numpy assigns the columns
        # (three per-lane Python loops cost ~0.1 s/window at S=4096)
        bi_c, _off_c, size_c, rel_c, bs_c, ca_c, bps_c, chk_c = \
            zip(*lanes)
        start_bits = np.zeros(S, np.int32)
        start_bits[: n_l] = base_bits + np.asarray(rel_c, np.int64)
        bs_arr = np.zeros(S, np.int32)
        bs_arr[: n_l] = bs_c
        ca_arr = np.zeros(S, np.int32)
        ca_arr[: n_l] = ca_c
        bps_arr = np.full(S, 16, np.int32)
        bps_arr[: n_l] = bps_c
        base_arr = np.zeros(S, np.int64)
        base_arr[: n_l] = base_bits
        sizes = np.zeros(S, np.int64)   # 0 -> chain check skipped
        sizes[: n_l] = np.where(np.asarray(chk_c, bool),
                                np.asarray(size_c, np.int64), 0)
        lane_bps = np.fromiter(
            (decs[bi].bits_per_sample for bi in bi_c), np.int32, n_l)
        use_s16 = bool((lane_bps <= 16).all())
        out_shifts = np.zeros(S, np.int32)
        out_shifts[: n_l] = 32 - lane_bps
        pool_nbytes = 0 if isinstance(pool, tuple) else pool.nbytes
        self._stat_add("enq_flac_cols_ms",
                       (time.perf_counter() - t_cols) * 1e3)
        t_put = time.perf_counter()
        if self._mesh is None and not isinstance(pool, tuple):
            # start the pool's h2d stream NOW, from the main thread:
            # device_put is async, so window k+1's sync-index/assembly
            # overlaps window k's wire time.  Leaving the transfer to
            # the worker's first eager op serializes every upload
            # behind the previous dispatch (inside pad_pool's implicit
            # numpy->device convert).
            import jax as _jax

            pool = _jax.device_put(pool)
        self._stat_add("enq_flac_put_ms",
                       (time.perf_counter() - t_put) * 1e3)

        def _rice_dispatch(pool, start_bits, bs_arr, ca_arr, bps_arr,
                           sizes, base_arr, out_shifts, S, max_bs,
                           NPOOL, use_s16):
            # every per-window value arrives as an argument (the
            # enclosing loop rebinds its locals while this runs)
            if isinstance(pool, tuple):
                # corpus-gather wire mode: assemble the pool ON DEVICE
                _tag, corpus_dev, lane_src, cum_dst, zo = pool
                blocks_d = flac_rice.gather_frame_pool(
                    corpus_dev, lane_src, cum_dst, zo,
                    NPOOL=NPOOL, S=S)
                sb_d, bs_d, bps_d, ca_d, osh_d = (
                    start_bits, bs_arr, bps_arr, ca_arr, out_shifts)
            else:
                (blocks_d, sb_d, bs_d, bps_d, ca_d, osh_d) = \
                    _shard_batch(
                        self._mesh, pool, start_bits, bs_arr,
                        bps_arr, ca_arr, out_shifts)
                # wire carried the exact pool; bucket-pad on device
                blocks_d = flac_rice.pad_pool(blocks_d, NPOOL)
            ent = flac_rice.flac_frame_entropy(
                blocks_d, sb_d, bs_d, bps_d, ca_d,
                L=S, NSAMP=max_bs, nch=nch, NPOOL=NPOOL)
            Ln = S * nch
            residual = ent["residual"].reshape(Ln, max_bs)
            coeffs = ent["coeffs"].reshape(Ln, 32)
            order = ent["order"].reshape(Ln)
            shift = ent["shift"].reshape(Ln)
            sub_bps = ent["sub_bps"].reshape(Ln)
            exact = sub_bps > 16
            samples = lpc_ops.flac_lpc(
                residual, coeffs, order, shift, exact
            ).reshape(S, nch, max_bs)
            post = lpc_ops.flac_post_stereo_batch_s16 if use_s16 \
                else lpc_ops.flac_post_stereo_batch
            out32 = post(samples, ca_d,
                         ent["wasted"], osh_d)
            _prefetch(out32, to_device)
            # sticky lane errors + frame-chain validation ride back as
            # DEVICE arrays: a np.asarray here would block this (single)
            # dispatch worker on the window's full device computation,
            # serializing upload N+1 behind compute N.  The resolution loop
            # downloads them after every window has been enqueued.
            return (out32,
                    (ent["err"], ent["end_bits"], ent["sub_bps"],
                     base_arr, sizes),
                    pool_nbytes)

        fut = pool_w.submit(_rice_dispatch, pool, start_bits, bs_arr,
                            ca_arr, bps_arr, sizes, base_arr,
                            out_shifts, S, max_bs, NPOOL, use_s16)
        self._note_stage("enqueue_ms", "flac_rice", t_enq)
        self._stat_add("windows", 1)
        slots = []
        for si, (bi, off, size, rel, bs, ca, bps, chk) in \
                enumerate(lanes):
            slot = [None]
            outputs[bi].append(slot)
            slots.append((slot, si, bs, bi, off))
        pending.append((fut, slots))

    def _flac_finalize_rice(self, decs, outputs, pending, nch):
        from ..host import native as _native

        lib = _native.get_lib()
        t0 = time.perf_counter()
        n_redo = 0
        corrupt = set()      # lanes whose redo frame fails to parse
        for out32_dev, bad, slots in pending:
            arr = np.asarray(out32_dev)
            self._stat_add("d2h_bytes", arr.nbytes)
            for slot, si, bs, bi, off in slots:
                if bad[si]:
                    # host redo of this frame (corrupt / wide / chain)
                    d = decs[bi]
                    nat = _native.flac_parse_frame(
                        lib, d._view, off * 8, d.bits_per_sample,
                        nch, 65535)
                    if nat is None:
                        # unparseable frame discovered at finalize time:
                        # contain to THIS lane.  The facade treats a
                        # parse failure as end-of-decode (truncation,
                        # no sticky error — _parse_frame_tensors returns
                        # None and read() stops, matching drflac's
                        # fewer-samples-on-damage behavior); batch must
                        # match, and raising here would abort every
                        # innocent lane's already-decoded result
                        corrupt.add(bi)
                        slot[0] = np.zeros((0, nch), np.int32)
                        continue
                    samples = lpc_ops.flac_lpc_np(
                        nat["residual"], nat["coeffs"], nat["order"],
                        nat["shift"]).astype(np.int32)
                    out = np.asarray(lpc_ops.flac_post_stereo(
                        samples, np.int32(nat["chan_assignment"]),
                        nat["wasted"].astype(np.int32),
                        np.int32(32 - d.bits_per_sample)))
                    slot[0] = out.T[:bs]
                    n_redo += 1
                elif arr.dtype == np.int16:
                    slot[0] = arr[si, :, :bs].T.astype(np.int32) << 16
                else:
                    slot[0] = arr[si, :, :bs].T
        if n_redo:
            self._stat_add("rice_host_redo", n_redo)
        self._stat_add("fetch_ms", (time.perf_counter() - t0) * 1e3)
        for bi in corrupt:
            self._stat_add("flac_truncated_lanes", 1)
            # decode stops at the unparseable frame: drop the lane's
            # slots from there on (slot lists are window-ordered)
            seen = False
            for c in outputs[bi]:
                if isinstance(c, list) and c[0] is not None \
                        and c[0].shape[0] == 0:
                    seen = True
                if seen and isinstance(c, list):
                    c[0] = np.zeros((0, nch), np.int32)

        result = []
        for bi, d in enumerate(decs):
            if outputs[bi]:
                s32 = np.concatenate(
                    [c[0] if isinstance(c, list) else c
                     for c in outputs[bi]])
            else:
                s32 = np.zeros((0, nch), np.int32)
            if d.length_frames:
                s32 = s32[: d.length_frames]
            pcm = (s32.astype(np.float64) * (1.0 / 2147483647.0)).astype(
                np.float32)
            result.append(pcm)
        return result

    def _flac_finalize(self, decs, outputs, pending, nch):
        t0 = time.perf_counter()
        for out32_dev, slots in pending:
            arr = np.asarray(out32_dev)
            self._stat_add("d2h_bytes", arr.nbytes)
            if arr.dtype == np.int16:
                for slot, si, bs in slots:
                    slot[0] = arr[si, :, :bs].T.astype(np.int32) << 16
            else:
                for slot, si, bs in slots:
                    slot[0] = arr[si, :, :bs].T
        self._stat_add("fetch_ms", (time.perf_counter() - t0) * 1e3)

        result = []
        for bi, d in enumerate(decs):
            if outputs[bi]:
                s32 = np.concatenate(
                    [c[0] if isinstance(c, list) else c for c in outputs[bi]]
                )
            else:
                s32 = np.zeros((0, nch), np.int32)
            if d.length_frames:
                s32 = s32[: d.length_frames]
            pcm = (s32.astype(np.float64) * (1.0 / 2147483647.0)).astype(
                np.float32
            )
            result.append(pcm)
        return result

    # --------------------------------------------------- batched WAV lanes
    def _decode_wav_group(self, decs, kind: str, to_device: bool = False):
        """WAV batching: the exact-rounding int→float kernel is elementwise,
        so all lanes of one PCM kind concatenate into a few large flat
        device calls (lane boundaries are irrelevant to the math)."""
        from ..models.wav import _unpack_int_pcm

        bps = {"u8": 1, "s16": 2, "s24": 3, "s32": 4}[kind]
        t_host = time.perf_counter()
        ct_host = time.thread_time()
        ints = []
        counts = []
        for d in decs:
            frames = d.length_frames - d._frame_pos
            n = frames * d.channels
            raw = d._raw_frames(frames)
            ints.append(_unpack_int_pcm(raw, bps, n))
            counts.append((frames, d.channels))
            d._frame_pos += frames
        flat = np.concatenate(ints) if ints else np.zeros(0, np.int32)
        self._note_stage("host_ms", "wav", t_host, ct_host)
        CHUNK = 1 << 22
        pending = []
        for c0 in range(0, flat.shape[0], CHUNK):
            t_enq = time.perf_counter()
            seg = flat[c0 : c0 + CHUNK]
            out = pcm_ops_int_to_float_dev(seg, kind)
            pending.append((out, seg.shape[0]))
            self._note_stage("enqueue_ms", "wav", t_enq)
            self._stat_add("h2d_bytes", seg.nbytes)
            self._stat_add("h2d_bytes_by_format", seg.nbytes, fmt="wav")
            self._stat_add("windows", 1)
        group = _PendingGroup(self, "wav", decs, pending,
                              self._wav_finalize, (decs, counts, pending))
        return group if to_device else group.finalize()

    def _wav_finalize(self, decs, counts, pending):
        t0 = time.perf_counter()
        parts = []
        for out_dev, n in pending:
            arr = np.asarray(out_dev)[:n]
            self._stat_add("d2h_bytes", arr.nbytes)
            parts.append(arr)
        self._stat_add("fetch_ms", (time.perf_counter() - t0) * 1e3)
        flat = np.concatenate(parts) if parts else np.zeros(0, np.float32)
        result = []
        off = 0
        for frames, ch in counts:
            n = frames * ch
            result.append(flat[off : off + n].reshape(frames, ch))
            off += n
        return result

    # --------------------------------------------------- batched QOA frames
    def _decode_qoa_group(self, decs, nch: int, to_device: bool = False):
        """QOA batching: LMS state is in-band per frame (qoa.d:488-503), so
        every frame of every stream is an independent lane — the whole
        group decodes as a few large [lanes, 5120] device calls.  Slice
        payloads ship as int8 (3-bit codes, 4-bit scalefactors)."""
        FULL_S = 256
        t_host = time.perf_counter()
        ct_host = time.thread_time()
        metas = []   # (stream index, f_samples)
        H, Wt, SF, CD = [], [], [], []
        for bi, d in enumerate(decs):
            pos = d._byte_pos
            got = 0
            while True:
                p = d._parse_frame_at(pos)
                if p is None:
                    break
                h, w, sf, codes, f_samples, f_size = p
                S = sf.shape[1]
                if S < FULL_S:
                    sf = np.pad(sf, ((0, 0), (0, FULL_S - S)))
                    codes = np.pad(codes,
                                   ((0, 0), (0, FULL_S - S), (0, 0)))
                H.append(h)
                Wt.append(w)
                SF.append(sf.astype(np.int8))
                CD.append(codes.astype(np.int8))
                metas.append((bi, f_samples))
                pos += f_size
                got += f_samples
            d._byte_pos = pos
            d._pos += got
        pending = []
        if metas:
            hist = np.concatenate(H).astype(np.int32)
            wts = np.concatenate(Wt).astype(np.int32)
            sf8 = np.concatenate(SF)
            cd8 = np.concatenate(CD)
            self._note_stage("host_ms", "qoa", t_host, ct_host)
            L = hist.shape[0]
            CH = 8192  # lanes per device call (bounds upload + HBM)
            for c0 in range(0, L, CH):
                t_enq = time.perf_counter()
                Lc = min(CH, L - c0)
                Lp = max(8, 1 << (Lc - 1).bit_length()) if Lc <= 1024 \
                    else -(-Lc // 1024) * 1024
                sl = slice(c0, c0 + Lc)
                hp = np.zeros((Lp, 4), np.int32)
                wp = np.zeros((Lp, 4), np.int32)
                sp = np.zeros((Lp, FULL_S), np.int8)
                cp = np.zeros((Lp, FULL_S, 20), np.int8)
                hp[:Lc] = hist[sl]
                wp[:Lc] = wts[sl]
                sp[:Lc] = sf8[sl]
                cp[:Lc] = cd8[sl]
                (hp_d, wp_d, sp_d, cp_d) = _shard_batch(
                    self._mesh, hp, wp, sp, cp)
                out = lms_ops.decode_slices(hp_d, wp_d, sp_d, cp_d)
                _prefetch(out, to_device)
                pending.append((out, Lc))
                self._note_stage("enqueue_ms", "qoa", t_enq)
                self._stat_add("h2d_bytes", hp.nbytes + wp.nbytes
                               + sp.nbytes + cp.nbytes)
                self._stat_add("h2d_bytes_by_format", hp.nbytes + wp.nbytes                               + sp.nbytes + cp.nbytes, fmt="qoa")
                self._stat_add("windows", 1)
        group = _PendingGroup(self, "qoa", decs, pending,
                              self._qoa_finalize,
                              (decs, metas, pending, nch))
        return group if to_device else group.finalize()

    def _qoa_finalize(self, decs, metas, pending, nch):
        t0 = time.perf_counter()
        chunks = []
        for out_dev, Lc in pending:
            arr = np.asarray(out_dev)[:Lc]
            self._stat_add("d2h_bytes", arr.nbytes)
            chunks.append(arr)
        self._stat_add("fetch_ms", (time.perf_counter() - t0) * 1e3)
        outputs = [[] for _ in decs]
        row = 0
        flat = np.concatenate(chunks) if chunks else \
            np.zeros((0, 5120), np.int32)
        for bi, f_samples in metas:
            lanes = flat[row : row + nch]
            row += nch
            outputs[bi].append(
                lanes[:, :f_samples].T.astype(np.int16)
            )
        from ..models.qoa import _F32_RECIP

        result = []
        for bi, d in enumerate(decs):
            s16 = (np.concatenate(outputs[bi]) if outputs[bi]
                   else np.zeros((0, nch), np.int16))
            s16 = s16[: d.length_frames]
            # same float conversion as the facade (qoa.d:825-834)
            result.append(s16.astype(np.float32) * _F32_RECIP)
        return result

    # ------------------------------------------------ batched Vorbis lanes
    def _decode_vorbis_group(self, decs, key, to_device: bool = False):
        """Vorbis lockstep: host entropy (codebooks/floors/residues) per
        lane packet, then ONE device IMDCT matmul per (window-step, block
        size) bucket over all lanes' stacked channel spectra; the lapped
        windowing finishes on the host (per-lane carried half-window).
        K packets per lane per step amortize the device round trip.

        With ``output="device"`` the whole post-entropy chain — IMDCT,
        lapped overlap-add, finished-region extraction — runs as ONE jitted
        scan per window (ops/vorbis_win.py) with the lap state carried in
        device arrays, and PCM stays device-resident until finalize()."""
        from ..ops import mdct as mdct_ops

        if to_device:
            return self._decode_vorbis_group_device(decs, key)
        B = len(decs)
        nch = decs[0].channels
        outputs = [[] for _ in range(B)]
        active = np.ones(B, bool)
        K = 8  # packets per lane per step
        while active.any():
            t_host = time.perf_counter()
            ct_host = time.thread_time()
            entries = []  # (bi, spec, geom, granule)
            for bi, d in enumerate(decs):
                for _ in range(K):
                    if not active[bi]:
                        break
                    if d.length_frames and d._pos >= d.length_frames:
                        active[bi] = False
                        break
                    pk = d._reader.next_packet()
                    if pk is None:
                        active[bi] = False
                        break
                    ent = d._packet_entropy(pk[0])
                    if ent is None:
                        continue
                    entries.append((bi, ent[0], ent[1], pk[1]))
            self._note_stage("host_ms", "vorbis", t_host, ct_host)
            if not entries:
                break
            # device IMDCT per block size over stacked lane-channels
            t_enq = time.perf_counter()
            y_by_entry = [None] * len(entries)
            for n in sorted({e[2][0] for e in entries}):
                idxs = [i for i, e in enumerate(entries) if e[2][0] == n]
                X = np.concatenate([entries[i][1] for i in idxs])
                (X_d,) = _shard_batch(self._mesh, X)
                Y = np.asarray(mdct_ops.imdct_batch(X_d, n))
                self._stat_add("h2d_bytes", X.nbytes)
                self._stat_add("h2d_bytes_by_format", X.nbytes, fmt="vorbis")
                self._stat_add("d2h_bytes", Y.nbytes)
                row = 0
                for i in idxs:
                    y_by_entry[i] = Y[row : row + nch].copy()
                    row += nch
                self._stat_add("windows", 1)
            self._note_stage("enqueue_ms", "vorbis", t_enq)
            # host: lapped windowing + per-lane assembly (order preserved:
            # entries are in (lane, packet) order per step)
            for (bi, _spec, geom, granule), y in zip(entries, y_by_entry):
                d = decs[bi]
                pcm, _virtual = d._finish_packet(y, geom, granule)
                if pcm is None or pcm.shape[0] == 0:
                    continue
                if d.length_frames:
                    pcm = pcm[: max(0, d.length_frames - d._pos)]
                d._pos += pcm.shape[0]
                outputs[bi].append(np.ascontiguousarray(pcm, np.float32))
        return [
            np.concatenate(outputs[bi]) if outputs[bi]
            else np.zeros((0, nch), np.float32)
            for bi in range(B)
        ]

    def _decode_vorbis_group_device(self, decs, nch: int):
        """Device-resident Vorbis lockstep (output="device"): the host does
        entropy only; IMDCT + lapped windowing run on device with the lap
        carried as device arrays (ops/vorbis_win.vorbis_window_chain), and
        PCM windows accumulate on the accelerator.  Per-packet output
        lengths are known host-side from the geometry alone, so nothing
        downloads until finalize()."""
        from ..ops import vorbis_win

        B = len(decs)
        bs0, bs1 = decs[0]._bs0, decs[0]._bs1
        h = bs1 // 2
        L = B * nch
        K = 8  # packets per lane per window
        state = (
            np.zeros((L, h), np.float32),   # lap
            np.zeros(B, np.int32),          # lap_len
            np.zeros(B, np.int32),          # had_prev
        )
        host_hp = np.zeros(B, bool)  # host mirror of had_prev
        active = np.ones(B, bool)
        pending = []
        while active.any():
            t_host = time.perf_counter()
            ct_host = time.thread_time()
            X = np.zeros((K, L, h), np.float32)
            geom = np.zeros((4, K, B), np.int32)  # ls, rs, re, valid
            lens = np.zeros((K, B), np.int32)     # emitted (clamped) lengths
            for bi, d in enumerate(decs):
                k = 0
                while k < K and active[bi]:
                    if d.length_frames and d._pos >= d.length_frames:
                        active[bi] = False
                        break
                    pk = d._reader.next_packet()
                    if pk is None:
                        active[bi] = False
                        break
                    ent = d._packet_entropy(pk[0])
                    if ent is None:
                        continue
                    spec, (n, l0, r0, r1) = ent
                    X[k, bi * nch : (bi + 1) * nch, : n // 2] = spec
                    geom[:, k, bi] = (l0, r0, r1, 1)
                    ol = (r0 - l0) if host_hp[bi] else 0
                    host_hp[bi] = True
                    if d.length_frames:
                        ol = min(ol, max(0, d.length_frames - d._pos))
                    lens[k, bi] = ol
                    d._pos += ol
                    k += 1
            self._note_stage("host_ms", "vorbis", t_host, ct_host)
            if not geom[3].any():
                break
            t_enq = time.perf_counter()
            X_d, st0 = _shard_batch_axis1(self._mesh, X, state[0])
            pcm, *st = vorbis_win.vorbis_window_chain(
                X_d, geom[0], geom[1], geom[2], geom[3],
                st0, state[1], state[2], bs0=bs0, bs1=bs1, ch=nch)
            state = tuple(st)
            self._note_stage("enqueue_ms", "vorbis", t_enq)
            self._stat_add("h2d_bytes", X.nbytes + geom.nbytes)
            self._stat_add("h2d_bytes_by_format", X.nbytes + geom.nbytes, fmt="vorbis")
            self._stat_add("windows", 1)
            pending.append((pcm, lens))
        return _PendingGroup(self, "vorbis", decs, pending,
                             self._vorbis_finalize, (decs, pending, nch))

    def _vorbis_finalize(self, decs, pending, nch):
        t0 = time.perf_counter()
        outs = [[] for _ in decs]
        for pcm_dev, lens in pending:
            arr = np.asarray(pcm_dev)  # [K, L, bs1]
            self._stat_add("d2h_bytes", arr.nbytes)
            for bi in range(len(decs)):
                for k in range(arr.shape[0]):
                    n = int(lens[k, bi])
                    if n:
                        outs[bi].append(
                            arr[k, bi * nch : (bi + 1) * nch, :n].T)
        res = [
            np.ascontiguousarray(np.concatenate(o), dtype=np.float32)
            if o else np.zeros((0, nch), np.float32)
            for o in outs
        ]
        self._stat_add("fetch_ms", (time.perf_counter() - t0) * 1e3)
        return res

    # ------------------------------------------------- batched Opus lockstep
    @staticmethod
    def _opus_eligible(d) -> bool:
        """Lockstep-eligible: mapping-0 stream whose packets are all
        CELT-only with one frame size (music streams; the common case).
        Mixed-mode/multistream lanes use the per-stream path."""
        if getattr(d, "channel_mapping", 1) != 0:
            return False
        if getattr(d, "s16_parity", False):
            return False  # parity diff-test mode rides the facade read path
        try:
            pkts = d._collect_packets()
        except Exception:
            return False
        if not pkts:
            return False
        fs = None
        for data in pkts:
            pk = _opus_parse(data)
            if pk is None or pk["mode"] != "celt":
                return False
            if fs is None:
                fs = pk["frame_size"]
            elif pk["frame_size"] != fs:
                return False
        d._lockstep_packets = pkts
        return True

    @staticmethod
    def _silk_eligible(d) -> bool:
        """Lockstep-eligible SILK: mapping-0 stream whose packets are all
        single non-empty SILK-mode frames with one (config, stereo) — the
        common VoIP shape.  Hybrid and mode-switching streams keep the
        per-stream path (their CELT layer and redundancy crossfades
        interleave on the same range coder, dopus.d:6400)."""
        import os

        if os.environ.get("AF_TPU_REFERENCE_RESAMPLER"):
            return False  # speex-mirror path is per-stream only
        if getattr(d, "channel_mapping", 1) != 0:
            return False
        if getattr(d, "s16_parity", False):
            return False  # parity diff-test mode rides the facade read path
        try:
            pkts = d._collect_packets()
        except Exception:
            return False
        if not pkts:
            return False
        key = None
        parsed = []
        for data in pkts:
            pk = _opus_parse(data)
            if (pk is None or pk["mode"] != "silk"
                    or any(len(f) == 0 for f in pk["frames"])):
                return False
            k = (pk["config"], pk["stereo"], len(pk["frames"]))
            if key is None:
                key = k
            elif k != key:
                return False
            parsed.append(pk)
        d._silk_lockstep = parsed
        return True

    @staticmethod
    def _opus_mixed_eligible(d) -> bool:
        """Catch-all lockstep for mapping-0 Opus streams the homogeneous
        groups decline — mode switches, mixed frame sizes, multi-frame
        hybrid: the common VBR speech+music shape (dopus.d:6400 mode
        transitions).  Any stream the facade can decode is eligible,
        because the group decoder replays the facade's own packet
        generator per lane and only batches the CELT IMDCT answers."""
        if getattr(d, "channel_mapping", 1) != 0:
            return False
        if getattr(d, "s16_parity", False):
            return False  # parity diff-test mode rides the facade read path
        try:
            pkts = d._collect_packets()
        except Exception:
            return False
        if not pkts:
            return False
        parsed = []
        for data in pkts:
            pk = _opus_parse(data)
            if pk is None or pk["mode"] not in ("silk", "celt", "hybrid"):
                return False
            parsed.append(pk)
        d._mixed_pkts = parsed
        return True

    def _decode_opus_mixed_group(self, decs, to_device: bool = False):
        """Mode-switching Opus lockstep (lockstep-by-segment at frame
        granularity): every lane drives the SAME packet generator the
        facade uses (models/opus.py OpusStreamDecoder.decode_packet_gen),
        so SILK synthesis, resampler flushes, redundancy crossfades and
        the hybrid CELT delay FIFO are facade-identical by construction;
        only the full-frame CELT IMDCTs are answered here, bucketed by
        (blocks, blocksize) across lanes into one device call per bucket
        per round (ops/celt_dsp.celt_imdct_ola).  The mode sequence is
        known host-side after the TOC pre-scan, so lanes advance through
        pure-SILK packets inline and re-sync at their next CELT frame.

        Cost model: each device round pays a fixed
        upload+dispatch+download round trip that the rows amortize, while
        the facade's host IMDCT (CeltDecoder.synthesize — the EXACT
        per-stream path, so results are bit-identical to the facade)
        answers a few lanes' requests in milliseconds (the threshold was
        set on the previous accelerator's slow link; not re-measured on
        the GPU).  Below AF_TPU_OPUS_MIXED_DEVICE_MIN_LANES (default 16)
        the group therefore answers synthesis requests on the host;
        larger groups ride the bucketed device IMDCT where the lane axis
        pays for the trip.  Under a mesh the device path is mandatory
        (the dryrun covers the collective; round count must stay
        deterministic across participants)."""
        B = len(decs)
        min_dev = int(os.environ.get(
            "AF_TPU_OPUS_MIXED_DEVICE_MIN_LANES", "16"))
        use_device = self._mesh is not None or B >= min_dev
        for d in decs:
            # re-probed lanes (bisect recovery) lost the eligibility
            # stash; recompute — a lane that no longer parses raises
            # here and the lattice isolates it
            if not hasattr(d, "_mixed_pkts") and \
                    not self._opus_mixed_eligible(d):
                raise AudioFormatError("Opus: lane not mixed-eligible")
        outs = [[] for _ in range(B)]
        gens = [None] * B     # live decode_packet_gen per lane
        nexts = [0] * B       # next packet index per lane
        sends = [None] * B    # pending IMDCT answer per lane
        pkts = [d._mixed_pkts for d in decs]
        sds = [d._streams[0] for d in decs]
        done = [False] * B
        self._stat_add("opus_mixed_lanes", B)
        while not all(done):
            t_host = time.perf_counter()
            ct_host = time.thread_time()
            jobs = {}
            for bi, d in enumerate(decs):
                if done[bi]:
                    continue
                while True:
                    if gens[bi] is None:
                        if nexts[bi] >= len(pkts[bi]):
                            done[bi] = True
                            break
                        gens[bi] = sds[bi].decode_packet_gen(
                            pkts[bi][nexts[bi]])
                        nexts[bi] += 1
                        sends[bi] = None
                    try:
                        cd, params = gens[bi].send(sends[bi])
                    except StopIteration as e:
                        pcm = e.value
                        g = np.float32(d._gain)
                        outs[bi].append(
                            pcm * g if d._gain != 1.0 else pcm)
                        gens[bi] = None
                        sends[bi] = None
                        continue
                    jobs.setdefault(
                        (params["blocks"], params["blocksize"]), []
                    ).append((bi, cd, params))
                    break
            self._note_stage("host_ms", "opus", t_host, ct_host)
            if not jobs:
                continue
            if not use_device:
                # small group: facade-identical host synthesis (see
                # docstring cost model) — still lockstep, zero demotions
                t_host = time.perf_counter()
                ct_host = time.thread_time()
                for items in jobs.values():
                    for (bi, cd, p) in items:
                        sends[bi] = cd.synthesize(p)
                self._note_stage("host_ms", "opus", t_host, ct_host)
                self._stat_add("windows", 1)
                continue
            t_enq = time.perf_counter()
            for (blocks, bs), items in jobs.items():
                raw, newtail, nb = self._celt_imdct_bucket(
                    [(cd, p) for (_, cd, p) in items], blocks, bs)
                row = 0
                for (bi, cd, p) in items:
                    k = cd.output_channels
                    sends[bi] = cd.apply_raw(
                        raw[row : row + k].T, newtail[row : row + k].T,
                        p["frame_size"])
                    row += k
                self._stat_add("h2d_bytes", nb)
                self._stat_add("h2d_bytes_by_format", nb, fmt="opus")
            self._note_stage("enqueue_ms", "opus", t_enq)
            self._stat_add("windows", 1)
        result = []
        for bi, d in enumerate(decs):
            sd = sds[bi]
            total = sum(o.shape[0] for o in outs[bi])
            want = d.preskip + d.length_frames - total
            # bound by the OWED tail (delayed samples + hybrid FIFO),
            # never the raw granule field: a corrupt stream declaring
            # 2^40 samples must not allocate the remainder (opus.py
            # read() applies the same bound)
            want = min(want,
                       max(sd._delayed, sd._celt_hyb_delay.shape[0]))
            if want > 0 and sd._silk_rs is not None:
                # EOS drain of the resampler tail + hybrid CELT FIFO +
                # redundancy carry (opus.py drain_tail)
                tail = sd.drain_tail(want)
                g = np.float32(d._gain)
                outs[bi].append(tail * g if d._gain != 1.0 else tail)
            pcm = np.concatenate(outs[bi]) if outs[bi] else \
                np.zeros((0, d.channels), np.float32)
            pcm = pcm[d.preskip :]
            if d.length_frames:
                pcm = pcm[: d.length_frames]
            result.append(pcm)
        return result

    @staticmethod
    def _celt_imdct_bucket(items, blocks, bs):
        """Bucketed CELT IMDCT + OLA for the lockstep Opus groups: one
        row per output channel, each packet scaled by ITS OWN
        imdct_scale — the scale is per-packet (0.5 when a stereo-coded
        packet downmixes to mono output, models/celt.py:1243-1246), so
        bucket-mates must not inherit item 0's.

        items: [(celt_decoder, params)] in row order.  Returns
        (raw [rows, frame], newtail [rows, OVERLAP//2], bytes)."""
        from ..models.celt import OVERLAP
        from ..ops import celt_dsp

        frame = blocks * bs
        co, tails, scales = [], [], []
        for cd, p in items:
            for c in range(cd.output_channels):
                co.append(p["coeffs"][c, :frame])
                tails.append(cd.buf[c][1024 : 1024 + OVERLAP // 2])
                scales.append(np.float32(p["imdct_scale"]))
        co = np.stack(co).astype(np.float32)
        tails = np.stack(tails).astype(np.float32)
        sc = np.asarray(scales, np.float32)
        if np.all(sc == sc[0]):
            raw, newtail = celt_dsp.celt_imdct_ola(
                co, tails, blocks, bs, scale=float(sc[0]))
        else:
            # mixed scales in one bucket: pre-multiply rows host-side
            # (0.5/1.0 are exact f32 scalings — bit-identical to the
            # uniform in-kernel path)
            raw, newtail = celt_dsp.celt_imdct_ola(
                co * sc[:, None], tails, blocks, bs)
        # ONE download for both outputs: the lockstep rounds block on
        # this fetch once per window, and each transfer pays a fixed
        # round trip — two np.asarray calls doubled it
        import jax.numpy as jnp

        packed = np.asarray(jnp.concatenate([raw, newtail], axis=1))
        return (packed[:, :frame], packed[:, frame:],
                co.nbytes + tails.nbytes)

    @staticmethod
    def _hybrid_eligible(d) -> bool:
        """Lockstep-eligible hybrid: mapping-0, every packet one non-empty
        HYBRID frame with one (config, stereo).  Mode-switching streams
        stay per-stream (redundancy crossfades against a changing mode
        sequence need the serial path)."""
        import os

        if os.environ.get("AF_TPU_REFERENCE_RESAMPLER"):
            return False
        if getattr(d, "channel_mapping", 1) != 0:
            return False
        if getattr(d, "s16_parity", False):
            return False  # parity diff-test mode rides the facade read path
        try:
            pkts = d._collect_packets()
        except Exception:
            return False
        if not pkts:
            return False
        key = None
        parsed = []
        for data in pkts:
            pk = _opus_parse(data)
            if (pk is None or pk["mode"] != "hybrid"
                    or len(pk["frames"]) != 1 or len(pk["frames"][0]) == 0):
                return False
            k = (pk["config"], pk["stereo"])
            if key is None:
                key = k
            elif k != key:
                return False
            parsed.append(pk)
        d._silk_lockstep = parsed
        return True

    def _decode_hybrid_group(self, decs, nch: int, config: int,
                             stereo: bool, to_device: bool = False):
        """Batched hybrid Opus: a three-phase step built from the proven
        pieces.  H1 (host, per lane): SILK superframe at 16 kHz +
        redundancy parse + CELT SYMBOLS (bands 17+, same range decoder) —
        all on the lane's own OpusStreamDecoder state.  B (device): ONE
        polyphase conv upsamples every lane's SILK block, and the CELT
        spectra run the bucketed IMDCT (ops/celt_dsp.celt_imdct_ola) as in
        the CELT-only group.  H2 (host, per lane): postfilter/deemphasis
        via apply_raw, the CELT delay FIFO, and the reference's redundancy
        paste/fade helpers — the SAME methods the facade path uses
        (dopus.d:6400-6505), so the stateful edge cases cannot diverge."""
        from ..models.celt import OVERLAP
        from ..models.opus import RangeDecoder
        from ..models.silk import SilkDecoder
        from ..ops import celt_dsp
        from ..ops.resample import BatchedFittedUpsampler

        B = len(decs)
        for d in decs:
            # re-probed lanes lost the eligibility stash; recompute (a
            # still-eligible lane reproduces the same group key)
            if not hasattr(d, "_silk_lockstep") and \
                    not self._hybrid_eligible(d):
                raise AudioFormatError("Opus: lane not hybrid-eligible")
        # hybrid configs 12-15: 10 ms (even) / 20 ms (odd)
        dur_ms = 20 if (config & 1) else 10
        frame48 = dur_ms * 48
        T = dur_ms * 16  # SILK runs wideband under hybrid
        coded = 2 if stereo else 1
        endband = 19 if config < 14 else 21
        rows = B * nch
        # one warmup value regardless of channel count: mono copy and MS
        # unmix share a one-sample-delay timeline (models/silk.py)
        feed = 12
        rs = BatchedFittedUpsampler(2, rows, feed=feed)
        outs = [[] for _ in range(B)]
        sds = []
        for d in decs:
            sd = d._streams[0]
            if sd._silk is None:
                sd._silk = SilkDecoder(output_channels=nch)
            sds.append(sd)
        steps = max(len(d._silk_lockstep) for d in decs)
        for st in range(steps):
            t_host = time.perf_counter()
            ct_host = time.thread_time()
            X = np.zeros((rows, T), np.float32)
            stash = {}
            for bi, d in enumerate(decs):
                if st >= len(d._silk_lockstep):
                    continue
                sd = sds[bi]
                pk = d._silk_lockstep[st]
                frame = pk["frames"][0]
                rd = RangeDecoder(frame)
                native = sd._silk.decode_superframe(rd, 2, coded, dur_ms)
                X[bi * nch : (bi + 1) * nch] = native.T[:, :T]
                # redundancy flag + size (dopus.d:6400-6420)
                size = len(frame)
                redundancy = 0
                redundancy_pos = 0
                red = None
                if rd.tell() + 37 <= size * 8:
                    redundancy = rd.dec_bit_logp(12)
                if redundancy:
                    redundancy_pos = rd.dec_bit_logp(1)
                    red_size = rd.dec_uint(256) + 2
                    size -= red_size
                    if size < 0:
                        raise AudioFormatError("Opus: bad redundancy size")
                    rd.rebound_end(size)
                    if redundancy_pos:
                        sd._celt.flush()
                        red = sd._decode_red_frame(frame[size:], coded, 2)
                params = sd._celt.decode_frame_symbols(
                    rd, coded, frame48, 17, endband)
                stash[bi] = (params, redundancy, redundancy_pos, red,
                             frame, size)
            self._note_stage("host_ms", "opus", t_host, ct_host)
            if not stash:
                break
            t_enq = time.perf_counter()
            Y = rs.process(X, frame48)
            # bucketed CELT IMDCT across lanes (as _decode_opus_group)
            buckets = {}
            for bi, (params, *_rest) in stash.items():
                buckets.setdefault(
                    (params["blocks"], params["blocksize"]), []
                ).append(bi)
            raws = {}
            for (blocks, bs), lanes_b in buckets.items():
                raw, newtail, nb = self._celt_imdct_bucket(
                    [(sds[bi]._celt, stash[bi][0]) for bi in lanes_b],
                    blocks, bs)
                self._stat_add("h2d_bytes", nb)
                self._stat_add("h2d_bytes_by_format", nb, fmt="opus")
                row = 0
                for bi in lanes_b:
                    k = sds[bi]._celt.output_channels
                    raws[bi] = (raw[row : row + k].T,
                                newtail[row : row + k].T)
                    row += k
            self._note_stage("enqueue_ms", "opus", t_enq)
            self._stat_add("h2d_bytes", X.nbytes)
            self._stat_add("h2d_bytes_by_format", X.nbytes, fmt="opus")
            self._stat_add("windows", 1)
            for bi, d in enumerate(decs):
                if bi not in stash:
                    continue
                sd = sds[bi]
                (params, redundancy, redundancy_pos, red, frame,
                 size) = stash[bi]
                delayed = self._hyb_delayed.get(id(sd), 0)
                pcm = np.ascontiguousarray(
                    Y[bi * nch : (bi + 1) * nch].T)
                self._hyb_delayed[id(sd)] = \
                    delayed + frame48 - pcm.shape[0]
                raw, newtail = raws[bi]
                celt_pcm = sd._celt.apply_raw(
                    raw, newtail, frame48).astype(np.float32)
                # CELT delay FIFO (dopus.d:6424-6466)
                comb = np.concatenate([sd._celt_hyb_delay, celt_pcm])
                n = pcm.shape[0]
                pcm = pcm + comb[:n, : pcm.shape[1]]
                sd._celt_hyb_delay = comb[n:]
                sd._apply_red_carry(pcm)
                if red is not None:   # redundancy at frame start
                    sd._paste_red_start(pcm, red, delayed)
                elif redundancy:
                    sd._celt.flush()
                    red2 = sd._decode_red_frame(frame[size:], coded, 2)
                    sd._fade_red_tail(pcm, red2, delayed)
                g = np.float32(d._gain)
                outs[bi].append(pcm * g if d._gain != 1.0 else pcm)
                if st == len(d._silk_lockstep) - 1:
                    total = sum(o.shape[0] for o in outs[bi])
                    want = d.preskip + d.length_frames - total
                    # owed-tail bound (see the mixed group): everything
                    # the upsampler rows can still produce + the FIFO
                    want = min(want,
                               (rs.L + rs.A + rs._pending.shape[1] + 2)
                               * rs.den + sd._celt_hyb_delay.shape[0])
                    if want > 0:
                        cols = [rs.flush_row(bi * nch + c, want)
                                for c in range(nch)]
                        tail = np.stack(cols, 1).astype(np.float32)
                        # hybrid lanes: add the pending CELT delay FIFO
                        # + unfinished redundancy fade, as the facade's
                        # drain_tail does (dopus.d:6424-6466)
                        hd = sd._celt_hyb_delay
                        if hd.shape[0]:
                            m = min(tail.shape[0], hd.shape[0])
                            tail[:m] += hd[:m, : tail.shape[1]]
                            sd._celt_hyb_delay = hd[:0]
                        sd._apply_red_carry(tail)
                        outs[bi].append(
                            tail * g if d._gain != 1.0 else tail)
        result = []
        for bi, d in enumerate(decs):
            pcm = np.concatenate(outs[bi]) if outs[bi] else \
                np.zeros((0, nch), np.float32)
            pcm = pcm[d.preskip :]
            if d.length_frames:
                pcm = pcm[: d.length_frames]
            result.append(pcm)
        return result

    def _decode_silk_group(self, decs, nch: int, config: int, stereo: bool,
                           nfr: int = 1, to_device: bool = False):
        """Batched SILK-only Opus: per-lane host entropy+synthesis at the
        native rate (the same SilkDecoder the facade uses), then ONE
        device polyphase conv per packet step upsamples every lane to
        48 kHz (ops/resample.BatchedFittedUpsampler) — the SILK analogue
        of the MP3/FLAC host-entropy -> device-DSP split.  Lanes that end
        early drain their delayed tail immediately (flush_row) so ragged
        batches match the facade's EOS drain (opus.py read())."""
        from ..models.opus import RangeDecoder
        from ..models.silk import SilkDecoder
        from ..ops.resample import BatchedFittedUpsampler

        B = len(decs)
        for d in decs:
            # re-probed lanes lost the eligibility stash; recompute (a
            # still-eligible lane reproduces the same group key)
            if not hasattr(d, "_silk_lockstep") and \
                    not self._silk_eligible(d):
                raise AudioFormatError("Opus: lane not SILK-eligible")
        bw = config // 4
        dur_ms = [10, 20, 40, 60][config & 3]
        frame48 = dur_ms * 48 * nfr          # nfr frames per packet
        rate = [8000, 12000, 16000][bw]
        T = dur_ms * rate // 1000 * nfr
        coded = 2 if stereo else 1
        rows = B * nch
        # one warmup value regardless of channel count (models/silk.py:
        # mono copy and MS unmix share a one-sample-delay timeline)
        feed = [4, 9, 12][bw]
        rs = BatchedFittedUpsampler(bw, rows, feed=feed)
        silks = [SilkDecoder(output_channels=nch) for _ in decs]
        outs = [[] for _ in range(B)]
        steps = max(len(d._silk_lockstep) for d in decs)
        for s in range(steps):
            t_host = time.perf_counter()
            ct_host = time.thread_time()
            X = np.zeros((rows, T), np.float32)
            for bi, d in enumerate(decs):
                if s >= len(d._silk_lockstep):
                    continue
                pk = d._silk_lockstep[s]
                cols = []
                for fr in pk["frames"]:
                    rd = RangeDecoder(fr)
                    cols.append(silks[bi].decode_superframe(
                        rd, bw, coded, dur_ms))
                    if rd.tell() + 17 <= len(fr) * 8:
                        # unconsumed tail = a mode-transition CELT
                        # redundancy frame (dopus.d:6340): the lockstep
                        # group cannot splice the 5 ms fade at the
                        # native rate — demote this lane so the facade
                        # path decodes it (opus.py SILK-only branch)
                        raise AudioFormatError(
                            "Opus: SILK redundancy tail in group")
                native = np.concatenate(cols, axis=0)
                X[bi * nch : (bi + 1) * nch] = native.T[:, :T]
            self._note_stage("host_ms", "opus", t_host, ct_host)
            t_enq = time.perf_counter()
            Y = rs.process(X, frame48)
            self._note_stage("enqueue_ms", "opus", t_enq)
            self._stat_add("h2d_bytes", X.nbytes)
            self._stat_add("h2d_bytes_by_format", X.nbytes, fmt="opus")
            self._stat_add("windows", 1)
            for bi, d in enumerate(decs):
                if s >= len(d._silk_lockstep):
                    continue
                pcm = np.ascontiguousarray(Y[bi * nch : (bi + 1) * nch].T)
                g = np.float32(d._gain)
                outs[bi].append(pcm * g if d._gain != 1.0 else pcm)
                if s == len(d._silk_lockstep) - 1:
                    # EOS: drain the delayed tail NOW, before later steps
                    # zero-feed this lane's resampler rows (owed-tail
                    # bound as in the mixed group: never the granule)
                    total = sum(o.shape[0] for o in outs[bi])
                    want = d.preskip + d.length_frames - total
                    want = min(want,
                               (rs.L + rs.A + rs._pending.shape[1] + 2)
                               * rs.den)
                    if want > 0:
                        cols = [rs.flush_row(bi * nch + c, want)
                                for c in range(nch)]
                        tail = np.stack(cols, 1).astype(np.float32)
                        outs[bi].append(
                            tail * g if d._gain != 1.0 else tail)
        result = []
        for bi, d in enumerate(decs):
            pcm = np.concatenate(outs[bi]) if outs[bi] else \
                np.zeros((0, nch), np.float32)
            pcm = pcm[d.preskip :]
            if d.length_frames:
                pcm = pcm[: d.length_frames]
            result.append(pcm)
        return result

    def _decode_opus_group(self, decs, to_device: bool = False):
        # to_device accepted for interface parity; the CELT lockstep path
        # still assembles per-frame on the host (device-resident output is
        # an MP3/FLAC feature so far)
        """CELT lockstep: the host symbol stage runs per frame per lane,
        then ONE device call per (blocks, blocksize) bucket does the
        IMDCT + windowed OLA for every lane (ops/celt_dsp.celt_imdct_ola);
        the pitch postfilter + deemphasis finish on the host
        (data-dependent IIR)."""
        from ..models.opus import RangeDecoder
        from ..models.celt import OVERLAP
        from ..ops import celt_dsp

        B = len(decs)
        for d in decs:
            # re-probed lanes (bisect recovery) lost the eligibility
            # stash; recompute — a lane that no longer qualifies raises
            # here and the lattice isolates it (same recipe as the
            # mixed-mode group)
            if not hasattr(d, "_lockstep_packets") and \
                    not self._opus_eligible(d):
                raise AudioFormatError("Opus: lane not lockstep-eligible")
        # flatten every lane's packets into frame lists
        lane_frames = []
        for d in decs:
            frames = []
            for data in d._lockstep_packets:
                pk = _opus_parse(data)
                for fr in pk["frames"]:
                    frames.append((fr, pk))
            lane_frames.append(frames)
        n_steps = max(len(f) for f in lane_frames)
        outputs = [[] for _ in range(B)]
        for step in range(n_steps):
            buckets = {}
            t_host = time.perf_counter()
            ct_host = time.thread_time()
            for bi, d in enumerate(decs):
                if step >= len(lane_frames[bi]):
                    continue
                fr, pk = lane_frames[bi][step]
                cd = d._streams[0]._celt
                n = pk["frame_size"]
                if len(fr) == 0:
                    outputs[bi].append(
                        np.zeros((n, d.channels), np.float32))
                    continue
                endband = [13, 17, 19, 21][(pk["config"] - 16) >> 2]
                rd = RangeDecoder(fr)
                params = cd.decode_frame_symbols(
                    rd, 2 if pk["stereo"] else 1, n, 0, endband)
                buckets.setdefault(
                    (params["blocks"], params["blocksize"]), []
                ).append((bi, d, cd, params, n))
            self._note_stage("host_ms", "opus", t_host, ct_host)
            t_enq = time.perf_counter()
            for (blocks, bs), items in buckets.items():
                raw, newtail, nb = self._celt_imdct_bucket(
                    [(cd, p) for (_, _, cd, p, _) in items], blocks, bs)
                self._stat_add("h2d_bytes", nb)
                self._stat_add("h2d_bytes_by_format", nb, fmt="opus")
                row = 0
                for (bi, d, cd, p, n) in items:
                    k = cd.output_channels
                    pcm = cd.apply_raw(raw[row : row + k].T,
                                       newtail[row : row + k].T, n)
                    row += k
                    g = np.float32(d._gain)
                    outputs[bi].append(
                        (pcm * g if d._gain != 1.0 else pcm
                         ).astype(np.float32))
            if buckets:
                self._note_stage("enqueue_ms", "opus", t_enq)
        result = []
        for bi, d in enumerate(decs):
            pcm = np.concatenate(outputs[bi]) if outputs[bi] else \
                np.zeros((0, d.channels), np.float32)
            pcm = pcm[d.preskip :]
            if d.length_frames:
                pcm = pcm[: d.length_frames]
            result.append(pcm)
        return result
