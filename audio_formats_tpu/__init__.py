"""audio_formats_tpu — a batched audio codec framework on JAX accelerators.

A from-scratch reimplementation of the capabilities of AuburnSounds'
audio-formats (D) as a two-stage pipeline: a host demux/entropy stage turning
compressed byte-streams into dense tensors, and a device DSP stage of
JAX/Pallas kernels (IMDCTs, filterbanks, integer LPC/LMS scans, dither)
batched over many streams and sharded over device meshes.

Public surface (parity with the reference):

* :class:`AudioStream` — open/read/write/seek/tell single-stream facade
* :func:`save_as_wav`, :func:`to_wav` — one-shot encode helpers (package.d)
* ``BatchDecoder`` (``audio_formats_tpu.parallel``) — the batched
  decode API (the reference is strictly single-stream; this is the new core)
"""

from .config import (
    AUDIOSTREAM_UNKNOWN_LENGTH,
    AudioFileFormat,
    AudioSampleFormat,
    CodecConfig,
    EncodingOptions,
)
from .errors import AudioFormatError
from .highlevel import save_as_wav, to_wav
from .stream import AudioStream

__version__ = "0.1.0"

__all__ = [
    "AudioStream",
    "AudioFileFormat",
    "AudioSampleFormat",
    "AudioFormatError",
    "CodecConfig",
    "EncodingOptions",
    "AUDIOSTREAM_UNKNOWN_LENGTH",
    "save_as_wav",
    "to_wav",
    "__version__",
]
