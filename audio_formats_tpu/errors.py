"""Error model for the batched audio framework.

The reference library is ``nothrow @nogc``: errors are a sticky per-stream flag
plus a static message (see /root/reference/source/audioformats/internals.d:16-23
and stream.d:1534).  We reproduce those exact semantics at the ``AudioStream``
facade (``is_error()`` / ``error_message()``), while internal code communicates
failures with the :class:`AudioFormatError` exception, which the facade catches
and converts into the sticky flag.

For the batched path the analogue is a *per-lane* error lattice: one corrupt
stream inside a batch of 1024 must only poison its own lane (see
``parallel/batch.py``), mirroring how the reference disambiguates short reads
via ``isError()`` (stream.d:424-427).
"""

from __future__ import annotations

# Canonical messages — mirrors internals.d:16-23.
K_ERROR_UNSUPPORTED_ENCODING_FORMAT = (
    "Unsupported encoding format, maybe check your audio-formats configuration"
)
K_ERROR_DECODER_INITIALIZATION_FAILED = "Decoder initialization failed"
K_ERROR_FILE_OPEN_FAILED = "Couldn't open file"
K_ERROR_FLUSH_FAILED = "Flushing stream failed"
K_ERROR_DECODING_ERROR = "Decoder encountered an error"
K_ERROR_ENCODING_ERROR = "Encoder encountered an error"
K_ERROR_UNKNOWN_FORMAT = "Cannot decode stream: unrecognized encoding."
K_ERROR_NOT_INITIALIZED = "Stream not initialized"
K_ERROR_SEEK_UNSUPPORTED = "Seeking not supported for this stream"


class AudioFormatError(Exception):
    """Internal exception; converted to the sticky error flag at the facade."""

    def __init__(self, message: str = K_ERROR_DECODING_ERROR):
        super().__init__(message)
        self.message = message
