"""Byte-stream abstraction — this framework's equivalent of io.d.

The reference abstracts I/O as seven pull-style callbacks
(io.d:7-13, ``IOCallbacks`` io.d:16) so codecs never see files; concrete
backends are ``FileContext`` (stream.d:1941) and ``MemoryContext``
(stream.d:2019).  We keep the same seam — every host-side demux/entropy stage
consumes a :class:`ByteSource` — but expose whole-buffer, zero-copy access:
batched decoding wants the full compressed byte-stream resident (mmap'd) so
the host stage can run frame discovery/indexing without a callback per read.

A :class:`CallbackSource` adapter preserves the reference's
``openWithCallbacks``-style entry point for user-defined streams.
"""

from __future__ import annotations

import io as _pyio
import mmap
import os
from typing import Callable, Optional

from ..errors import AudioFormatError, K_ERROR_FILE_OPEN_FAILED


class ByteSource:
    """Random-access read-only byte stream with an explicit cursor.

    Mirrors the semantics of IOCallbacks' seek/tell/getFileLength/read/
    nothingToReadAnymore (io.d:16-80) over a contiguous buffer.
    """

    def __init__(self, data, name: str = "<memory>"):
        # ``data`` is anything exposing the buffer protocol (bytes, mmap,
        # memoryview, numpy array of uint8).
        self._buf = memoryview(data).cast("B")
        self._pos = 0
        self.name = name

    # -- reference IOCallbacks surface -------------------------------------
    def seek(self, offset: int, relative: bool = False) -> bool:
        pos = self._pos + offset if relative else offset
        if pos < 0 or pos > len(self._buf):
            return False
        self._pos = pos
        return True

    def tell(self) -> int:
        return self._pos

    def size(self) -> int:
        return len(self._buf)

    def remaining(self) -> int:
        return len(self._buf) - self._pos

    def eof(self) -> bool:
        return self._pos >= len(self._buf)

    def read(self, n: int) -> memoryview:
        """Read up to ``n`` bytes; short read at EOF (io.d:59-66 semantics)."""
        end = min(self._pos + n, len(self._buf))
        out = self._buf[self._pos : end]
        self._pos = end
        return out

    def read_exact(self, n: int) -> memoryview:
        out = self.read(n)
        if len(out) != n:
            raise AudioFormatError("Unexpected end of stream")
        return out

    def peek(self, n: int, offset: int = 0) -> memoryview:
        start = self._pos + offset
        return self._buf[start : min(start + n, len(self._buf))]

    # -- zero-copy whole-buffer access (batched host stage) ----------------
    def view(self) -> memoryview:
        return self._buf

    def close(self) -> None:
        pass


class MemorySource(ByteSource):
    """open_from_memory backend (MemoryContext, stream.d:2019)."""


class FileSource(ByteSource):
    """open_from_file backend.  mmap's the file for zero-copy access
    (replaces FileContext's fopen/fread, stream.d:1941-2014)."""

    def __init__(self, path: str | os.PathLike):
        try:
            f = open(path, "rb")
        except OSError as e:
            raise AudioFormatError(K_ERROR_FILE_OPEN_FAILED) from e
        self._file = f
        try:
            size = os.fstat(f.fileno()).st_size
            if size == 0:
                self._mm = None
                super().__init__(b"", name=str(path))
            else:
                self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                super().__init__(self._mm, name=str(path))
        except OSError as e:
            f.close()
            raise AudioFormatError(K_ERROR_FILE_OPEN_FAILED) from e

    def close(self) -> None:
        # Release the memoryview before the mmap, else mmap.close() raises.
        self._buf.release()
        if self._mm is not None:
            self._mm.close()
        self._file.close()


class CallbackSource(ByteSource):
    """open_with_callbacks backend: user supplies read/seek/tell/size
    callables (the reference's user-facing IOCallbacks contract).  The stream
    is drained once into memory — codecs then get random access."""

    def __init__(
        self,
        read: Callable[[int], bytes],
        seek: Optional[Callable[[int], None]] = None,
        size: Optional[Callable[[], int]] = None,
    ):
        if seek is not None:
            seek(0)
        chunks = []
        while True:
            c = read(1 << 20)
            if not c:
                break
            chunks.append(c)
        super().__init__(b"".join(chunks), name="<callbacks>")


class ByteSink:
    """Growable output buffer — encoding backend for open_to_buffer /
    open_to_memory / open_to_file (stream.d:182-300).

    Supports random-access patching (seek+write) which WAV finalize needs to
    backpatch RIFF/data sizes (wav.d:572-605) and QOA needs for the header
    frame count (qoa.d:673-699).
    """

    def __init__(self):
        self._buf = bytearray()
        self._pos = 0

    def write(self, data: bytes) -> None:
        end = self._pos + len(data)
        if end > len(self._buf):
            self._buf.extend(b"\0" * (end - len(self._buf)))
        self._buf[self._pos : end] = data
        self._pos = end

    def seek(self, offset: int, relative: bool = False) -> bool:
        pos = self._pos + offset if relative else offset
        if pos < 0:
            return False
        self._pos = pos
        return True

    def tell(self) -> int:
        return self._pos

    def size(self) -> int:
        return len(self._buf)

    def getvalue(self) -> bytes:
        return bytes(self._buf)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class FileSink(ByteSink):
    """File-backed encoding sink."""

    def __init__(self, path: str | os.PathLike):
        super().__init__()
        self._path = path
        try:
            # Validate writability up-front, like fopen("wb") would.
            self._file = open(path, "wb")
        except OSError as e:
            raise AudioFormatError(K_ERROR_FILE_OPEN_FAILED) from e

    def flush(self) -> None:
        self._file.seek(0)
        self._file.write(self._buf)
        self._file.flush()

    def close(self) -> None:
        self.flush()
        self._file.close()
