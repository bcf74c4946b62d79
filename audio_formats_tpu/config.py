"""Public enums and configuration.

Mirrors the reference's public surface (stream.d:36-67):
``AudioFileFormat``, ``AudioSampleFormat``, ``EncodingOptions``.

The reference selects codecs at *build* time via dub configurations
(dub.json:6-22, license-driven).  This framework replaces that with a
runtime :class:`CodecConfig`, defaulting to everything enabled.
"""

from __future__ import annotations

import dataclasses
import enum


class AudioFileFormat(enum.Enum):
    """Audio container/codec formats (stream.d:36-48)."""

    wav = "wav"
    mp3 = "mp3"
    flac = "flac"
    ogg = "ogg"
    opus = "opus"
    qoa = "qoa"
    mod = "mod"
    xm = "xm"
    unknown = "unknown"

    def __str__(self) -> str:  # convertAudioFileFormatToString equivalent
        return self.value


class AudioSampleFormat(enum.Enum):
    """Output sample format for encoding (stream.d:51-58)."""

    s8 = "s8"
    s16 = "s16"
    s24 = "s24"
    fp32 = "fp32"
    fp64 = "fp64"


#: The length of things you shouldn't query a length about (stream.d:84).
AUDIOSTREAM_UNKNOWN_LENGTH = -1


@dataclasses.dataclass
class EncodingOptions:
    """Optional encode parameters (stream.d:59-67).

    ``sample_format`` is ignored for QOA; ``enable_dither`` applies to
    8/16/24-bit WAV output.
    """

    sample_format: AudioSampleFormat = AudioSampleFormat.fp32
    enable_dither: bool = True
    #: Seed for the device TPDF dither PRNG.  The reference uses C ``rand()``
    #: (wav.d:694-696) which is irreproducible; we use a counter-based PRNG so
    #: encodes are deterministic given a seed.
    dither_seed: int = 0x5EED


@dataclasses.dataclass
class CodecConfig:
    """Runtime codec enablement — replaces the reference's license-driven dub
    configurations (dub.json:6-22)."""

    decode_wav: bool = True
    encode_wav: bool = True
    decode_qoa: bool = True
    encode_qoa: bool = True
    decode_mp3: bool = True
    decode_flac: bool = True
    decode_ogg: bool = True
    decode_opus: bool = True
    decode_mod: bool = True
    decode_xm: bool = True
    #: MOD: linear-resampling mix — the reference's one runtime feature
    #: flag, the AF_LINEAR build option (pocketmod.d:694-700,
    #: README.md:74-79).  Default off = the distribution's nearest mixing.
    mod_linear_resampling: bool = False
    #: XM: linear sample interpolation (libxm.d:50
    #: XM_LINEAR_INTERPOLATION; the reference distribution ships it off).
    xm_linear_interpolation: bool = False


DEFAULT_CODEC_CONFIG = CodecConfig()
