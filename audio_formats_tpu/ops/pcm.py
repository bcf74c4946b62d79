"""PCM sample-format conversion kernels (device side).

Covers the numeric core of WAV decode/encode (wav.d:242-344 decode scaling,
wav.d:475-553 quantization, wav.d:679-701 TPDF dither) and the final
int→float stage every integer codec (FLAC/QOA) shares.

Bit-exactness strategy
----------------------
* **Decode** (int → float32): the reference computes ``float(double(s) / scale)``
  (wav.d:297-330).  A *correctly rounded* float32 division ``f32(s) / f32(scale)``
  is bit-identical — verified exhaustively for u8/s16/s24 and by sampling for
  s32 (see tests/test_pcm.py).  An accelerator's f32 divide need not be
  correctly rounded, so the kernel refines it: with scale = 2^m - 1 the residual
  ``s - q0*scale`` is computable exactly in f32 (``q0*2^m`` is exact, then
  TwoSum), and one Newton correction lands within 2^-20 ulp of the true
  quotient.  Since ``s/(2^m - 1)`` can never be an exact rounding midpoint
  (odd denominator), the corrected result is correctly rounded for every
  integer input — bit-exact to the reference on every backend.

* **Encode** (float32 → int, no dither): the reference rounds in double:
  ``trunc(bias + 0.5 + x*scale) - bias`` == ``floor(x*scale + 0.5)`` for
  in-range x (wav.d:487-525).  float32 can't represent ``x*scale`` exactly
  (scale = 2^m - 1), so the kernel computes the product as an exact two-float
  (TwoSum) expansion ``hi + err`` and resolves the round-half-up decision
  exactly.  This keeps encode on-device *and* bit-exact.

* **Dither** (TPDF, wav.d:679-701): ``floor(x*scale + 0.3125 + 0.25*u1 +
  0.125*u2)`` with u ~ U[0,1].  The reference uses C ``rand()`` so exact match
  is impossible by construction; we use counter-based threefry bits, making
  encodes deterministic given ``EncodingOptions.dither_seed``.

Deviation from the reference (documented): inputs outside [-1, 1] are clamped
before quantization; the reference wraps/asserts (wav.d:503 assert).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Quantization scales per sample format (wav.d: 127.0 / 32767.0 / 8388607.0).
SCALE = {"u8": 127.0, "s16": 32767.0, "s24": 8388607.0, "s32": 2147483648.0}
# Power-of-two factor with scale = 2^m - 1 (used by the exact TwoSum path).
POW2 = {"u8": 128.0, "s16": 32768.0, "s24": 8388608.0}

_LANE = 1024  # pad granularity for 1-D kernel calls


def _pad_len(n: int) -> int:
    if n <= _LANE:
        return _LANE
    # next power of two — bounds the number of distinct compiled shapes
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# Decode: int PCM -> float
# ---------------------------------------------------------------------------

def _exact_div_pow2m1(xf: jax.Array, kind: str) -> jax.Array:
    """Correctly-rounded f32 division of integer-valued ``xf`` by 2^m - 1.

    XLA's f32 divide is not guaranteed correctly rounded on every backend
    (on the CPU, for some scales, it is not).  Because the divisor is 2^m - 1, the product q0*(2^m - 1) =
    q0*2^m - q0 is an exact two-float expansion (power-of-two scaling is
    exact), so the residual is exact and one correction step yields the
    correctly rounded quotient (no rounding midpoints exist for odd divisors).
    """
    c = jnp.float32(SCALE[kind])
    pow2 = jnp.float32(POW2[kind])
    q0 = xf / c  # seed quotient, within a few ulp on any backend
    ph, pl = _two_sum(q0 * pow2, -q0)  # ph + pl == q0 * c, exactly
    r = (xf - ph) - pl  # residual, exact to well below 1 ulp of q0
    return q0 + r / c


@functools.partial(jax.jit, static_argnames=("kind",))
def _int_to_f32(x: jax.Array, kind: str) -> jax.Array:
    xf = x.astype(jnp.float32)
    if kind == "u8":
        return _exact_div_pow2m1(xf - 128.0, kind)
    if kind == "s32":
        return xf / jnp.float32(SCALE[kind])  # power of two: exact scaling
    return _exact_div_pow2m1(xf, kind)


def int_pcm_to_float(x: np.ndarray, kind: str, dtype=np.float32) -> np.ndarray:
    """Convert int PCM (int32 array; u8 passed as raw 0..255) to float.

    float32 goes through the device kernel; float64 uses the host (JAX runs
    without 64-bit floats by default) and matches the reference's double
    math directly.
    """
    n = x.shape[0]
    if dtype == np.float64 or n == 0:
        xf = x.astype(np.float64)
        if kind == "u8":
            out = (xf - 128.0) / 127.0
        else:
            out = xf / SCALE[kind]
        return out.astype(dtype)
    xp = np.zeros(_pad_len(n), dtype=np.int32)
    xp[:n] = x
    return np.asarray(_int_to_f32(xp, kind))[:n]


def int_pcm_to_float_np(x: np.ndarray, kind: str) -> np.ndarray:
    """Host golden model (double math, as the reference)."""
    xf = x.astype(np.float64)
    if kind == "u8":
        return ((xf - 128.0) / 127.0).astype(np.float32)
    return (xf / SCALE[kind]).astype(np.float32)


# ---------------------------------------------------------------------------
# Encode: float -> int PCM (exact round-half-up via TwoSum)
# ---------------------------------------------------------------------------

def _two_sum(a, b):
    s = a + b
    bv = s - a
    err = (a - (s - bv)) + (b - bv)
    return s, err


def _exact_scale_round(x, kind: str):
    """floor(x * (2^m - 1) + 0.5) computed exactly in f32, x in [-1, 1]."""
    pow2 = jnp.float32(POW2[kind])
    hi = x * pow2  # exact: power-of-two scaling
    s, err = _two_sum(hi, -x)  # s + err == x * (2^m - 1), exactly
    f = jnp.round(s)  # candidate integer (any tie rule; corrected below)
    d = s - f  # exact (Sterbenz), |d| <= 0.5
    # compare d + err against ±0.5 EXACTLY: a rounded f32 sum loses err
    # when d sits on the boundary (e.g. true product 0.5 - 5e-10 with
    # d == 0.5: fl(d + err) == 0.5 would wrongly round up).  TwoSum keeps
    # the residual, making the comparison lexicographic and exact.
    u, v = _two_sum(d, err)  # u + v == d + err, exactly
    up = (u > 0.5) | ((u == 0.5) & (v >= 0))
    dn = (u < -0.5) | ((u == -0.5) & (v < 0))
    k = f + up.astype(jnp.float32) - dn.astype(jnp.float32)
    return k


@functools.partial(jax.jit, static_argnames=("kind",))
def _quantize_nodither(x: jax.Array, kind: str) -> jax.Array:
    scale = jnp.float32(SCALE[kind])
    xc = jnp.clip(x, -1.0, 1.0)
    if kind in POW2:
        k = _exact_scale_round(xc, kind)
    else:  # s32: scale is a power of two; product is exact
        k = jnp.floor(xc * scale + 0.5)
    k = jnp.clip(k, -scale, scale)
    return k.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("kind",))
def _quantize_dither(x: jax.Array, seed: jax.Array, kind: str) -> jax.Array:
    scale = jnp.float32(SCALE[kind])
    key = jax.random.fold_in(jax.random.key(0x7D17), seed)
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, x.shape, dtype=jnp.float32)
    u2 = jax.random.uniform(k2, x.shape, dtype=jnp.float32)
    # TPDF constants TUNE0=0.25, TUNE1=0.125; offset 0.5-0.5*(T0+T1)=0.3125
    # (wav.d:687-697).
    y = x * scale + jnp.float32(0.3125) + 0.25 * u1 + 0.125 * u2
    k = jnp.floor(y)
    k = jnp.clip(k, -scale, scale)
    return k.astype(jnp.int32)


def quantize_float_to_int(
    x: np.ndarray, kind: str, *, dither: bool, seed: int = 0
) -> np.ndarray:
    """Quantize float PCM in [-1,1] to signed ints (symmetric ±scale)."""
    n = x.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    xp = np.zeros(_pad_len(n), dtype=np.float32)
    xp[:n] = x
    if dither and kind != "s32":
        out = _quantize_dither(xp, jnp.uint32(seed & 0xFFFFFFFF), kind)
    else:
        out = _quantize_nodither(xp, kind)
    return np.asarray(out)[:n]


def quantize_float_to_int_np(x: np.ndarray, kind: str) -> np.ndarray:
    """Host golden model of the no-dither path (double math, reference
    semantics wav.d:487-525), used by tests and the f64 encode path."""
    scale = SCALE[kind]
    xd = np.clip(x.astype(np.float64), -1.0, 1.0)
    k = np.floor(xd * scale + 0.5)
    k = np.clip(k, -scale, scale)
    return k.astype(np.int32)


@functools.partial(jax.jit, static_argnames=("kind", "dither"))
def _quantize_rows(x, seeds, kind: str, dither: bool):
    if dither and kind != "s32":
        return jax.vmap(lambda r, s: _quantize_dither(r, s, kind))(x, seeds)
    return jax.vmap(lambda r: _quantize_nodither(r, kind))(x)


def quantize_float_to_int_batch(rows, lens, kinds_seed, kind: str, *,
                                dither: bool):
    """Batched encode quantize: rows [L, n_pad] float32 (zero-padded),
    lens [L] valid counts, kinds_seed [L] per-lane dither seeds.  The
    dither noise at position p is seed+position-determined (length
    invariant), so each lane reproduces the single-stream encoder's bytes
    exactly.  Returns a list of [len_i] int32 arrays."""
    L, n = rows.shape
    npad = _pad_len(n)
    xp = np.zeros((L, npad), np.float32)
    xp[:, :n] = rows
    out = np.asarray(_quantize_rows(
        xp, np.asarray(kinds_seed, np.uint32), kind, dither))
    return [out[i, : lens[i]] for i in range(L)]


def _pad_len_rows(n: int) -> int:
    """Width bucket for batched encode rows: pow2 up to 64 Ki, then
    multiples of 64 Ki.  The 1-D pow2 buckets double the wire past the
    stream length (352,800 samples pads to 524,288 — +49% on a link-bound
    path); 64 Ki granularity caps padding at ~12% while keeping the
    compile-cache variant count small.  Always a multiple of 4 (the s24
    byte packer groups 4 samples into 3 words)."""
    if n <= (1 << 16):
        return max(_LANE, 1 << (n - 1).bit_length())
    return -(-n // (1 << 16)) * (1 << 16)


@functools.partial(jax.jit, static_argnames=("kind", "dither"))
def _quantize_pack_rows(x, seeds, kind: str, dither: bool):
    """Quantize float rows and pack the WAV byte stream ON DEVICE as u32
    words (little-endian byte order), so the download is exactly the
    payload bytes — 3 B/sample for s24 instead of a 4 B int32 plane that
    the host then re-packs (wav.d:487-525 semantics, _pack_int_pcm
    byte-identical)."""
    if dither and kind != "s32":
        k = jax.vmap(lambda r, s: _quantize_dither(r, s, kind))(x, seeds)
    else:
        k = jax.vmap(lambda r: _quantize_nodither(r, kind))(x)
    L, n = k.shape
    ku = k.astype(jnp.uint32)
    if kind == "u8":
        g = ((ku + 128) & 0xFF).reshape(L, n // 4, 4)  # u8 bias (wav.d:489)
        return (g[..., 0] | (g[..., 1] << 8) | (g[..., 2] << 16)
                | (g[..., 3] << 24))
    if kind == "s16":
        g = (ku & 0xFFFF).reshape(L, n // 2, 2)
        return g[..., 0] | (g[..., 1] << 16)
    if kind == "s24":
        g = ku.reshape(L, n // 4, 4)
        a, b, c, d = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
        w0 = (a & 0xFFFFFF) | ((b & 0xFF) << 24)
        w1 = ((b >> 8) & 0xFFFF) | ((c & 0xFFFF) << 16)
        w2 = ((c >> 16) & 0xFF) | ((d & 0xFFFFFF) << 8)
        return jnp.stack([w0, w1, w2], axis=-1).reshape(L, -1)
    return ku  # s32: the int32 plane IS the byte stream


def quantize_pack_rows(rows, lens, seeds, kind: str, sample_size: int, *,
                       dither: bool, mesh=None):
    """Batched encode quantize+pack: rows [L, n] float32 (zero-padded to a
    _pad_len_rows bucket here), lens [L] valid sample counts.  Returns a
    list of L byte strings — each lane's exact WAV data payload.

    mesh: optional jax.sharding.Mesh — shards the lane axis over 'data'
    (lanes are independent, so the sharded bytes are bit-identical)."""
    L, n = rows.shape
    npad = _pad_len_rows(n)
    nd = mesh.shape.get("data", 1) if mesh is not None else 1
    Lp = -(-L // nd) * nd
    xp = np.zeros((Lp, npad), np.float32)
    xp[:L, :n] = rows
    seeds_a = np.zeros(Lp, np.uint32)
    seeds_a[:L] = np.asarray(seeds, np.uint32)
    if mesh is not None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        xp = jax.device_put(xp, NamedSharding(mesh, P("data", None)))
        seeds_a = jax.device_put(seeds_a, NamedSharding(mesh, P("data")))
    w = np.asarray(_quantize_pack_rows(xp, seeds_a, kind, dither))
    return [w[i].tobytes()[: sample_size * lens[i]] for i in range(L)]
