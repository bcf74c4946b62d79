"""FLAC LPC synthesis kernels — int32 sequential scan on device.

FLAC reconstructs each sample as ``residual[t] + (Σ coef[j]·s[t-1-j]) >> shift``
(drflac__calculate_prediction_32, drflac.d:1060).  CONSTANT / VERBATIM /
FIXED / LPC subframes all reduce to this one recurrence:

* CONSTANT/VERBATIM → order = blocksize (every sample passes through)
* FIXED k           → the constant coefficient rows below, shift 0
* LPC               → coded coefficients and shift

The recurrence's per-step truncating shift makes it non-linear, so no
parallel-scan shortcut preserves bit-exactness; it runs sequentially over
time, vectorized across (streams × channels) lanes: as a `lax.scan`
(`flac_lpc_scan`, the reference and the CPU path) or, on the GPU, as one
kernel that keeps the time loop inside (`flac_lpc_pallas`).

Bit-width dispatch mirrors drflac (drflac.d:1055-1110): subframes with
bits-per-sample ≤ 16 use int32 math (wraparound semantics identical to the
reference's C int); wider subframes need 64-bit accumulation and are routed
to the exact int64 host path (`flac_lpc_np`) until the device int64-emulation
kernel lands.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu_triton
from jax.sharding import NamedSharding, PartitionSpec

# Fixed-predictor coefficients (drflac.d:1397-equivalent; FLAC spec):
# s[t] = k-th order polynomial predictor + residual, shift 0.
FIXED_COEFFS = np.zeros((5, 32), dtype=np.int32)
FIXED_COEFFS[1, :1] = [1]
FIXED_COEFFS[2, :2] = [2, -1]
FIXED_COEFFS[3, :3] = [3, -3, 1]
FIXED_COEFFS[4, :4] = [4, -6, 4, -1]

MAX_ORDER = 32


@jax.jit
def flac_lpc_scan(residual, coeffs, order, shift, exact=None):
    """LPC synthesis over lanes with drflac's dual arithmetic semantics.

    residual: [L, B] int32 — residuals; positions t < order[l] hold the
              warm-up samples verbatim.
    coeffs:   [L, 32] int32 — coeffs[l, j] multiplies s[t-1-j]; zero-padded
              past the order.
    order:    [L] int32; shift: [L] int32 (non-negative).
    exact:    optional [L] bool — lanes needing drflac's 64-bit (exact)
              prediction (subframe bps > 16, drflac.d:1055-1110).  False
              lanes use int32 wraparound, bit-identical to the 32-bit path.

    The exact path avoids 64-bit ints (off in JAX by default) by splitting
    coefficients into 8-bit limbs: A = Σ (c>>8)·s, B = Σ (c&255)·s — both
    int32-safe for |s| < 2^18 at the maximum order (32 taps × 255 × 2^18 ≈
    2^31), i.e. ≤18-bit subframes incl. the +1-bit side channels of 16-bit
    stereo.  models/flac.py enforces this by routing bps > 18 subframes to
    the int64 host path; widening that routing without revisiting the limb
    split would silently overflow here.  The 40-bit product A·2^8 + B is then
    shifted exactly via hi = A + (B>>8), lo = B&255:
      shift ≥ 8: result = hi >> (shift-8)                (remainder < 2^shift)
      shift < 8: result = (hi << (8-shift)) + (lo >> shift)
    The wrap path is (A<<8) + B in int32 — identical mod 2^32 to Σ c·s.

    Returns samples [L, B] int32.
    """
    L = residual.shape[0]
    history = jnp.zeros((L, MAX_ORDER), jnp.int32)  # history[:, j] = s[t-1-j]
    c_hi = coeffs >> 8
    c_lo = coeffs & 255
    if exact is None:
        exact_l = jnp.zeros((L,), bool)
    else:
        exact_l = exact
    sm8 = jnp.maximum(shift - 8, 0)
    s8m = jnp.maximum(8 - shift, 0)
    shift_ge8 = shift >= 8

    def step(carry, inp):
        h = carry
        r, t = inp  # r: [L], t: scalar
        A = jnp.sum(h * c_hi, axis=-1, dtype=jnp.int32)
        B = jnp.sum(h * c_lo, axis=-1, dtype=jnp.int32)
        hi = A + (B >> 8)
        lo = B & 255
        pred_exact = jnp.where(
            shift_ge8, hi >> sm8, (hi << s8m) + (lo >> shift)
        )
        pred_wrap = ((A << 8) + B) >> shift
        pred = jnp.where(exact_l, pred_exact, pred_wrap)
        s = jnp.where(t < order, r, r + pred)
        h = jnp.concatenate([s[:, None], h[:, :-1]], axis=1)
        return h, s

    B_ = residual.shape[1]
    _, out = jax.lax.scan(
        step,
        history,
        (jnp.swapaxes(residual, 0, 1), jnp.arange(B_, dtype=jnp.int32)),
    )
    return jnp.swapaxes(out, 0, 1)


#: lanes per program of the GPU kernel, one lane per thread (tuned on an
#: H100: 32-128 lanes and 4-16 steps per load all ran within noise)
LPC_BLOCK_LANES = 64
#: residual rows each loop iteration loads before its recurrence steps
LPC_STEPS_PER_LOAD = 8


def _lpc_kernel(params_ref, chi_ref, clo_ref, res_ref, out_ref):
    """One program = one block of lanes, the whole time loop inside it.

    The recurrence is sequential in time, so a per-step XLA loop pays a
    launch per sample; here the launch is paid once.  The 32-tap history
    is a tuple of per-lane vectors (a register shift, no data movement),
    and residuals are time-major, so each step's row load is coalesced
    across lanes.  Each loop iteration loads LPC_STEPS_PER_LOAD rows up
    front, then runs that many steps.  Arithmetic is flac_lpc_scan's, term
    for term; integer wraparound makes the summation order irrelevant, and
    the sums run oldest tap first so only the last product waits on the
    sample just produced."""
    order = params_ref[0, :]
    shift = params_ref[1, :]
    exact = params_ref[2, :] != 0
    chi = [chi_ref[j, :] for j in range(MAX_ORDER)]
    clo = [clo_ref[j, :] for j in range(MAX_ORDER)]
    sm8 = jnp.maximum(shift - 8, 0)
    s8m = jnp.maximum(8 - shift, 0)
    ge8 = shift >= 8
    U = LPC_STEPS_PER_LOAD

    def body(i, h):  # h[j] = s[t-1-j], one [lanes] vector per tap
        t0 = i * U
        rows = [res_ref[t0 + u, :] for u in range(U)]
        for u in range(U):
            A = h[MAX_ORDER - 1] * chi[MAX_ORDER - 1]
            B = h[MAX_ORDER - 1] * clo[MAX_ORDER - 1]
            for j in range(MAX_ORDER - 2, -1, -1):
                A = A + h[j] * chi[j]
                B = B + h[j] * clo[j]
            hi = A + (B >> 8)
            lo = B & 255
            pred_exact = jnp.where(ge8, hi >> sm8,
                                   (hi << s8m) + (lo >> shift))
            pred_wrap = ((A << 8) + B) >> shift
            pred = jnp.where(exact, pred_exact, pred_wrap)
            r = rows[u]
            s = jnp.where(t0 + u < order, r, r + pred)
            out_ref[t0 + u, :] = s
            h = (s,) + h[:-1]
        return h

    n_iter = res_ref.shape[0] // U
    zero = jnp.zeros((LPC_BLOCK_LANES,), jnp.int32)
    jax.lax.fori_loop(0, n_iter, body, (zero,) * MAX_ORDER)


@functools.partial(jax.jit, static_argnames=("interpret",))
def _lpc_kernel_call(residual, coeffs, order, shift, exact, interpret):
    L, B = residual.shape
    BL, U = LPC_BLOCK_LANES, LPC_STEPS_PER_LOAD
    Lp = -(-L // BL) * BL
    Bp = -(-B // U) * U
    res_t = jnp.zeros((Bp, Lp), jnp.int32).at[:B, :L].set(residual.T)
    chi_t = jnp.zeros((MAX_ORDER, Lp), jnp.int32).at[:, :L].set(
        (coeffs >> 8).T)
    clo_t = jnp.zeros((MAX_ORDER, Lp), jnp.int32).at[:, :L].set(
        (coeffs & 255).T)
    params = jnp.zeros((4, Lp), jnp.int32)
    params = params.at[0, :L].set(order)
    params = params.at[1, :L].set(shift)
    params = params.at[2, :L].set(exact.astype(jnp.int32))
    out = pl.pallas_call(
        _lpc_kernel,
        out_shape=jax.ShapeDtypeStruct((Bp, Lp), jnp.int32),
        grid=(Lp // BL,),
        in_specs=[
            pl.BlockSpec((4, BL), lambda i: (0, i)),
            pl.BlockSpec((MAX_ORDER, BL), lambda i: (0, i)),
            pl.BlockSpec((MAX_ORDER, BL), lambda i: (0, i)),
            pl.BlockSpec((Bp, BL), lambda i: (0, i)),
        ],
        out_specs=pl.BlockSpec((Bp, BL), lambda i: (0, i)),
        backend="triton",
        compiler_params=plgpu_triton.CompilerParams(
            num_warps=BL // 32, num_stages=1),
        interpret=interpret,
        name="flac_lpc",
    )(params, chi_t, clo_t, res_t)
    return out[:B, :L].T


def flac_lpc_pallas(residual, coeffs, order, shift, exact=None,
                    interpret=False):
    """GPU kernel (Pallas, Triton route) with flac_lpc_scan's [L, B]
    contract and bit-identical results.

    Lanes are independent, so a batch sharded over a mesh's leading axis
    runs the kernel per shard under shard_map instead of gathering every
    lane onto each device."""
    residual = jnp.asarray(residual)
    if exact is None:
        exact = jnp.zeros((residual.shape[0],), bool)
    fn = functools.partial(_lpc_kernel_call, interpret=interpret)
    sh = getattr(residual, "sharding", None)
    if (isinstance(sh, NamedSharding) and sh.mesh.size > 1
            and len(sh.spec) and sh.spec[0] is not None):
        lane = PartitionSpec(sh.spec[0])
        fn = jax.shard_map(fn, mesh=sh.mesh, in_specs=lane, out_specs=lane,
                           check_vma=False)
    return fn(residual, coeffs, order, shift, exact)


def default_platform() -> str:
    """Platform of the device computations actually land on (honours
    ``jax.default_device``, which pins a computation to one backend)."""
    d = jax.config.jax_default_device
    return d.platform if d is not None else jax.default_backend()


def flac_lpc(residual, coeffs, order, shift, exact=None):
    """Dispatch by platform: the GPU kernel on ``gpu``, the scan on
    ``cpu`` (and any other backend)."""
    if default_platform() == "gpu":
        return flac_lpc_pallas(residual, coeffs, order, shift, exact)
    return flac_lpc_scan(residual, coeffs, order, shift, exact)


def flac_lpc_np(residual, coeffs, order, shift):
    """Exact int64 host path (mirrors drflac__calculate_prediction_64,
    drflac.d:1101) for subframes with bits-per-sample > 16; also the test
    oracle for the device kernel."""
    residual = np.asarray(residual, dtype=np.int64)
    coeffs = np.asarray(coeffs, dtype=np.int64)
    L, B = residual.shape
    out = np.empty((L, B), dtype=np.int64)
    hist = np.zeros((L, MAX_ORDER), dtype=np.int64)
    order = np.asarray(order)
    shift = np.asarray(shift)
    for t in range(B):
        pred = (hist * coeffs).sum(axis=1) >> shift
        s = np.where(t < order, residual[:, t], residual[:, t] + pred)
        hist[:, 1:] = hist[:, :-1]
        hist[:, 0] = s
        out[:, t] = s
    return out


def _post_stereo_core(samples, chan_assignment, wasted, out_shift):
    """Inter-channel decorrelation + output shift to s32, exactly as
    drflac_read_s32 (drflac.d:2884-2944): decorrelate the *unshifted*
    subframe samples, then shift each channel by
    (32 - streaminfo_bps) + wasted_bits[channel].

    samples: [C, B] int32 (C == channel count of the frame)
    chan_assignment: scalar int32 (8=left/side, 9=right/side, 10=mid/side,
                     else independent)
    wasted: [C] int32; out_shift: scalar int32 (= 32 - streaminfo bps)
    Returns interleaved-ready [C, B] int32 (caller transposes).
    """
    c0 = samples[0]
    c1 = samples[1] if samples.shape[0] > 1 else samples[0]

    def left_side(_):
        return jnp.stack([c0, c0 - c1])

    def right_side(_):
        return jnp.stack([c1 + c0, c1])

    def mid_side(_):
        side = c1
        mid = ((c0.astype(jnp.uint32) << 1) | (side.astype(jnp.uint32) & 1)).astype(jnp.int32)
        return jnp.stack([(mid + side) >> 1, (mid - side) >> 1])

    if samples.shape[0] == 2:
        decor = jax.lax.switch(
            jnp.clip(chan_assignment - 8, -1, 2) + 1,
            [lambda _: samples, left_side, right_side, mid_side],
            None,
        )
    else:
        decor = samples
    return decor << (out_shift + wasted)[:, None]


flac_post_stereo = jax.jit(_post_stereo_core)

#: Batched variant: leading stream axis on every argument
#: (samples [S, C, B], chan_assignment [S], wasted [S, C], out_shift [S]).
flac_post_stereo_batch = jax.jit(jax.vmap(_post_stereo_core))


@jax.jit
def flac_post_stereo_batch_s16(samples, chan_assignment, wasted, out_shift):
    """Batch stereo decorrelation emitting int16: for lanes whose source is
    <= 16 bits the left-justified int32 output is exactly sample << 16, so
    the device can ship half the bytes over the host link losslessly
    (s16 == s32 >> 16)."""
    out32 = jax.vmap(_post_stereo_core)(samples, chan_assignment, wasted,
                                        out_shift)
    return (out32 >> 16).astype(jnp.int16)


@functools.partial(jax.jit, static_argnames=("w", "n"))
def flac_unpack_residuals(packed, warm, order, w: int, n: int):
    """Unpack fixed-width residual rows (af_host.cc:af_flac_pack) and merge
    the int32 warm-up side channel.

    The upload diet: Rice residuals almost all fit ~8–14 bits; shipping
    them at the window's uniform width w instead of int32 cuts host→device
    bytes ~2.5–4×.  Width-uniform packing makes the unpack pure STATIC
    shift arithmetic — 32 samples span exactly w words, so a reshape to
    [L, n/32 groups, w words] + 32 statically-unrolled extracts recovers
    every sample with no gathers (gathers were the slower choice on the
    previous accelerator; not re-measured on the GPU).

    packed: [L, >= ceil(n·w/32)] uint32;  warm: [L, 32] int32 (samples at
    positions < min(order, 32); constant/verbatim lanes use order = n and
    keep positions ≥ 32 in the packed stream).
    Returns residual [L, n] int32.
    """
    L = packed.shape[0]
    assert n % 32 == 0
    G = n // 32
    grp = packed[:, : G * w].reshape(L, G, w).astype(jnp.uint32)
    grp = jnp.concatenate(
        [grp, jnp.zeros((L, G, 1), jnp.uint32)], axis=2
    )  # straddle pad
    outs = []
    for j in range(32):
        o = j * w
        wi, sh = o >> 5, o & 31
        a = grp[:, :, wi]
        b = grp[:, :, wi + 1]
        hi = (a << jnp.uint32(sh)) | ((b >> jnp.uint32(31 - sh)) >> 1)
        if w < 32:
            v = (hi >> jnp.uint32(32 - w)).astype(jnp.int32)
            v = (v << (32 - w)) >> (32 - w)  # sign-extend
        else:
            v = hi.astype(jnp.int32)
        outs.append(v)
    res = jnp.stack(outs, axis=2).reshape(L, n)
    pos = jnp.arange(n, dtype=jnp.int32)[None, :]
    warm_full = jnp.pad(warm, ((0, 0), (0, n - 32)))
    zu = jnp.minimum(order, 32)
    return jnp.where(pos < zu[:, None], warm_full, res)


@functools.partial(jax.jit, static_argnames=("Lb",))
def flac_merge_overflow(res_small, raw, idx, Lb: int):
    """Merge the raw overflow plane into the width-packed residual rows.

    A few rows per window need a wider residual width than the window's
    packed width (high-order partitions, verbatim blocks); padding EVERY
    row to that width would multiply the upload.  Those rows
    ship raw int32 in raw [Lb, n] (row 0 all-zero) and are selected back
    by idx [L] (0 = not overflowing) here.  The select is an exact
    one-hot matmul over two uint16 planes (values < 2^16 are exact in
    f32 and each one-hot row has a single 1, so no rounding anywhere);
    chosen over a per-row gather on the previous accelerator, not
    re-measured on the GPU.
    """
    L = res_small.shape[0]
    ru = jax.lax.bitcast_convert_type(raw, jnp.uint32)
    hi = (ru >> jnp.uint32(16)).astype(jnp.float32)
    lo = (ru & jnp.uint32(0xFFFF)).astype(jnp.float32)
    oh = (idx[:, None] == jnp.arange(Lb, dtype=jnp.int32)[None, :]
          ).astype(jnp.float32)
    mhi = jnp.dot(oh, hi, precision=jax.lax.Precision.HIGHEST)
    mlo = jnp.dot(oh, lo, precision=jax.lax.Precision.HIGHEST)
    merged = jax.lax.bitcast_convert_type(
        (mhi.astype(jnp.uint32) << jnp.uint32(16))
        | mlo.astype(jnp.uint32), jnp.int32)
    return jnp.where((idx > 0)[:, None], merged, res_small)
