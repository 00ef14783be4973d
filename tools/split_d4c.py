#!/usr/bin/env python
"""Sub-stage split of d4c_frames (B=8 vmapped, config-5 geometry).

Cumulative prefixes: seg gather | +lovetrain | +centroids | +sps+smooth |
+sgd smooth | +coarse bands | full (interp).  Amortized walls: `reps`
dispatches share one block_until_ready.
"""

import json
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import math
import functools

from bench import synth_utterance
from worldtpu.analysis.harvest import HarvestKernel
from worldtpu.analysis.cheaptrick import CheapTrickKernel
from worldtpu.analysis import d4c as D
from worldtpu import constants as C
from worldtpu.ops import dft, filters, trig
from worldtpu.ops.interp import interp1


def d4c_prefix(x, f0, pos, *, fs, fft_size_out, upto):
    dt = x.dtype
    f0 = f0.astype(dt)
    pos = pos.astype(dt)
    fft_d4c = D.d4c_fft_size(fs)
    fft_lt = D.love_train_fft_size(fs)
    n_ap = D.number_of_aperiodicities(fs)
    Kd = fft_d4c // 2 + 1
    Ko = fft_size_out // 2 + 1
    threshold = 0.85
    f0_ceil_bound = C.CEIL_F0

    max_half_lt = D.d4c_max_half_lt(fs)
    max_half_c = D.d4c_max_half_c(fs)
    seg_half = max(max_half_lt, max_half_c)
    seg_pad = int(0.25 * fs / C.FLOOR_F0_D4C) + 2
    seg_origin = D._matlab_round(pos * fs + 0.001)
    P_seg = seg_half + seg_pad
    xpad_seg = jnp.pad(x, (P_seg, P_seg), mode="edge")
    frame_seg = jax.vmap(
        lambda s: jax.lax.dynamic_slice(
            xpad_seg, (s,), (2 * P_seg + 1,)))(
                jnp.clip(seg_origin, 0, x.shape[0] - 1))
    if upto == 1:
        return frame_seg

    def seg_for(max_half):
        d = seg_half - max_half
        return frame_seg[:, d:frame_seg.shape[1] - d], seg_pad

    f0lt = jnp.maximum(f0, 40.0)
    fseg_lt, pad_lt = seg_for(max_half_lt)
    wave_lt = D._windowed_waveform(x, f0lt, pos, fs, C.BLACKMAN, 3.0,
                                   max_half_lt, dt, frame_seg=fseg_lt,
                                   seg_origin=seg_origin, seg_pad=pad_lt,
                                   aligned=True)
    spec_lt = dft.rfft(wave_lt, n=fft_lt)
    ps_lt = (spec_lt.real ** 2 + spec_lt.imag ** 2).astype(dt)
    b0 = int(math.ceil(100.0 * fft_lt / fs))
    b1 = int(math.ceil(4000.0 * fft_lt / fs))
    b2 = int(math.ceil(7900.0 * fft_lt / fs))
    bins = jnp.arange(ps_lt.shape[-1])
    ps_lt = jnp.where(bins[None, :] <= b0, 0.0, ps_lt)
    cum = jnp.cumsum(ps_lt, axis=-1)
    ap0 = jnp.where(f0 == 0.0, 0.0, cum[:, b1] / cum[:, b2])
    active = (f0 != 0.0) & (ap0 > threshold)
    if upto == 2:
        return ap0

    f0d = jnp.maximum(C.FLOOR_F0_D4C, f0)
    fseg_c, pad_c = seg_for(max_half_c)

    def centroid_shifted(at, half_c):
        d_f = D._matlab_round(at * fs + 0.001) - seg_origin
        Wc = fseg_c.shape[1]
        i_c = jnp.arange(Wc, dtype=jnp.int32)[None, :]
        m = i_c - (max_half_c + pad_c) - d_f[:, None]
        in_w = jnp.abs(m) <= half_c[:, None]
        alpha = (C.PI * 2.0 / 4.0 / fs) * f0d
        beta = -alpha * (max_half_c + pad_c + d_f).astype(dt)
        cw1, cw2 = trig.cos_affine(alpha, beta, Wc, second=True)
        win = 0.42 + 0.5 * cw1 + 0.08 * cw2
        win = jnp.where(in_w, win, 0.0)
        wave = jnp.where(in_w, fseg_c * win, 0.0)
        weight = (jnp.sum(wave, -1, keepdims=True)
                  / jnp.sum(win, -1, keepdims=True))
        w = jnp.where(in_w, wave - win * weight, 0.0)
        power = jnp.sqrt(jnp.sum(w * w, -1, keepdims=True))
        w = w / power

        def wrap(v):
            if v.shape[-1] <= fft_d4c:
                return v
            tail = v[:, fft_d4c:]
            pad = fft_d4c - tail.shape[1]
            return v[:, :fft_d4c] + jnp.pad(tail, ((0, 0), (0, pad)))

        s1 = dft.rfft(wrap(w), n=fft_d4c)
        s2 = dft.rfft(wrap(w * i_c.astype(dt)), n=fft_d4c)
        base = s1.real * s2.real + s1.imag * s2.imag
        delta = (half_c - d_f - max_half_c - pad_c + 1).astype(dt)
        p1 = s1.real * s1.real + s1.imag * s1.imag
        return (base + delta[:, None] * p1).astype(dt)

    half_c = D._matlab_round(4.0 * fs / f0d / 2.0)
    static_centroid = (centroid_shifted(pos - 0.25 / f0d, half_c)
                       + centroid_shifted(pos + 0.25 / f0d, half_c))

    def dc_corr(p):
        return filters.dc_correction_frames(
            p, f0d, fs, fft_d4c, 1.2 * f0_ceil_bound)

    static_centroid = dc_corr(static_centroid)
    if upto == 3:
        return static_centroid

    wave_h = D._windowed_waveform(x, f0d, pos, fs, C.HANNING, 4.0,
                                  max_half_c, dt, frame_seg=fseg_c,
                                  seg_origin=seg_origin, seg_pad=pad_c,
                                  aligned=True)
    spec_h = dft.rfft(wave_h, n=fft_d4c)
    sps = (spec_h.real ** 2 + spec_h.imag ** 2).astype(dt)
    sps = dc_corr(sps)
    max_b = int(1.2 * f0_ceil_bound * fft_d4c / fs) + 2
    sps = filters.linear_smoothing_frames(sps, f0d, fs, fft_d4c, max_b)
    sps = jnp.maximum(sps, jnp.finfo(dt).tiny)
    if upto == 4:
        return sps

    sgd = static_centroid / sps
    sgd = jnp.clip(sgd, -1e12, 1e12)
    max_b_half = int(0.6 * f0_ceil_bound * fft_d4c / fs) + 2
    sgd = filters.linear_smoothing_frames(sgd, f0d / 2.0, fs, fft_d4c,
                                          max_b_half)
    sgd_smooth = filters.linear_smoothing_frames(sgd, f0d, fs, fft_d4c,
                                                 max_b)
    sgd = sgd - sgd_smooth
    if upto == 5:
        return sgd

    window_length = int(C.FREQUENCY_INTERVAL * fft_d4c / fs) * 2 + 1
    half_w = window_length // 2
    nuttall = filters.nuttall_window(window_length, dt)
    boundary = int(fft_d4c * 8.0 / window_length + 0.5)
    centers = [int(C.FREQUENCY_INTERVAL * (b + 1) * fft_d4c / fs)
               for b in range(n_ap)]
    seg = jnp.stack(
        [sgd[:, c - half_w:c - half_w + window_length] for c in centers],
        axis=1) * nuttall[None, None, :]
    spec_b = dft.rfft(seg, n=fft_d4c)
    ps_b = (spec_b.real ** 2 + spec_b.imag ** 2).astype(dt)
    hi = jnp.sum(ps_b, axis=-1)
    top, _ = jax.lax.approx_max_k(
        ps_b.reshape(-1, ps_b.shape[-1]), boundary + 1, recall_target=0.95)
    lo = hi - jnp.sum(top, axis=-1).reshape(hi.shape)
    ca = 10.0 * jnp.log10(lo / hi)
    ca = jnp.minimum(0.0, ca + (f0d[:, None] - 100.0) / 50.0)
    if upto == 6:
        return ca

    coarse_axis = jnp.concatenate([
        C.FREQUENCY_INTERVAL * jnp.arange(n_ap + 1, dtype=dt),
        jnp.asarray([fs / 2.0], dt)])
    lo2 = jnp.full((ca.shape[0], 1), -60.0, dt)
    hi2 = jnp.full((ca.shape[0], 1), -C.MY_SAFE_GUARD_MINIMUM, dt)
    coarse_vals = jnp.concatenate([lo2, ca, hi2], axis=-1)
    freq = jnp.arange(Ko, dtype=dt) * fs / fft_size_out
    ap_db = jax.vmap(lambda v: interp1(coarse_axis, v, freq))(coarse_vals)
    ap_full = 10.0 ** (ap_db / 20.0)
    default = 1.0 - C.MY_SAFE_GUARD_MINIMUM
    return jnp.where(active[:, None], ap_full, default)


def main():
    reps = int(os.environ.get("AB_REPS", "10"))
    fs = 22050
    n_utts = 8
    xs = np.stack([
        np.pad(synth_utterance(fs, 3.0, 160.0 + 15 * i, i),
               (0, 4096 * ((3 * fs + 4095) // 4096) - 3 * fs))
        for i in range(n_utts)]).astype(np.float32)
    T = xs.shape[1]
    ck = CheapTrickKernel(fs)
    hk = HarvestKernel(fs, T, f0_floor=40.0)
    x_dev = jax.device_put(jnp.asarray(xs))
    jax.block_until_ready(x_dev)
    f0 = np.stack([f for f, _ in hk.compute_batch(x_dev)]).astype(np.float32)
    f0_dev = jax.device_put(jnp.asarray(f0 * 1.2))
    F = f0.shape[1]
    tpos = jnp.arange(F, dtype=jnp.float32) * 0.005

    names = ["seg_gather", "lovetrain", "centroids", "sps_smooth",
             "sgd_smooth", "coarse_bands", "interp_full"]
    walls = {}
    for upto in range(1, 8):
        fn = jax.jit(jax.vmap(functools.partial(
            d4c_prefix, fs=fs, fft_size_out=ck.fft_size, upto=upto),
            in_axes=(0, 0, None)))
        out = fn(x_dev, f0_dev, tpos)
        jax.block_until_ready(out)
        best = None
        for _ in range(2):
            t0 = time.time()
            outs = [fn(x_dev * (1.0 + np.float32(i) * 1e-7), f0_dev,
                       tpos) for i in range(reps)]
            jax.block_until_ready(outs)
            w = (time.time() - t0) / reps
            best = w if best is None else min(best, w)
        walls[upto] = best * 1e3

    deltas = {}
    prev = 0.0
    for upto in range(1, 8):
        deltas[names[upto - 1]] = round(walls[upto] - prev, 1)
        prev = walls[upto]
    print(json.dumps({"prefix_ms": {names[u - 1]: round(walls[u], 1)
                                    for u in walls},
                      "stage_ms": deltas, "total_ms": round(walls[7], 1)}))


if __name__ == "__main__":
    sys.exit(main())
