"""D4C band-aperiodicity estimation, batched over frames and bands.

Reference: /root/reference/src/d4c.cpp.  The reference's two OpenMP frame
loops (LoveTrain VUV :188-206 and the group-delay main loop :143-169) become
batched tensor programs: one [F, fft_lt] FFT for LoveTrain, four [F, fft_d4c]
FFTs for the static centroid + smoothed power spectrum, and one
[F, n_bands, fft_d4c] FFT for the coarse aperiodicity — the per-band
``std::sort`` (:494) becomes a batched jnp.sort.

Frames that are unvoiced or fail the LoveTrain threshold keep the
1 - 1e-12 default aperiodicity (reference :126-132,147).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from worldtpu import constants as C
from worldtpu.ops import dft, filters, trig
from worldtpu.ops.interp import interp1


def _matlab_round(x):
    return jnp.where(x > 0, jnp.floor(x + 0.5), jnp.ceil(x - 0.5)).astype(jnp.int32)


def d4c_fft_size(fs: int) -> int:
    """Reference prepareForD4c (/root/reference/src/d4c.cpp:63-64)."""
    return int(2 ** (1 + int(
        math.log(4.0 * fs / C.FLOOR_F0_D4C + 1) / math.log(2.0))))


def love_train_fft_size(fs: int) -> int:
    """Reference prepareForD4c (:103)."""
    return int(2 ** (1 + int(math.log(3.0 * fs / 40.0 + 1) / math.log(2.0))))


def number_of_aperiodicities(fs: int) -> int:
    """Reference (:65-67) == codec GetNumberOfAperiodicities."""
    return int(min(C.UPPER_LIMIT, fs / 2.0 - C.FREQUENCY_INTERVAL)
               / C.FREQUENCY_INTERVAL)


def d4c_max_half_lt(fs: int) -> int:
    """Worst-case LoveTrain half window: round(1.5*fs/lowest_f0), lowest_f0
    = 40 (reference :102,216,250)."""
    return int(1.5 * fs / 40.0 + 0.5)


def d4c_max_half_c(fs: int) -> int:
    """Worst-case main-loop half window: round(2*fs/kFloorF0D4C)
    (reference :157,250 with ratio 4.0)."""
    return int(2.0 * fs / C.FLOOR_F0_D4C + 0.5)


@functools.partial(jax.jit, static_argnames=("fs",))
def love_train_ap0(x, f0, temporal_positions, *, fs, lt_dither=None):
    """Standalone LoveTrain VUV ratio (reference :181-240): the cumulative
    power at 4000 Hz over that at 7900 Hz of a Blackman 3-period frame.
    Bitwise-identical to the gate computed inside ``d4c_frames`` — used to
    derive the main-loop dither stream gating on the host."""
    dt = x.dtype
    f0 = f0.astype(dt)
    pos = temporal_positions.astype(dt)
    fft_lt = love_train_fft_size(fs)
    max_half_lt = d4c_max_half_lt(fs)
    f0lt = jnp.maximum(f0, 40.0)
    wave_lt = _windowed_waveform(x, f0lt, pos, fs, C.BLACKMAN, 3.0,
                                 max_half_lt, dt, dither=lt_dither)
    spec_lt = dft.rfft(wave_lt, n=fft_lt)
    ps_lt = (spec_lt.real ** 2 + spec_lt.imag ** 2).astype(dt)
    b0 = int(math.ceil(100.0 * fft_lt / fs))
    b1 = int(math.ceil(4000.0 * fft_lt / fs))
    b2 = int(math.ceil(7900.0 * fft_lt / fs))
    bins = jnp.arange(ps_lt.shape[-1])
    ps_lt = jnp.where(bins[None, :] <= b0, 0.0, ps_lt)
    cum = jnp.cumsum(ps_lt, axis=-1)
    return jnp.where(f0 == 0.0, 0.0, cum[:, b1] / cum[:, b2])


def _windowed_waveform(x, f0, position, fs, window_type, ratio, max_half,
                       dtype, frame_seg=None, seg_origin=None, seg_pad=0,
                       dither=None, aligned=False):
    """D4C::getWindowedWaveform (:246-303), left-aligned and padded to
    2*max_half+1 columns.  Returns [F, W] masked windowed waveform.

    When frame_seg [F, 2*(max_half+seg_pad)+1] (a shared per-frame waveform
    neighborhood gathered once around seg_origin) is given, the window is
    read from it by a shifted in-segment index instead of a fresh [F, W]
    gather from x — the gathers dominate D4C's device time otherwise.

    ``dither`` is an optional [F, W] left-aligned parity dither added to the
    windowed waveform before the weighting step, reproducing the reference's
    ``randn() * kMySafeGuardMinimum`` injection (:291)."""
    half = _matlab_round(ratio * fs / f0 / 2.0)            # [F]
    W = 2 * max_half + 1
    # `aligned` asserts round(position*fs+0.001) == seg_origin (the window
    # sits exactly at the segment center) — true for the LoveTrain and
    # smoothed-power windows, false for the +-0.25/f0-shifted centroids
    centered = aligned and dither is None and frame_seg is not None
    if centered:
        # fast path: window positions m = base_index in [-half, half] laid
        # out CENTERED at column max_half.  The windows below only ever use
        # masked/symmetric quantities, so centering is exact — and the
        # segment read becomes a STATIC middle slice of frame_seg instead
        # of a per-frame-shifted take_along_axis (a [F, W] gather that
        # dominated D4C's device time).  The left-aligned layout remains
        # for the dither parity path, whose draw order is left-aligned.
        j = jnp.arange(W, dtype=jnp.int32)
        base = (j - max_half)[None, :]                      # [1, W]
        in_win = jnp.abs(j - max_half)[None, :] <= half[:, None]
        origin = _matlab_round(position * fs + 0.001)
        # frame_seg was gathered at clip(seg_origin + m) and
        # origin == seg_origin by construction (same rounding formula)
        d0 = seg_pad  # frame_seg center is at column max_half + seg_pad
        seg = frame_seg[:, d0:d0 + W]
    else:
        j = jnp.arange(W, dtype=jnp.int32)
        base = j - half[:, None]                            # base_index
        in_win = j[None, :] <= 2 * half[:, None]
        origin = _matlab_round(position * fs + 0.001)
        if frame_seg is None:
            safe = jnp.clip(origin[:, None] + base, 0, x.shape[0] - 1)
            seg = x[safe]
        else:
            # x index = origin + base; segment covers
            # seg_origin - (max_half+seg_pad) .. + (max_half+seg_pad), and
            # the segment was gathered with the same clip
            off = origin - seg_origin + max_half + seg_pad
            idx = jnp.clip(off[:, None] + base, 0,
                           frame_seg.shape[1] - 1)
            seg = jnp.take_along_axis(frame_seg, idx, axis=1)

    if dtype != jnp.float64:
        # seed-and-rotate window evaluation (ops/trig.py): ~15x fewer
        # transcendentals than the literal [F, W] cos grid, f32-round-off
        # exact; the f64 parity path keeps the literal forms bitwise
        alpha = (C.PI * 2.0 / ratio / fs) * f0
        if centered:
            beta = -alpha * max_half
        else:
            beta = -alpha * half.astype(dtype)
        if window_type == C.HANNING:
            win = 0.5 * trig.cos_affine(alpha, beta, W) + 0.5
        else:
            c1, c2 = trig.cos_affine(alpha, beta, W, second=True)
            win = 0.42 + 0.5 * c1 + 0.08 * c2
    else:
        pos = (2.0 / ratio / fs) * base.astype(dtype)
        pf = C.PI * f0[:, None] * pos
        if window_type == C.HANNING:
            win = 0.5 * jnp.cos(pf) + 0.5
        else:  # Blackman
            win = 0.42 + 0.5 * jnp.cos(pf) + 0.08 * jnp.cos(2.0 * pf)
    win = jnp.where(in_win, win, 0.0)

    raw = seg * win
    if dither is not None:
        raw = raw + dither.astype(dtype)
    wave = jnp.where(in_win, raw, 0.0)
    weight = (jnp.sum(wave, -1, keepdims=True)
              / jnp.sum(win, -1, keepdims=True))
    return jnp.where(in_win, wave - win * weight, 0.0)


@functools.partial(jax.jit, static_argnames=("fs", "fft_size_out"))
def d4c_frames(x, f0, temporal_positions, *, fs, fft_size_out, threshold=0.85,
               f0_ceil_bound=C.CEIL_F0, lt_dither=None, c1_dither=None,
               c2_dither=None, h_dither=None):
    """Band aperiodicity for all frames at once.

    Args:
        x: [T] waveform.
        f0: [F] contour (0 = unvoiced).
        temporal_positions: [F] frame times (s).
        fs: static sample rate.
        fft_size_out: static output bin geometry (the CheapTrick fft size).
        threshold: LoveTrain VUV threshold (reference option, default 0.85).
        f0_ceil_bound: static bound on the largest f0 value, used to size the
            linear-smoothing pad.
        lt_dither: optional [F, 2*d4c_max_half_lt(fs)+1] LoveTrain window
            parity dither (see analysis.dither).
        c1_dither, c2_dither, h_dither: optional [F, 2*d4c_max_half_c(fs)+1]
            main-loop window parity dithers (centroid -0.25/f0, centroid
            +0.25/f0, Hanning), reference :291 call sites :417-420,:488.

    Returns:
        [F, fft_size_out//2 + 1] aperiodicity in (0, 1].
    """
    dt = x.dtype
    f0 = f0.astype(dt)
    pos = temporal_positions.astype(dt)
    fft_d4c = d4c_fft_size(fs)
    fft_lt = love_train_fft_size(fs)
    n_ap = number_of_aperiodicities(fs)
    Kd = fft_d4c // 2 + 1
    Ko = fft_size_out // 2 + 1

    # shared per-frame waveform neighborhood: every window below reads from
    # this single gather instead of four separate [F, W] gathers
    max_half_lt = d4c_max_half_lt(fs)
    max_half_c = d4c_max_half_c(fs)
    seg_half = max(max_half_lt, max_half_c)
    seg_pad = int(0.25 * fs / C.FLOOR_F0_D4C) + 2
    seg_origin = _matlab_round(pos * fs + 0.001)
    # contiguous per-frame rows via edge-padded dynamic_slice — bitwise
    # equal to the clipped [F, W] gather (pos lies inside the signal, so
    # only the window tails clip) at ~30x fewer gather descriptors (the
    # same trick as ops/refine_kernel.py's segment reads; a full random
    # gather here was the dominant D4C cost)
    P_seg = seg_half + seg_pad
    if dt == jnp.float64:
        seg_idx = jnp.clip(
            seg_origin[:, None]
            + (jnp.arange(2 * P_seg + 1) - P_seg), 0, x.shape[0] - 1)
        frame_seg = x[seg_idx]
    else:
        xpad_seg = jnp.pad(x, (P_seg, P_seg), mode="edge")
        frame_seg = jax.vmap(
            lambda s: jax.lax.dynamic_slice(
                xpad_seg, (s,), (2 * P_seg + 1,)))(
                    jnp.clip(seg_origin, 0, x.shape[0] - 1))

    def seg_for(max_half):
        # re-center the shared segment on each window's max_half
        d = seg_half - max_half
        return frame_seg[:, d:frame_seg.shape[1] - d], seg_pad

    # ---- LoveTrain (reference :181-240) ----
    f0lt = jnp.maximum(f0, 40.0)
    fseg_lt, pad_lt = seg_for(max_half_lt)
    wave_lt = _windowed_waveform(x, f0lt, pos, fs, C.BLACKMAN, 3.0,
                                 max_half_lt, dt, frame_seg=fseg_lt,
                                 seg_origin=seg_origin, seg_pad=pad_lt,
                                 dither=lt_dither, aligned=True)
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
    f0d = jnp.maximum(C.FLOOR_F0_D4C, f0)

    # ---- static centroid (reference :339-405) ----
    ramp_w = 2 * max_half_c + 1
    fseg_c, pad_c = seg_for(max_half_c)

    def centroid(at, dither):
        w = _windowed_waveform(x, f0d, at, fs, C.BLACKMAN, 4.0, max_half_c,
                               dt, frame_seg=fseg_c, seg_origin=seg_origin,
                               seg_pad=pad_c, dither=dither)
        power = jnp.sqrt(jnp.sum(w * w, -1, keepdims=True))
        w = w / power
        s1 = dft.rfft(w, n=fft_d4c)
        ramp = jnp.arange(1, ramp_w + 1, dtype=dt)
        s2 = dft.rfft(w * ramp[None, :], n=fft_d4c)
        return (s1.real * s2.real + s1.imag * s2.imag).astype(dt)

    def centroid_shifted(at, half_c):
        """Gather-free centroid: the +-0.25/f0 window shift is absorbed into
        the window evaluation over the FULL static segment (no per-frame
        take_along_axis), and the position-weighted spectrum is recovered
        by linearity: the reference's ramp at sample k is
        k - origin_c + half + 1, which in segment coordinates i is
        i + (half - d - max_half - pad + 1) with d = origin_c - seg_origin;
        FFT(w*(i+Delta)) = FFT(w*i) + Delta*FFT(w), and the layout's
        constant shift phase cancels in the conj(S1)*S2 product."""
        d_f = _matlab_round(at * fs + 0.001) - seg_origin     # [F] ints
        Wc = fseg_c.shape[1]
        i_c = jnp.arange(Wc, dtype=jnp.int32)[None, :]
        m = i_c - (max_half_c + pad_c) - d_f[:, None]         # base_index
        in_w = jnp.abs(m) <= half_c[:, None]
        # seed-and-rotate Blackman (ops/trig.py, f32-exact; this path is
        # production-only — the dither/parity path uses centroid())
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
            # the segment layout can push a low-f0 window past fft_d4c
            # samples; rfft(n=fft_d4c) would TRUNCATE it.  The DFT phase
            # e^{-2pi i k m / n} is n-periodic in m, so folding the tail
            # back circularly computes the exact full-window sum
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

    if c1_dither is None and c2_dither is None:
        half_c = _matlab_round(4.0 * fs / f0d / 2.0)
        static_centroid = (centroid_shifted(pos - 0.25 / f0d, half_c)
                           + centroid_shifted(pos + 0.25 / f0d, half_c))
    else:
        static_centroid = (centroid(pos - 0.25 / f0d, c1_dither)
                           + centroid(pos + 0.25 / f0d, c2_dither))
    def dc_corr(p):
        if dt == jnp.float64:   # parity path: literal per-frame rounding
            return jax.vmap(
                lambda pi, f: filters.dc_correction(pi, f, fs, fft_d4c))(
                    p, f0d)
        return filters.dc_correction_frames(
            p, f0d, fs, fft_d4c, 1.2 * f0_ceil_bound)

    static_centroid = dc_corr(static_centroid)

    # ---- smoothed power spectrum (reference :411-434) ----
    wave_h = _windowed_waveform(x, f0d, pos, fs, C.HANNING, 4.0,
                                max_half_c, dt, frame_seg=fseg_c,
                                seg_origin=seg_origin, seg_pad=pad_c,
                                dither=h_dither, aligned=True)
    spec_h = dft.rfft(wave_h, n=fft_d4c)
    sps = (spec_h.real ** 2 + spec_h.imag ** 2).astype(dt)
    sps = dc_corr(sps)
    max_b = int(1.2 * f0_ceil_bound * fft_d4c / fs) + 2
    sps = filters.linear_smoothing_frames(sps, f0d, fs, fft_d4c, max_b)
    if dt != jnp.float64:
        # f32 robustness: smoothing can underflow a power bin to exactly 0
        # (the f64 reference never does in practice); an unfloored divide
        # below turns that into inf group delay -> NaN aperiodicity
        sps = jnp.maximum(sps, jnp.finfo(dt).tiny)

    # ---- static group delay (reference :440-460) ----
    sgd = static_centroid / sps
    if dt != jnp.float64:
        # physical group delay is bounded by the analysis span (<= fft_d4c
        # samples); near-zero-power bins can still blow up to ~1e35, which
        # overflows f32 when the coarse-band FFT squares it below.  1e12 is
        # 8+ orders above any valid value and 14 below f32 overflow.
        sgd = jnp.clip(sgd, -1e12, 1e12)
    # this call smooths at width f0d/2, so its boundary bound (and with it
    # the smoothing conv's tap count) is half the full-width calls'
    max_b_half = int(0.6 * f0_ceil_bound * fft_d4c / fs) + 2
    sgd = filters.linear_smoothing_frames(sgd, f0d / 2.0, fs, fft_d4c,
                                          max_b_half)
    sgd_smooth = filters.linear_smoothing_frames(sgd, f0d, fs, fft_d4c, max_b)
    sgd = sgd - sgd_smooth

    # ---- coarse aperiodicity per 3 kHz band (reference :466-503) ----
    window_length = int(C.FREQUENCY_INTERVAL * fft_d4c / fs) * 2 + 1
    half_w = window_length // 2
    nuttall = filters.nuttall_window(window_length, dt)
    boundary = int(fft_d4c * 8.0 / window_length + 0.5)  # matlab_round, >0
    # static band centers -> pure static slices instead of a [B, Wl] gather
    centers = [int(C.FREQUENCY_INTERVAL * (b + 1) * fft_d4c / fs)
               for b in range(n_ap)]
    seg = jnp.stack(
        [sgd[:, c - half_w:c - half_w + window_length] for c in centers],
        axis=1) * nuttall[None, None, :]                      # [F, B, Wl]
    # true-width matmul-DFT: the window spans only ~12-38% of fft_d4c, so
    # the [Wl, 2K] basis product beats the n-point XLA FFT (r5: the
    # coarse-band FFT dominates D4C at 48 kHz where Wl/n = 1025/8192;
    # mode="mm" is f32-only — the f64 parity path stays on jnp.fft)
    spec_b = dft.rfft(seg, n=fft_d4c, mode="mm")     # [F,B,Kd]
    ps_b = (spec_b.real ** 2 + spec_b.imag ** 2).astype(dt)
    if dt == jnp.float64:
        # parity path: the reference's literal sort + ascending cumsum
        # (d4c.cpp:494-499)
        ps_sorted = jnp.sort(ps_b, axis=-1)
        cum_b = jnp.cumsum(ps_sorted, axis=-1)
        lo, hi = cum_b[..., Kd - boundary - 2], cum_b[..., Kd - 1]
    else:
        # f32 path: cum[Kd-b-2] of the ascending sort is total minus the
        # top (boundary+1) values.  On CPU and GPU approx_max_k lowers to
        # an exact top_k; the recall target is pinned anyway: with
        # aggregate_to_topk (default) the candidate pool is re-ranked
        # exactly, and at k=31 of 1025 bins 0.95 recovers the exact
        # top-set sum on adversarial spectra (60-decade dynamic range,
        # k-way near-ties) — asserted by
        # tests/test_d4c.py::test_approx_max_k_exact_top_set
        hi = jnp.sum(ps_b, axis=-1)
        top, _ = jax.lax.approx_max_k(
            ps_b.reshape(-1, ps_b.shape[-1]), boundary + 1,
            recall_target=0.95)
        lo = hi - jnp.sum(top, axis=-1).reshape(hi.shape)
    ca = 10.0 * jnp.log10(lo / hi)
    ca = jnp.minimum(0.0, ca + (f0d[:, None] - 100.0) / 50.0)  # [F,B]

    # ---- coarse -> full-resolution bins (reference :160-168) ----
    coarse_axis = jnp.concatenate([
        C.FREQUENCY_INTERVAL * jnp.arange(n_ap + 1, dtype=dt),
        jnp.asarray([fs / 2.0], dt)])
    lo = jnp.full((ca.shape[0], 1), -60.0, dt)
    hi = jnp.full((ca.shape[0], 1), -C.MY_SAFE_GUARD_MINIMUM, dt)
    coarse_vals = jnp.concatenate([lo, ca, hi], axis=-1)      # [F,B+2]
    freq = jnp.arange(Ko, dtype=dt) * fs / fft_size_out
    ap_db = jax.vmap(lambda v: interp1(coarse_axis, v, freq))(coarse_vals)
    ap_full = 10.0 ** (ap_db / 20.0)

    default = 1.0 - C.MY_SAFE_GUARD_MINIMUM
    return jnp.where(active[:, None], ap_full, default)
