"""WORLD synthesis: pulse + noise excitation of minimum-phase filters,
batched over pulses with a scatter-add overlap-add.

Reference: /root/reference/src/synthesis.cpp.  The reference's OpenMP design —
generate every pulse's impulse response into a [n_pulses, fft_size] slab, then
overlap-add (:100-139) — *is* the batched formulation; here the slab is a
tensor, the per-pulse FFT banks become two batched FFTs, and the serial OLA
becomes one scatter-add.

Data-dependent pulse count is padded to a static ``max_pulses`` bound with
masked tail pulses (the reference bounds it the same way at :87-88).

Pulse timing uses Q32 fixed-point phase accumulation (int32 cumsum with
natural modular wrap) in the float32 production path — exact cycle counting
with no precision loss over arbitrarily long signals — and float64
accumulation + fmod (bit-matching the C++) in the x64 parity path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from worldtpu import constants as C
from worldtpu.ops import dft
from worldtpu.ops.fftutil import minimum_phase
from worldtpu.ops.interp import interp1
from worldtpu.ops import trig


def dc_remover(fft_size, dtype=jnp.float64):
    """Reference getDCRemover (/root/reference/src/synthesis.cpp:290-303):
    half-length raised-cosine normalized so the full (mirrored) kernel sums
    to 1. Returns the first half; the second half is its mirror."""
    half = fft_size // 2
    i = jnp.arange(half, dtype=dtype)
    v = 0.5 - 0.5 * jnp.cos(2.0 * C.PI / (1.0 + fft_size) * (i + 1.0))
    return v / (jnp.sum(v) * 2.0)


def _time_base(f0, fs, frame_period_s, out_length, lowest_f0, max_pulses):
    """interpolate f0/vuv to the sample grid and extract pulse locations.

    Reference getTimeBase/getTemporalParameters/getPulseLocations
    (/root/reference/src/synthesis.cpp:180-288).

    Returns (pulse_index [P], pulse_time_shift [P], n_pulses,
             vuv_at_pulse [P], valid [P], overflowed []).

    ``n_pulses`` is clamped to ``max_pulses``; ``overflowed`` is a scalar
    bool marking that the true pulse count exceeded the static bound (the
    tail pulses are dropped — the reference sizes its pulse buffer from the
    same worst case and would overrun instead,
    /root/reference/src/synthesis.cpp:87-88).
    """
    dt = f0.dtype
    F = f0.shape[0]
    T = out_length

    coarse_f0 = jnp.where(f0 < lowest_f0, 0.0, f0)
    coarse_vuv = jnp.where(coarse_f0 == 0.0, 0.0, 1.0)
    # appended extrapolation knot (reference :240-242)
    coarse_f0 = jnp.concatenate(
        [coarse_f0, (coarse_f0[-1] * 2 - coarse_f0[-2])[None]])
    coarse_vuv = jnp.concatenate(
        [coarse_vuv, (coarse_vuv[-1] * 2 - coarse_vuv[-2])[None]])
    coarse_t = jnp.arange(F + 1, dtype=dt) * frame_period_s

    t = jnp.arange(T, dtype=dt) / fs
    if dt == jnp.float64:
        f0i = interp1(coarse_t, coarse_f0, t)
        vuvi = interp1(coarse_t, coarse_vuv, t)
    else:
        # production path: the knot grid IS uniform (j * frame_period), so
        # the histc binary search collapses to direct indexing.  CRITICAL
        # contract: worldtpu.longaudio._timebase_core computes the SAME
        # global formula (k from t/fp, s from t - x0) on its local frame
        # blocks, so the chunked and unchunked pulse trains are BITWISE
        # equal — a single knife-edge V/UV pulse flip between the two
        # paths permanently shifts every later counter-based noise
        # ordinal (r5: a 40% rel-RMS divergence from one silence-gap
        # boundary).  Change one side only with its twin.
        k = jnp.clip((t / frame_period_s).astype(jnp.int32) + 1, 1, F)
        x0 = k.astype(dt) * frame_period_s - frame_period_s
        s = (t - x0) / frame_period_s
        f0_lo, f0_hi = jnp.take(coarse_f0, k - 1), jnp.take(coarse_f0, k)
        v_lo, v_hi = jnp.take(coarse_vuv, k - 1), jnp.take(coarse_vuv, k)
        f0i = f0_lo + s * (f0_hi - f0_lo)
        vuvi = v_lo + s * (v_hi - v_lo)
    vuvi = jnp.where(vuvi > 0.5, 1.0, 0.0)
    f0i = jnp.where(vuvi == 0.0, C.DEFAULT_F0, f0i)

    if dt == jnp.float64:
        # parity path: double accumulation + fmod, bit-matching the C++'s
        # strictly sequential sum (tree-reassociated cumsum flips pulse
        # boundaries when a wrap lands within rounding of pi)
        def add(c, v):
            s = c + v
            return s, s
        _, total = jax.lax.scan(add, jnp.asarray(0.0, dt),
                                f0i * (2.0 * C.PI / fs))
        wrap = jnp.mod(total, 2.0 * C.PI)
        frac = wrap / (2.0 * C.PI)
        carry = jnp.abs(wrap[1:] - wrap[:-1]) > C.PI
    else:
        # Q32 fixed point: f0/fs cycles per sample in 1/2^32 units
        step = (f0i / fs * 4294967296.0 + 0.5).astype(jnp.uint32)
        cum = jnp.cumsum(step.astype(jnp.int32))
        fbits = jax.lax.bitcast_convert_type(cum, jnp.uint32)
        frac = fbits.astype(dt) / 4294967296.0
        carry = fbits[1:] < fbits[:-1]

    idx = jnp.nonzero(carry, size=max_pulses, fill_value=T - 1)[0].astype(jnp.int32)
    n_true = jnp.sum(carry).astype(jnp.int32)
    n_pulses = jnp.minimum(n_true, max_pulses)
    overflowed = n_true > max_pulses
    valid = jnp.arange(max_pulses) < n_pulses

    f_lo = jnp.take(frac, idx)
    f_hi = jnp.take(frac, jnp.minimum(idx + 1, T - 1))
    # x = -y1/(y2-y1) with y1 = wrap[i]-2pi, y2 = wrap[i+1]  (in cycles)
    shift = (1.0 - f_lo) / (f_hi + 1.0 - f_lo) / fs
    vuv_at = jnp.take(vuvi, idx)
    return idx, shift, n_pulses, vuv_at, valid, overflowed


def pulse_responses(pt, shift, ns, vuv_at, valid, spectrogram,
                    aperiodicity, noise, *, fs, fft_size, frame_offset=0):
    """Per-pulse impulse responses [P, fft_size] (reference :308-344).

    The pulse-description arrays come from :func:`_time_base` (or the
    chunked variant in :mod:`worldtpu.longaudio`):

        pt: [P] fractional frame position of each pulse (sample/fs/fp).
        shift: [P] sub-sample time shift (s).
        ns: [P] noise size (samples to next pulse; reference :106).
        vuv_at: [P] voicedness at the pulse sample.
        valid: [P] mask of real pulses.
        spectrogram, aperiodicity: [F, K].
        noise: [P, fft_size] standard-normal rows.
        frame_offset: integer frame index of spectrogram's first row.
            Chunked callers pass GLOBAL pt and the block offset so
            floor/ceil/frac are computed on the SAME float values as the
            unchunked path — a locally-rebased pt can floor to the
            neighboring frame at knife edges, which decorrelates the
            response wherever adjacent envelopes differ (noise regions).
    """
    dt = spectrogram.dtype
    K = fft_size // 2 + 1
    half = fft_size // 2
    F = spectrogram.shape[0]

    # ---- per-pulse envelope / aperiodic ratio (reference :346-393) ----
    fl = jnp.clip(jnp.floor(pt).astype(jnp.int32) - frame_offset, 0, F - 1)
    ce = jnp.clip(jnp.ceil(pt).astype(jnp.int32) - frame_offset, 0, F - 1)
    w = (pt - jnp.floor(pt))[:, None].astype(dt)
    sp = jnp.abs(spectrogram)
    spec = jnp.where(fl[:, None] == ce[:, None], sp[fl],
                     (1.0 - w) * sp[fl] + w * sp[ce])
    apc = jnp.clip(aperiodicity, 0.001, 0.999999999999)
    ap = jnp.where(fl[:, None] == ce[:, None], apc[fl],
                   (1.0 - w) * apc[fl] + w * apc[ce]) ** 2

    # ---- periodic + aperiodic responses (reference :403-474, :479-530),
    #      minimum-phase and inverse FFTs batched across both kinds ----
    per_on = (vuv_at > 0.5) & (ap[:, 0] <= 0.999)
    log_per = jnp.log(spec * (1.0 - ap) + C.MY_SAFE_GUARD_MINIMUM) / 2.0
    log_ap = jnp.where((vuv_at != 0.0)[:, None],
                       jnp.log(spec * ap) / 2.0,
                       jnp.log(spec) / 2.0)
    P = log_per.shape[0]
    mp_both = minimum_phase(jnp.concatenate([log_per, log_ap], axis=0))
    mp_per, mp_ap = mp_both[:P], mp_both[P:]

    k = jnp.arange(K, dtype=dt)
    coeff = (2.0 * C.PI * fs / fft_size) * shift
    if dt != jnp.float64:
        # seed-and-rotate evaluation (ops/trig.py): ~8x fewer
        # transcendentals than the [P, K] grid; f64 parity stays literal
        # clamp: the 2-term combine can overshoot |1| by ~1 ulp, which
        # would NaN the sqrt below
        re2 = jnp.clip(
            trig.cos_affine(coeff.astype(dt), jnp.zeros_like(coeff, dt), K),
            -1.0, 1.0)
    else:
        re2 = jnp.cos(coeff[:, None] * k[None, :])
    im2 = jnp.sqrt(1.0 - re2 * re2)  # |sin|: the reference's :452 quirk
    phase = (re2 - 1j * im2).astype(mp_per.dtype)

    j = jnp.arange(fft_size)
    nmask = j[None, :] < ns[:, None]
    nz = noise.astype(dt) * nmask
    nmean = jnp.sum(nz, -1, keepdims=True) / jnp.maximum(ns, 1)[:, None]
    nz = jnp.where(nmask, nz - nmean, 0.0)
    nspec = dft.rfft(nz)

    both = dft.irfft(
        jnp.concatenate([mp_per * phase, mp_ap * nspec], axis=0),
        n=fft_size) * fft_size
    both = jnp.roll(both, half, axis=-1)  # fftshift
    per, aper = both[:P], both[P:]
    dc = jnp.sum(per[:, half:], axis=-1, keepdims=True)
    dcr = dc_remover(fft_size, dt)[None, :]
    per = jnp.concatenate(
        [-dc * dcr, per[:, half:] - dc * dcr], axis=-1)
    per = jnp.where(per_on[:, None], per, 0.0)

    # ---- combine (reference :339-343) ----
    resp = (per * jnp.sqrt(ns.astype(dt))[:, None] + aper) / fft_size
    return jnp.where(valid[:, None], resp, 0.0)


def synthesis_frames_impl(f0, spectrogram, aperiodicity, noise, *, fs,
                          fft_size, frame_period_s, out_length, max_pulses,
                          return_overflow=False):
    """Synthesize a waveform from (f0, spectrogram, aperiodicity).

    Args:
        f0: [F] contour (0 = unvoiced).
        spectrogram: [F, K] spectral envelope (power), K = fft_size//2+1.
        aperiodicity: [F, K].
        noise: [max_pulses, fft_size] i.i.d. standard normal draws; rows are
            masked to each pulse's noise_size.  Pass the xorshift parity
            stream for golden tests or jax.random normals for production
            (see make_noise / parity_noise).
        fs, fft_size, out_length, max_pulses: static.
        frame_period_s: frame period in SECONDS.

    Returns:
        [out_length] waveform, or (waveform, overflowed []) when
        ``return_overflow`` — overflowed marks that the true pulse count
        exceeded ``max_pulses`` and tail pulses were dropped; host wrappers
        should regrow max_pulses and rerun (see api.Synthesis.compute).
    """
    dt = spectrogram.dtype
    f0 = f0.astype(dt)
    K = fft_size // 2 + 1
    half = fft_size // 2
    lowest_f0 = fs / fft_size + 1.0

    idx, shift, n_pulses, vuv_at, valid, overflowed = _time_base(
        f0, fs, frame_period_s, out_length, lowest_f0, max_pulses)

    # noise_size[i] = idx[min(n-1, i+1)] - idx[i]  (reference :106)
    nxt = jnp.minimum(jnp.arange(max_pulses) + 1, n_pulses - 1)
    ns = jnp.take(idx, nxt) - idx
    ns = jnp.where(valid, ns, 0)

    pt = idx.astype(dt) / fs / frame_period_s
    resp = pulse_responses(pt, shift, ns, vuv_at, valid, spectrogram,
                           aperiodicity, noise, fs=fs, fft_size=fft_size)

    # overlap-add as one scatter-add (reference :118-139).  On a GPU it
    # lowers to atomic adds, whose order varies from run to run: f32
    # outputs then differ at rounding level between runs.
    j = jnp.arange(fft_size)
    target = (idx - half + 1)[:, None] + j[None, :]
    ok = (target >= 0) & (target < out_length) & valid[:, None]
    flat_t = jnp.where(ok, target, out_length).reshape(-1)
    flat_v = jnp.where(ok, resp, 0.0).reshape(-1)
    out = jnp.zeros(out_length + 1, dtype=dt).at[flat_t].add(flat_v)
    y = out[:out_length]
    return (y, overflowed) if return_overflow else y


#: Jitted entry point.  Note: XLA op fusion can flip 1-ulp knife edges at
#: V/UV transition samples (where the interpolated vuv lands exactly on 0.5),
#: moving a pulse by one sample vs the sequential C++; use
#: synthesis_frames_impl un-jitted for bitwise golden parity.
synthesis_frames = functools.partial(jax.jit, static_argnames=(
    "fs", "fft_size", "out_length", "max_pulses",
    "return_overflow"))(synthesis_frames_impl)


def make_noise(key, max_pulses, fft_size, dtype=jnp.float32):
    """Production noise input for synthesis_frames."""
    return jax.random.normal(key, (max_pulses, fft_size), dtype=dtype)


def indexed_noise(key, start, count, fft_size, dtype=jnp.float32):
    """Counter-based noise: row i is a deterministic function of the GLOBAL
    pulse ordinal ``start + i`` (fold_in per row), so a chunked synthesis
    (worldtpu.longaudio) draws bit-identical noise for pulse n regardless of
    which chunk synthesizes it.  ``start`` may be a traced scalar."""
    ords = start + jnp.arange(count)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(ords)
    return jax.vmap(
        lambda k: jax.random.normal(k, (fft_size,), dtype=dtype))(keys)


def estimate_max_pulses(f0, fs, fft_size, out_length, margin=1.15,
                        pitch_scale=1.0):
    """Tight host-side pulse-count bound from a known F0 contour: the pulse
    count equals the number of whole phase cycles, i.e. the integral of the
    interpolated F0 (with the kDefaultF0 unvoiced rate), so size the static
    pulse axis from that instead of the f0_ceil worst case.  Rounded up to a
    multiple of 256 to bound retracing.

    ``f0`` may be [F] or a batch [B, F]; the bound covers the worst
    utterance.  ``pitch_scale`` must match any on-device F0 scaling applied
    before synthesis (parallel.batch_wav_to_wav's pitch_scale) — the
    unvoiced DEFAULT_F0 rate is NOT scaled, matching the device code which
    scales f0 before the unvoiced substitution."""
    import numpy as np
    f0 = np.atleast_2d(np.asarray(f0, np.float64)) * pitch_scale
    lowest = fs / fft_size + 1.0
    fhat = np.where(f0 < lowest, C.DEFAULT_F0, f0)
    dur = out_length / fs
    cycles = float(np.mean(fhat, axis=-1).max()) * dur
    est = int(cycles * margin) + 32
    hard = default_max_pulses(out_length, fs)
    return min(hard, -(-est // 256) * 256)


def capacity_max_pulses(out_length, fs, f0_cap=C.DEFAULT_F0, margin=1.15):
    """Static (data-independent) pulse-count bound for production streams
    on UNSEEN audio: the synthesis time base pulses at the interpolated F0
    where voiced and at the kDefaultF0=500 Hz rate where unvoiced
    (/root/reference/src/synthesis.cpp:245-288 via the vuv substitution at
    :225-243), so the MEAN pulse rate of any utterance whose voiced F0
    stays <= f0_cap is bounded by max(f0_cap, DEFAULT_F0).  For speech
    (f0 <= ~400 Hz after typical pitch scaling) the bound is simply the
    500 Hz unvoiced rate — within ~1.5x of the data-derived estimate, with
    no F0 prepass.  Pair with synthesis_frames(return_overflow=True): a
    pathological input (sustained > f0_cap voicing) flags instead of
    silently dropping pulses, and the caller regrows toward
    default_max_pulses.  Quantized to 256 to bound retracing."""
    rate = max(float(f0_cap), C.DEFAULT_F0)
    est = int(out_length / fs * rate * margin) + 32
    hard = default_max_pulses(out_length, fs)
    return min(hard, -(-est // 256) * 256)


def default_max_pulses(out_length, fs, f0_ceil=C.CEIL_F0):
    """Static pulse-count bound: the reference's out_length/(fs/max_f0)
    (:87-88) with max_f0 bounded by the Harvest ceiling (and the unvoiced
    default 500 Hz)."""
    max_f0 = max(float(f0_ceil), C.DEFAULT_F0)
    return int(out_length / int(fs / max_f0)) + 2
