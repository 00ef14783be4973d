"""DSP filter primitives: windows, IIR filtering (associative-scan), decimate,
DC correction and linear spectral smoothing.

Reference: /root/reference/src/world_common.cpp:56-126 (DCCorrection,
LinearSmoothing, NuttallWindow) and
/root/reference/src/world_matlabfunctions.cpp:27-125,184-210 (decimate and its
hard-coded per-ratio IIR table).

Device notes: the reference runs its IIR filters as sequential time loops;
here the decimation IIR is exact blocked linear-recurrence matmuls (impulse
response Toeplitz + block-boundary power tables), and the F0 smoothing
biquad is an associative scan of affine state maps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST

from worldtpu import constants as C

# Decimation anti-alias filter coefficients, indexed by ratio r=2..12.
# Verbatim from FilterForDecimate
# (/root/reference/src/world_matlabfunctions.cpp:27-113).
_DECIMATE_COEFFS = {
    11: ((2.450743295230728, -2.06794904601978, 0.59574774438332101),
         (0.0026822508007163792, 0.0080467524021491377)),
    12: ((2.4981398605924205, -2.1368928194784025, 0.62187513816221485),
         (0.0021097275904709001, 0.0063291827714127002)),
    10: ((2.3936475118069387, -1.9873904075111861, 0.5658879979027055),
         (0.0034818622251927556, 0.010445586675578267)),
    9: ((2.3236003491759578, -1.8921545617463598, 0.53148928133729068),
        (0.0046331164041389372, 0.013899349212416812)),
    8: ((2.2357462340187593, -1.7780899984041358, 0.49152555365968692),
        (0.0063522763407111993, 0.019056829022133598)),
    7: ((2.1225239019534703, -1.6395144861046302, 0.44469707800587366),
        (0.0090366882681608418, 0.027110064804482525)),
    6: ((1.9715352749512141, -1.4686795689225347, 0.3893908434965701),
        (0.013469181309343825, 0.040407543928031475)),
    5: ((1.7610939654280557, -1.2554914843859768, 0.3237186507788215),
        (0.021334858522387423, 0.06400457556716227)),
    4: ((1.4499664446880227, -0.98943497080950582, 0.24578252340690215),
        (0.036710750339322612, 0.11013225101796784)),
    3: ((0.95039378983237421, -0.67429146741526791, 0.15412211621346475),
        (0.071221945171178636, 0.21366583551353591)),
    2: ((0.041156734567757189, -0.42599112459189636, 0.041037215479961225),
        (0.16797464681802227, 0.50392394045406674)),
}


def nuttall_window(length, dtype=jnp.float64):
    """Nuttall window of given static length.

    Reference: NuttallWindow (/root/reference/src/world_common.cpp:118-126).
    """
    t = jnp.arange(length, dtype=dtype) / (length - 1.0)
    return (0.355768
            - 0.487396 * jnp.cos(2.0 * C.PI * t)
            + 0.144232 * jnp.cos(4.0 * C.PI * t)
            - 0.012604 * jnp.cos(6.0 * C.PI * t))


def nuttall_window_ragged(length, max_length, dtype=jnp.float64):
    """Nuttall window of dynamic ``length`` padded with zeros to max_length."""
    i = jnp.arange(max_length, dtype=dtype)
    t = i / (jnp.asarray(length, dtype) - 1.0)
    w = (0.355768
         - 0.487396 * jnp.cos(2.0 * C.PI * t)
         + 0.144232 * jnp.cos(4.0 * C.PI * t)
         - 0.012604 * jnp.cos(6.0 * C.PI * t))
    return jnp.where(i < length, w, 0.0)


def _affine_combine(a, b):
    """Compose affine maps s -> A s + c; b is applied after a.

    The 4x4/3x3 matrix products are written as broadcast-multiply +
    reductions: batched tiny dot_generals map poorly onto matrix units,
    and the elementwise form fuses."""
    a_mat, a_vec = a
    b_mat, b_vec = b
    mat = jnp.sum(b_mat[..., :, :, None] * a_mat[..., None, :, :], axis=-2)
    vec = jnp.sum(b_mat * a_vec[..., None, :], axis=-1) + b_vec
    return mat, vec


import functools as _functools


@_functools.lru_cache(maxsize=64)
def _iir_boundary_table(a_coeffs, b_coeffs, block, nb):
    """[nb*4, nb*4] strictly-block-lower-triangular operator mapping block
    inputs c to block-start states: s_k = sum_{j<k} M^(k-1-j) c_j."""
    import numpy as _np
    _, _, _, M = _iir_block_tables(a_coeffs, b_coeffs, block)
    Mp = _np.empty((nb, 4, 4))
    Mp[0] = _np.eye(4)
    for d in range(1, nb):
        Mp[d] = Mp[d - 1] @ M
    P = _np.zeros((nb, nb, 4, 4))
    for k in range(1, nb):
        for j in range(k):
            P[k, j] = Mp[k - 1 - j]
    return P.transpose(0, 2, 1, 3).reshape(nb * 4, nb * 4)


@_functools.lru_cache(maxsize=32)
def _iir_block_tables(a_coeffs, b_coeffs, block):
    """Precompute (in float64 numpy) the blocked-recurrence tables for the
    reference IIR: impulse response h[d] = r^T A^d e0, within-block input
    weights, block transition M = A^block, and boundary read G[j] = r^T
    A^(j+1)."""
    import numpy as _np
    a0, a1, a2 = a_coeffs
    b0, b1 = b_coeffs
    A = _np.array([[a0, a1, a2, 0.0],
                   [1.0, 0.0, 0.0, 0.0],
                   [0.0, 1.0, 0.0, 0.0],
                   [0.0, 0.0, 1.0, 0.0]])
    e0 = _np.array([1.0, 0.0, 0.0, 0.0])
    r = _np.array([b0, b1, b1, b0])
    L = block
    Apow = _np.empty((L + 1, 4, 4))
    Apow[0] = _np.eye(4)
    for d in range(L):
        Apow[d + 1] = Apow[d] @ A
    h = _np.array([r @ Apow[d] @ e0 for d in range(L)])          # [L]
    G = _np.array([r @ Apow[j + 1] for j in range(L)])           # [L, 4]
    Wc = _np.array([Apow[L - 1 - j] @ e0 for j in range(L)])     # [L, 4]
    M = Apow[L]
    # lower-triangular Toeplitz of the impulse response: Hm[i, j] = h[j - i]
    idx = _np.arange(L)
    D = idx[None, :] - idx[:, None]
    Hm = _np.where(D >= 0, h[_np.clip(D, 0, L - 1)], 0.0)        # [L, L]
    return Hm, G, Wc, M


def iir_affine_scan(x, a_coeffs, b_coeffs, block=256):
    """Run the reference's direct-form-II IIR over time, exactly, as blocked
    matmuls.

    The recurrence (FilterForDecimate,
    /root/reference/src/world_matlabfunctions.cpp:115-124)::

        wt   = x[i] + a0*w0 + a1*w1 + a2*w2
        y[i] = b0*wt + b1*w0 + b1*w1 + b0*w2
        (w0, w1, w2) <- (wt, w0, w1)

    is a linear recurrence s' = A s + e0 x with constant A, so a length-L
    block advances the state by s_{k+1} = A^L s_k + W_c x_block and emits
    y_block = G s_k + H x_block with H the lower-triangular Toeplitz of the
    impulse response — all dense matmuls plus one tiny scan over block
    boundaries (instead of a log-depth associative scan of 4x4 affine
    maps, i.e. batched tiny matmuls).

    Args:
        x: [T] input signal.
        a_coeffs: (a0, a1, a2) feedback coefficients.
        b_coeffs: (b0, b1) feedforward coefficients.

    Returns:
        [T] filtered output.
    """
    dt = x.dtype
    T = x.shape[0]
    L = block
    nb = -(-T // L)
    Hm, G, Wc, M = _iir_block_tables(tuple(a_coeffs), tuple(b_coeffs), L)
    Hm = jnp.asarray(Hm, dt)
    G = jnp.asarray(G, dt)
    Wc = jnp.asarray(Wc, dt)
    M = jnp.asarray(M, dt)

    xb = jnp.pad(x, (0, nb * L - T)).reshape(nb, L)
    c = jnp.dot(xb, Wc, preferred_element_type=dt, precision=_PREC)          # [nb, 4]

    # block-start states via one matvec against the precomputed power table
    # (instead of a lax.scan with one loop step per block)
    P = jnp.asarray(
        _iir_boundary_table(tuple(a_coeffs), tuple(b_coeffs), L, nb), dt)
    s0 = jnp.dot(P, c.reshape(-1), preferred_element_type=dt,
                 precision=_PREC).reshape(nb, 4)

    y = jnp.dot(s0, G.T, preferred_element_type=dt, precision=_PREC) \
        + jnp.dot(xb, Hm, preferred_element_type=dt, precision=_PREC)
    return y.reshape(-1)[:T]


def biquad_zero_lag(x, a_coeffs, b_coeffs):
    """Zero-lag (forward-backward, reversed-output) biquad used by Harvest's
    F0 smoothing (filteringF0, /root/reference/src/harvest.cpp:639-665).

    The reference filters forward writing the output REVERSED, then filters
    that reversed signal forward writing reversed again — i.e. a standard
    forward-backward zero-phase pass.

    Recurrence: wt = x + a0*w0 + a1*w1; y = b0*wt + b1*w0 + b0*w1.
    State s = (wt, w0, w1) post-update with pre-update w1 as 3rd slot:
    y = (b0, b1, b0) . (wt, w0_old, w1_old).
    """
    a0, a1 = a_coeffs
    b0, b1 = b_coeffs
    dt = x.dtype

    def one_pass(sig):
        step = jnp.array(
            [[a0, a1, 0.0],
             [1.0, 0.0, 0.0],
             [0.0, 1.0, 0.0]], dtype=dt)
        mats = jnp.broadcast_to(step, (sig.shape[0], 3, 3))
        vecs = sig[:, None] * jnp.array([1.0, 0.0, 0.0], dtype=dt)
        _, out_vecs = jax.lax.associative_scan(_affine_combine, (mats, vecs))
        read = jnp.array([b0, b1, b0], dtype=dt)
        return out_vecs @ read

    y1 = one_pass(x)[::-1]
    return one_pass(y1)[::-1]


def decimate(x, r):
    """Zero-phase decimation by integer ratio r (2..12).

    Reference: decimate (/root/reference/src/world_matlabfunctions.cpp:184-210):
    reflect-pad by 9 samples with 2*edge - x mirroring, forward IIR, reverse,
    forward IIR, reverse, then pick every r-th sample starting at ``nbeg``.

    Args:
        x: [T] signal.
        r: static int ratio.

    Returns:
        [T//r + 1] decimated signal.
    """
    if r not in _DECIMATE_COEFFS:
        raise ValueError(f"unsupported decimation ratio {r}")
    a, b = _DECIMATE_COEFFS[r]
    k_nfact = 9
    head = 2.0 * x[0] - x[k_nfact:0:-1]
    tail = 2.0 * x[-1] - x[-2:-2 - k_nfact:-1]
    xx = jnp.concatenate([head, x, tail])
    y1 = iir_affine_scan(xx, a, b)[::-1]
    y2 = iir_affine_scan(y1, a, b)[::-1]
    x_length = x.shape[0]
    nout = x_length // r + 1
    nbeg = r - r * nout + x_length
    # y[count] = tmp1[i + kNFact - 1] for i = nbeg, nbeg+r, ... while
    # i < x_length + kNFact — note this yields MORE than nout picks when
    # r < kNFact; harvest only consumes a window of them
    # (/root/reference/src/harvest.cpp:232).
    n_picks = -(-(x_length + k_nfact - nbeg) // r)
    idx = nbeg + k_nfact - 1 + r * jnp.arange(n_picks)
    return y2[idx]


def dc_correction(power_spectrum, f0, fs, fft_size):
    """Mirror sub-F0 power back onto the low bins.

    Reference: DCCorrection (/root/reference/src/world_common.cpp:61-80).
    Operates on one frame; vmap over frames with per-frame f0.

    Args:
        power_spectrum: [K] with K = fft_size//2 + 1.
        f0: scalar frame F0.

    Returns:
        [K] corrected power spectrum.
    """
    k = power_spectrum.shape[-1]
    dt = power_spectrum.dtype
    f0 = jnp.asarray(f0, dtype=dt)
    i = jnp.arange(k, dtype=dt)
    upper_limit = 2 + (f0 * fft_size / fs).astype(jnp.int32)
    # interp1Q(x0=f0, dx=-fs/fft, y=input, xi=i*fs/fft) for i < upper_limit-1
    if dt == jnp.float64:
        # parity path: the reference's literal rounding order
        # (world_common.cpp:67-73 + interp1Q world_matlabfunctions.cpp:227-229)
        xi = i * fs / fft_size
        pos = (xi - f0) / (-(fs / fft_size))
    else:
        pos = f0 * fft_size / fs - i  # = (xi - f0)/(-fs/fft)
    base = pos.astype(jnp.int32)
    frac = pos - base.astype(dt)
    base_c = jnp.clip(base, 0, k - 2)
    y0 = jnp.take(power_spectrum, base_c)
    y1 = jnp.take(power_spectrum, base_c + 1)
    replica = y0 + (y1 - y0) * frac
    add = jnp.where(i < (upper_limit - 1).astype(dt), replica, 0.0)
    return power_spectrum + add


def dc_correction_frames(power_spectra, f0, fs, fft_size, max_f0):
    """Batched float32 DCCorrection over [N, K] frames.

    The correction only touches bins below upper_limit-1 ~ f0*fft/fs + 1,
    and its interpolation reads the spectrum below f0 — everything lives in
    the first L = O(max_f0*fft/fs) bins.  vmapped `dc_correction` lowers as
    a [N, K] random gather over the full spectrum (~100 ms per call on an
    8x3s batch); restricting the gather to the [N, L] low-bin slice is the
    same math at ~1/16 the touched elements.

    Args:
        power_spectra: [N, K].
        f0: [N] per-frame F0; values are assumed <= max_f0.
        max_f0: static bound on f0 (e.g. 1.2 * f0_ceil for pitch-scaled
            contours), sizing the low-bin slice.
    """
    N, K = power_spectra.shape
    dt = power_spectra.dtype
    L = min(K, int(max_f0 * fft_size / fs) + 4)
    ps = power_spectra[:, :L]
    i = jnp.arange(L, dtype=dt)
    f0 = f0.astype(dt)
    upper_limit = 2 + (f0 * fft_size / fs).astype(jnp.int32)    # [N]
    pos = f0[:, None] * fft_size / fs - i[None, :]              # [N, L]
    base = pos.astype(jnp.int32)
    frac = pos - base.astype(dt)
    base_c = jnp.clip(base, 0, L - 2)
    y0 = jnp.take_along_axis(ps, base_c, axis=1)
    y1 = jnp.take_along_axis(ps, base_c + 1, axis=1)
    replica = y0 + (y1 - y0) * frac
    add = jnp.where(i[None, :] < (upper_limit[:, None] - 1).astype(dt),
                    replica, 0.0)
    return jnp.concatenate([ps + add, power_spectra[:, L:]], axis=1)


def linear_smoothing(power_spectrum, width, fs, fft_size, max_boundary):
    """Rectangular smoothing of a power spectrum over ``width`` Hz.

    Reference: LinearSmoothing (/root/reference/src/world_common.cpp:82-116):
    mirror the spectrum by ``boundary`` bins on both sides, integrate
    (cumulative sum of bin power * fs/fft), then take the difference of the
    integral at f + width/2 and f - width/2 over width.

    Operates on one frame; vmap with per-frame width.  ``max_boundary`` is the
    static padding bound: int(max_width * fft / fs) + 1.

    Args:
        power_spectrum: [K].
        width: scalar smoothing width in Hz (dynamic).
        max_boundary: static int >= boundary for every frame.

    Returns:
        [K] smoothed spectrum.
    """
    k = power_spectrum.shape[-1]
    half = k - 1  # fft_size // 2
    dt = power_spectrum.dtype
    width = jnp.asarray(width, dtype=dt)
    boundary = (width * fft_size / fs).astype(jnp.int32) + 1

    # mirrored spectrum, padded to static length K + 2*max_boundary
    j = jnp.arange(k + 2 * max_boundary) - boundary  # signed position
    refl = jnp.abs(j)
    refl = jnp.where(refl > half, fft_size - refl, refl)
    refl = jnp.clip(refl, 0, half)
    mirr = jnp.take(power_spectrum, refl)

    if dt == jnp.float64:
        # parity path: the reference's literal arithmetic, term for term
        # (SetParametersForLinearSmoothing world_common.cpp:29-53 +
        # LinearSmoothing :82-116 + interp1Q world_matlabfunctions.cpp:220-241)
        vals = (mirr * fs) / fft_size
        # sequential left-to-right integration: seg[i] = vals[i] + seg[i-1]
        # with one rounding per step, exactly like the C++ loop (:45-49) —
        # a tree-reassociated cumsum differs by ~eps*total, which shows up
        # as 1e-7 relative error at near-zero tail bins after the
        # high-minus-low cancellation below
        def step(c, v):
            nc = v + c
            return nc, nc
        _, seg_rest = jax.lax.scan(step, vals[0], vals[1:])
        seg = jnp.concatenate([vals[:1], seg_rest])

        i = jnp.arange(k, dtype=dt)
        freq = i / fft_size * fs - width / 2.0        # :51-52
        origin = -(boundary.astype(dt) - 0.5) * fs / fft_size  # :95
        dx = fs / fft_size

        def levels(xi):
            t = (xi - origin) / dx                    # interp1Q :227-229
            base = t.astype(jnp.int32)                # trunc; t > 0 here
            frac = t - base.astype(dt)
            base_c = jnp.clip(base, 0, seg.shape[0] - 2)
            y0 = jnp.take(seg, base_c)
            y1 = jnp.take(seg, base_c + 1)
            return y0 + (y1 - y0) * frac

        return (levels(freq + width) - levels(freq)) / width

    # float32 path is in linear_smoothing_batch (gather-free grouped conv);
    # falling through here means a direct f32 call: delegate to the batch
    # form for one row
    return linear_smoothing_batch(
        power_spectrum[None, :], jnp.asarray(width)[None], fs, fft_size,
        max_boundary)[0]


def linear_smoothing_frames(power_spectra, widths, fs, fft_size,
                            max_boundary):
    """Batched LinearSmoothing over [N, K] frames with per-frame widths:
    f64 -> literal per-row reference semantics (vmap), f32 -> the gather-free
    grouped-conv formulation."""
    if power_spectra.dtype == jnp.float64:
        return jax.vmap(lambda p, w: linear_smoothing(
            p, w, fs, fft_size, max_boundary))(power_spectra, widths)
    return linear_smoothing_batch(power_spectra, widths, fs, fft_size,
                                  max_boundary)


def linear_smoothing_batch(power_spectra, widths, fs, fft_size, max_boundary):
    """Batched float32 LinearSmoothing, gather-free.

    The interpolated integral difference is four taps of the (inclusive)
    prefix sum at ROW-CONSTANT offsets: with integer boundary b and width-in-
    bins u, base = int(i +- u/2 + b - 0.5) = i + B with B = int(b - 0.5 -+
    u/2) and a row-constant fraction.  So the whole smoothing is one grouped
    convolution of the mirrored prefix sum with a per-row 4-tap kernel.
    Cancellation control: the prefix sum is taken over mean-removed values
    (a random walk instead of a ramp); the removed constant contributes
    exactly mean * u, independent of position.

    Args:
        power_spectra: [N, K].
        widths: [N] smoothing widths in Hz.
    Returns:
        [N, K].
    """
    N, K = power_spectra.shape
    half = K - 1
    dt = power_spectra.dtype
    mb = max_boundary
    widths = jnp.asarray(widths, dt)
    b = (widths * fft_size / fs).astype(jnp.int32) + 1          # [N]
    u = widths * fft_size / fs                                  # [N], real

    p = power_spectra
    mirr = jnp.concatenate(
        [p[:, 1:mb + 1][:, ::-1], p, p[:, half - mb:half][:, ::-1]],
        axis=1) * (fs / fft_size)                               # [N, K+2mb]

    bf = b.astype(dt)
    B_lo = (bf - 0.5 - u / 2.0).astype(jnp.int32)
    B_hi = (bf - 0.5 + u / 2.0).astype(jnp.int32)
    f_lo = (bf - 0.5 - u / 2.0) - B_lo.astype(dt)
    f_hi = (bf - 0.5 + u / 2.0) - B_hi.astype(dt)

    # the row's b-mirrored prefix sum relates to the fixed mb-mirrored one
    # by an index shift of delta = mb - b; any prefix origin cancels across
    # the four taps (their weights sum to zero)
    delta = mb - b
    Wk = 2 * mb + 4
    rows = jnp.arange(N)
    kern = jnp.zeros((N, Wk), dt)
    kern = kern.at[rows, jnp.clip(B_lo + delta, 0, Wk - 1)].add(-(1.0 - f_lo))
    kern = kern.at[rows, jnp.clip(B_lo + delta + 1, 0, Wk - 1)].add(-f_lo)
    kern = kern.at[rows, jnp.clip(B_hi + delta, 0, Wk - 1)].add(1.0 - f_hi)
    kern = kern.at[rows, jnp.clip(B_hi + delta + 1, 0, Wk - 1)].add(f_hi)

    # NO prefix sums in f32: applying the zero-sum 4-tap kernel to any
    # prefix sum (global or block-local) is algebraically a difference of
    # running integrals, whose f32 error scales with the INTEGRAL magnitude
    # — on high-dynamic-range spectra that error exceeds inter-harmonic
    # valley values and zeroes them (observed: valleys at 1e-6 of a clean
    # harmonic spectrum smoothed to exactly 0.0, then exp-amplified by the
    # lifter to ~15 dB envelope error).  The suffix sums of the 4-tap
    # kernel form the equivalent DENSE kernel — (1-f_lo), 1...1, f_hi over
    # the covered bins, all non-negative — so convolving it directly with
    # the mirrored spectrum computes the same integral with purely
    # positive accumulation: relative error ~eps regardless of dynamic
    # range, at the same FLOP count as the block-prefix form it replaces.
    dense = jnp.cumsum(kern[:, ::-1], axis=1)[:, ::-1]          # [N, Wk]
    # The taps' support is provably inside [mb/2 - 1, 3mb/2 + 3): with
    # u in [b-1, b), B_lo + delta = int(b - 0.5 - u/2) + mb - b >= mb - b/2
    # - 1 >= mb/2 - 1 and B_hi + delta + 1 <= mb + b/2 + 2 <= 3mb/2 + 2
    # (b <= mb), and dense is zero outside the tap span (the 4 taps sum to
    # zero, so the suffix cumsum vanishes below the lowest tap).  Slicing
    # the kernel to that support halves the grouped conv's tap count —
    # conv cost scales with taps — with bitwise-identical output (the
    # dropped taps are exact 0.0 summands).
    s0 = max(mb // 2 - 2, 0)
    Wk_s = Wk - s0 - max(mb // 2 - 2, 0)
    dense = dense[:, s0:s0 + Wk_s]
    padded = jnp.pad(mirr, ((0, 0), (0, 4)))[:, s0:s0 + K + Wk_s]
    conv = jax.lax.conv_general_dilated(
        padded[None], dense[:, None, :], window_strides=(1,),
        padding="VALID", dimension_numbers=("NCW", "OIW", "NCW"),
        feature_group_count=N, precision=_PREC)[0]              # [N, K+1]
    return conv[:, :K] / widths[:, None]
