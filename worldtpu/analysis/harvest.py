"""Harvest F0 estimation, batched over bands / frames / candidates.

Reference: /root/reference/src/harvest.cpp (1455 LoC).  Stage mapping:

  C++ (OpenMP loops)                      ->  worldtpu (batched tensors)
  ---------------------------------------------------------------------
  getWaveformAndSpectrum (:213-248)       ->  decimate (assoc-scan IIR) + rfft
  getRawF0Candidates over ~185 bands      ->  one [bands, fft] complex
    (:1310-1346)                              multiply + batched irfft;
                                              zero-crossing extraction and
                                              interval interpolation fully
                                              vectorized per band
  detectOfficialF0Candidates (:1052-1083) ->  per-frame run detection via
                                              cumsum/scatter over the band axis
  overlapF0Candidates (:987-1000)         ->  frame-shifted candidate layers
  refineF0Candidates over frames x cands  ->  all (frame, candidate) pairs as
    (:932-982)                                one padded batch; each pair's
                                              power-of-two FFT is evaluated
                                              exactly as a stride of ONE
                                              batched rfft at the maximum size
                                              (zero-padding a signal to 2^m
                                              and striding bins reproduces the
                                              smaller FFT bit-for-bit in exact
                                              arithmetic)
  removeUnreliableCandidates (:708-744)   ->  [F, S, S] neighbor error min
  fixF0Contour / smoothF0Contour          ->  host numpy (contour.py), O(F)

The candidate slot layout is a FIXED stride Cb = n_channels // 10 with zero
padding (the reference packs at the dynamic detected count; zero slots are
no-ops in every downstream consumer, verified against per-stage C++ dumps).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from worldtpu import constants as C
from worldtpu.analysis import contour
from worldtpu.flags import FLAGS
from worldtpu.ops import filters
from worldtpu.ops.fftutil import get_suitable_fft_size
from worldtpu.ops.interp import interp1


def _matlab_round_py(x):
    return int(x + 0.5) if x > 0 else int(x - 0.5)


def _matlab_round_np(x):
    return np.where(x > 0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(int)


_NUM_COS_DIV = 2000


@functools.lru_cache()
def _cos_table_np():
    """The reference's quarter-wave-mirrored cosine table
    (get_cos_table, /root/reference/src/harvest.cpp:152-170)."""
    n = _NUM_COS_DIV
    q = np.cos(np.arange(n + 1) * (C.PI / 2.0 / n))
    t = np.empty(4 * n + 1)
    t[:n + 1] = q
    t[n + 1:2 * n + 1] = -q[n - 1::-1]
    t[2 * n + 1:3 * n + 1] = -q[1:n + 1]
    t[3 * n + 1:4 * n + 1] = q[n - 1::-1]
    return t


def _main_window_values(t2, use_cos_table, dt, lookup=None):
    """Blackman-ish window from angle t2 = 2*pi*tmp/window_length_in_time.

    Exact-cos (reference getMainWindow :769-774) or the table variant
    (:775-787): dindex = fmod(2*pi*(tmp/wlt + 1), 2*pi)/2*pi*num_div,
    dindex2 = fmod(2*dindex, num_div*4), rounded lookups.  ``lookup``
    reads the table (default: a device copy of ``_cos_table_np``)."""
    if not use_cos_table:
        return 0.42 + 0.5 * jnp.cos(t2) + 0.08 * jnp.cos(2.0 * t2)
    num_div = _NUM_COS_DIV * 4
    two_pi = 2.0 * C.PI
    if lookup is None:
        lookup = jnp.asarray(_cos_table_np(), dt).__getitem__
    tmp2 = t2 + two_pi  # 2*pi*(tmp/wlt + 1)
    dindex = jnp.mod(tmp2, two_pi) / two_pi * num_div
    dindex2 = jnp.mod(dindex * 2.0, float(num_div))
    i1 = jnp.where(dindex > 0, jnp.floor(dindex + 0.5),
                   jnp.ceil(dindex - 0.5)).astype(jnp.int32)
    i2 = jnp.where(dindex2 > 0, jnp.floor(dindex2 + 0.5),
                   jnp.ceil(dindex2 - 0.5)).astype(jnp.int32)
    return 0.42 + 0.5 * lookup(i1) + 0.08 * lookup(i2)


def _matlab_round(x):
    return jnp.where(x > 0, jnp.floor(x + 0.5), jnp.ceil(x - 0.5)).astype(jnp.int32)


class HarvestGeometry:
    """Static geometry shared by all stages (the reference ctor's
    preallocation math, /root/reference/src/harvest.cpp:69-141)."""

    def __init__(self, fs, x_length, f0_floor=C.FLOOR_F0, f0_ceil=C.CEIL_F0,
                 frame_period=5.0, target_fs=8000.0, channels_in_octave=40.0,
                 use_cos_table=False):
        self.fs = fs
        self.x_length = x_length
        self.f0_floor = f0_floor
        self.f0_ceil = f0_ceil
        self.frame_period = frame_period
        self.channels_in_octave = channels_in_octave
        self.use_cos_table = use_cos_table
        self.target_fs = target_fs

        self.ratio = max(1, min(12, _matlab_round_py(fs / target_fs)))
        self.actual_fs = fs / self.ratio

        adj_floor = f0_floor * 0.9
        adj_ceil = f0_ceil * 1.1
        self.n_channels = 1 + int(
            math.log(adj_ceil / adj_floor) / C.LOG2 * channels_in_octave)
        self.boundary_f0 = adj_floor * 2.0 ** (
            (np.arange(self.n_channels) + 1) / channels_in_octave)

        self.y_length = 1 + int(x_length / self.ratio)
        self.fft_size = get_suitable_fft_size(
            self.y_length
            + 4 * int(1.0 + self.actual_fs / self.boundary_f0[0] / 2.0))

        self.f0_length = 1 + int(1000.0 * x_length / fs)  # 1 ms internal grid
        self.cb = int(self.n_channels / 10)               # base candidate slots
        self.max_candidates = self.cb * 7

        # band filter worst case: round(actual_fs / boundary_f0[0] * 2)
        self.max_filter_half = _matlab_round_py(
            self.actual_fs / self.boundary_f0[0] * 2.0)
        # refine worst case window (harvest.cpp:85-87)
        self.max_half_window = int(1.5 * self.actual_fs / f0_floor + 1.0)
        self.max_fft_index = 2 + int(
            math.log(self.max_half_window * 2 + 1.0) / C.LOG2)
        self.refine_fft = 2 ** self.max_fft_index
        # static event-count cap per (band, type): the crossing rate of a
        # [0.5b, 1.5b]-bandpassed signal is bounded by its top edge 1.5b;
        # 1.8x margin over that
        dur = x_length / fs
        self.e_max = int(min(self.y_length // 2 + 2,
                             dur * adj_ceil * 1.8 + 64))

        #: internal candidate-grid period (ms).  The reference runs its
        #: generalBody on a 1 ms grid (harvest.cpp:191-196); with_grid(k)
        #: derives a geometry for a coarser k ms candidate/refine grid
        #: (the contour chain stays on the 1 ms grid via nearest-frame
        #: upsampling, mirroring the reference's own frame_period
        #: subsampling at :201-203).
        self.grid_ms = 1
        self._grid_cache = {}

    def with_grid(self, k):
        """Memoized copy of this geometry on a k ms candidate grid (same
        object identity per k, so jit static-arg caching stays stable)."""
        if k == self.grid_ms:
            return self
        if k not in self._grid_cache:
            g = HarvestGeometry(
                self.fs, self.x_length, f0_floor=self.f0_floor,
                f0_ceil=self.f0_ceil, frame_period=self.frame_period,
                target_fs=self.target_fs,
                channels_in_octave=self.channels_in_octave,
                use_cos_table=self.use_cos_table)
            # reference getSamples(fs, x_length, frame_period=k) (:173-176)
            g.f0_length = 1 + int(1000.0 * self.x_length / self.fs / k)
            g.grid_ms = k
            self._grid_cache[k] = g
        return self._grid_cache[k]


# ---------------------------------------------------------------------------
# stage A: decimation
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("ratio", "y_length"))
def decimate_stage(x, *, ratio, y_length):
    """Downsample to ~8 kHz (reference getWaveformAndSpectrum :213-236).

    Returns y WITHOUT mean removal (the caller subtracts the reference's
    int-truncated mean, which is exactly 0 for |y| < 1 signals)."""
    if ratio == 1:
        # reference copies x then zero-fills to y_length = x_length+1 (:217-219)
        return jnp.concatenate(
            [x, jnp.zeros((y_length - x.shape[0],), x.dtype)])
    lag = int(math.ceil(140.0 / ratio)) * ratio
    head = jnp.full((lag,), x[0], x.dtype)
    tail = jnp.full((lag,), x[-1], x.dtype)
    xx = jnp.concatenate([head, x, tail])
    yy = filters.decimate(xx, ratio)
    return jax.lax.dynamic_slice(yy, (lag // ratio,), (y_length,))


# ---------------------------------------------------------------------------
# stage B: band candidates
# ---------------------------------------------------------------------------

def _zero_crossings(sig, n_eff, e_max, fs_a, tpos, grid_hz=1000.0):
    """Events + interval interpolation for one signal (one band, one of the
    four crossing types).  Reference zeroCrossingEngine (:1179-1219) +
    interp1-to-frames (:1113-1126).

    Args:
        sig: [L] signal (already negated/diffed per type).
        n_eff: effective length (y_length or y_length-1).
        tpos: [F] frame times.

    Returns:
        (interp [F], n_events) — interp is garbage when n_events < 4
        (the caller gates).
    """
    L = sig.shape[0]
    i = jnp.arange(L - 1)
    mask = (sig[:-1] > 0.0) & (sig[1:] <= 0.0) & (i < n_eff - 1)
    fine = (i + 1).astype(sig.dtype) - sig[:-1] / (sig[1:] - sig[:-1])

    if sig.dtype != jnp.float64:
        # fold sample pairs before compacting: two adjacent positions can
        # never both be events (s[i+1] <= 0 contradicts s[i+1] > 0), so the
        # scatter (which XLA lowers via a sort over its update count) only
        # needs half the updates
        Lp = (L - 1) // 2
        me, mo = mask[:2 * Lp:2], mask[1:2 * Lp:2]
        mask_p = me | mo
        fine_p = jnp.where(me, fine[:2 * Lp:2], fine[1:2 * Lp:2])
        tail_mask = mask[2 * Lp:]
        tail_fine = fine[2 * Lp:]
        mask_c = jnp.concatenate([mask_p, tail_mask])
        fine_c = jnp.concatenate([fine_p, tail_fine])
    else:
        mask_c = mask
        fine_c = fine

    m = jnp.arange(mask_c.shape[0])
    cum = jnp.cumsum(mask_c)
    count = cum[-1]
    # unique scatter indices (duplicate dump slots force XLA into a
    # serialized scatter): events go to their rank, non-events to distinct
    # slots past e_max
    slot = jnp.where(mask_c, jnp.minimum(cum - 1, e_max - 1),
                     e_max + (m - cum))
    dense = jnp.full((e_max + mask_c.shape[0],), jnp.inf, sig.dtype)
    dense = dense.at[slot].set(fine_c, unique_indices=True)

    f_lo = dense[:e_max]
    f_hi = dense[1:e_max + 1]
    locations = (f_lo + f_hi) / 2.0 / fs_a
    intervals = fs_a / (f_hi - f_lo)
    k = jnp.arange(e_max)
    n_int = count - 1
    locations = jnp.where(k < n_int, locations, jnp.inf)

    if sig.dtype == jnp.float64:
        # parity path: literal histc/searchsorted edge semantics
        vals = interp1(locations, intervals, tpos, n_valid=n_int)
        return vals, count

    # production path — histc segment index per (1 ms-grid) frame without
    # binary search: seg(t) = clip(#locations <= t, 1, n_int-1), counted by
    # scattering each location into its first affected frame + cumsum
    F = tpos.shape[0]
    first_frame = jnp.ceil(locations * grid_hz).astype(jnp.int32)
    first_frame = jnp.where(k < n_int, jnp.clip(first_frame, 0, F), F)
    hits = jnp.zeros((F + 1,), jnp.int32).at[first_frame].add(1)
    nle = jnp.cumsum(hits[:F])                     # #locs <= t_f
    seg = jnp.clip(nle, 1, jnp.maximum(n_int - 1, 1))
    x0 = jnp.take(locations, seg - 1)
    x1 = jnp.take(locations, seg)
    y0 = jnp.take(intervals, seg - 1)
    y1 = jnp.take(intervals, seg)
    vals = y0 + (tpos - x0) / (x1 - x0) * (y1 - y0)
    return vals, count


def _bandpass_kernels(geo, dt, lo=0, hi=None, half_max=None):
    """Centered Nuttall*cos bandpass kernel bank [hi-lo, 2*half_max+1] for
    bands [lo, hi).  Reference getFilteredSignal (:1261-1269); the kernels
    are symmetric, so filtering == correlation with the centered kernel at
    lag n+1."""
    if hi is None:
        hi = geo.n_channels
    Lk = geo.max_filter_half if half_max is None else half_max
    j = jnp.arange(2 * Lk + 1)
    halves = jnp.asarray(
        [_matlab_round_py(geo.actual_fs / b * 2.0)
         for b in geo.boundary_f0[lo:hi]], jnp.int32)[:, None]
    bounds = jnp.asarray(geo.boundary_f0[lo:hi], dt)[:, None]
    m = j[None, :] - Lk                         # centered tap index
    in_f = jnp.abs(m) <= halves
    tpos_w = (m + halves).astype(dt) / (2 * halves).astype(dt)
    win = (0.355768
           - 0.487396 * jnp.cos(2.0 * C.PI * tpos_w)
           + 0.144232 * jnp.cos(4.0 * C.PI * tpos_w)
           - 0.012604 * jnp.cos(6.0 * C.PI * tpos_w))
    t = m.astype(dt) / geo.actual_fs
    return jnp.where(in_f, win * jnp.cos(2.0 * C.PI * bounds * t), 0.0)


def _conv_groups(geo):
    """Split the band axis into contiguous groups whose kernel half-widths
    share a power-of-two bucket: conv time scales with taps (measured ~4x
    between 817 and 203 taps), and the log-spaced filter bank wastes ~2.5x
    when every band pays the widest band's taps."""
    halves = [_matlab_round_py(geo.actual_fs / b * 2.0)
              for b in geo.boundary_f0]          # decreasing in band index
    Lmax = geo.max_filter_half
    groups = []
    lo = 0
    while lo < geo.n_channels:
        cap = max(16, Lmax // 8)
        while cap < halves[lo]:
            cap *= 2
        hi = lo
        while hi < geo.n_channels and halves[hi] <= cap:
            hi += 1
        groups.append((lo, hi, min(cap, Lmax)))
        lo = hi
    return groups


def _bandpass_kernels_np(geo, lo=0, hi=None, Lk=None):
    """numpy twin of _bandpass_kernels (trace-time use, where jnp ops
    would stage under omnistaging instead of folding)."""
    if hi is None:
        hi = geo.n_channels
    Lk = geo.max_filter_half if Lk is None else Lk
    j = np.arange(2 * Lk + 1)
    halves = np.asarray([_matlab_round_py(geo.actual_fs / b * 2.0)
                         for b in geo.boundary_f0[lo:hi]],
                        np.int64)[:, None]
    bounds = np.asarray(geo.boundary_f0[lo:hi], np.float32)[:, None]
    m = j[None, :] - Lk
    in_f = np.abs(m) <= halves
    tpos_w = ((m + halves) / (2.0 * halves)).astype(np.float32)
    win = (0.355768
           - 0.487396 * np.cos(2.0 * np.float32(C.PI) * tpos_w)
           + 0.144232 * np.cos(4.0 * np.float32(C.PI) * tpos_w)
           - 0.012604 * np.cos(6.0 * np.float32(C.PI) * tpos_w))
    t_s = (m / geo.actual_fs).astype(np.float32)
    return np.where(
        in_f, (win * np.cos(2.0 * np.float32(C.PI) * bounds * t_s)
               ).astype(np.float32), np.float32(0.0))


def _bank_from_kern_np(kern):
    """Shifted-kernel bank for the blocked-Toeplitz matmul form of the band
    filter conv: K'[c1, q*Nbg + b] = kern[b, c1 - q] (0 <= c1-q < T, else 0)
    with T taps, c1 < 128*W, q < 128.  Then for blocks
    Bm[p, c1] = ypad[128p + c1] the product Bm @ K' yields every output
    sample out[128p+q, b] = sum_t ypad[128p+q+t] kern[b, t] exactly — the
    same correlation conv_general_dilated computes, but as ONE large
    matmul instead of a 1-input-channel convolution.
    Returns (W, np K' [128W, 128*Nbg]) — numpy, NOT device_put: built at
    trace time (a device_put here would cache a tracer that leaks into
    later traces); embeds as a constant."""
    nbg, T = kern.shape
    W = -(-(T + 127) // 128)                     # c1 = q + t <= 127 + T - 1
    c1 = np.arange(128 * W)[:, None]
    q = np.arange(128)[None, :]
    t = c1 - q                                   # [128W, 128]
    valid = (t >= 0) & (t < T)
    kp = np.concatenate([kern, np.zeros((nbg, 1), np.float32)], axis=1)
    kb = kp[:, np.where(valid, t, T)]            # [nbg, 128W, 128]
    kb = np.ascontiguousarray(kb.transpose(1, 2, 0)).reshape(
        128 * W, 128 * nbg)
    return W, kb


@functools.lru_cache(maxsize=32)
def _conv_matmul_bank(geo, lo, hi, Lg):
    """Cached (W, K') for a contiguous band group (see _bank_from_kern_np)."""
    return _bank_from_kern_np(_bandpass_kernels_np(geo, lo, hi, Lg))


def _band_filter_matmul_kb(ym, kb, W, Lg, y_len, dt):
    """Apply a shifted-kernel bank (device or np) to one signal: returns
    [Nbg, y_length].  Same centered-correlation alignment as the conv
    path: ypad = pad(ym, (Lg-1, Lg+1)) and out[n] = corr at lag n+1."""
    nbg = kb.shape[1] // 128
    P = -(-y_len // 128)
    ypad = jnp.pad(ym, (Lg - 1, 128 * (P + W) - y_len - 2 * Lg + Lg + 1))
    blocks = ypad.reshape(P + W, 128)
    bm = jnp.concatenate([blocks[j:j + P] for j in range(W)],
                         axis=1)                  # [P, 128W]
    out = jnp.dot(bm, kb.astype(dt),
                  precision=CONV_MM_PRECISION)    # [P, 128*nbg]
    out = out.reshape(P, 128, nbg).reshape(P * 128, nbg)
    return out[:y_len].T                          # [nbg, y_len]


def _band_filter_matmul(ym, geo, dt, lo=0, hi=None, Lg=None):
    """Band filter bank [Nbg, y_length] for a contiguous band group as a
    blocked-Toeplitz matmul (see _bank_from_kern_np)."""
    if hi is None:
        hi = geo.n_channels
    if Lg is None:
        Lg = geo.max_filter_half
    W, kb = _conv_matmul_bank(geo, lo, hi, Lg)
    return _band_filter_matmul_kb(ym, kb, W, Lg, geo.y_length, dt)


def _band_filter_fft(y_spectrum, boundary_f0, filter_half, geo, dt):
    """One band's filtered signal via the reference's circular-FFT route."""
    fft_size = geo.fft_size
    fs_a = geo.actual_fs
    Lmax = geo.max_filter_half
    j = jnp.arange(2 * Lmax + 1)
    in_f = j <= 2 * filter_half
    win = filters.nuttall_window_ragged(
        2 * filter_half + 1, 2 * Lmax + 1, dt)
    t = (j - filter_half).astype(dt) / fs_a
    bpf = jnp.where(in_f, win * jnp.cos(2.0 * C.PI * boundary_f0 * t), 0.0)
    H = jnp.fft.rfft(bpf, n=fft_size)
    filtered = jnp.fft.irfft(y_spectrum * H, n=fft_size) * fft_size
    shift = filter_half + 1
    return jnp.roll(filtered, -shift)[:geo.y_length]


def _band_candidates(f, boundary_f0, geo, tpos):
    """Candidate contour for ONE band's filtered signal (vmapped).
    Reference getFourZeroCrossingIntervals + getF0CandidateContour
    (:1098-1143, :1228-1255)."""
    dt = f.dtype
    y_len = geo.y_length
    fs_a = geo.actual_fs
    g = f[1:] - f[:-1]  # diff for peaks/dips (length y_len-1)
    g = jnp.concatenate([g, jnp.zeros((1,), dt)])

    sigs = jnp.stack([f, -f, g, -g])
    n_effs = jnp.asarray([y_len, y_len, y_len - 1, y_len - 1])
    cs, ns = jax.vmap(
        lambda s, ne: _zero_crossings(s, ne, geo.e_max, fs_a, tpos,
                                      grid_hz=1000.0 / geo.grid_ms))(
            sigs, n_effs)

    usable = jnp.all(ns - 1 > 2)
    cand = jnp.sum(cs, axis=0) / 4.0
    upper = boundary_f0 * 1.1
    lower = boundary_f0 * 0.9
    ok = (cand <= upper) & (cand >= lower) \
        & (cand <= geo.f0_ceil) & (cand >= geo.f0_floor)
    return jnp.where(usable & ok, cand, 0.0)


def _detect_candidates(raw, geo):
    """Per-frame voiced-run averaging across bands.
    Reference detectOfficialF0Candidates (:1052-1083).

    Args:
        raw: [Nb, F] raw band candidates.

    Returns:
        [F, Cb] base candidates (zero-padded fixed layout).
    """
    Nb, F = raw.shape
    r = raw.T  # [F, Nb]
    v = r > 0.0
    v = v.at[:, 0].set(False).at[:, -1].set(False)

    st = jnp.concatenate(
        [jnp.zeros((F, 1), bool), v[:, 1:] & ~v[:, :-1]], axis=1)

    # Scatter-free run statistics: XLA lowers a [F, Nb] scatter-add through
    # a sort of all F*Nb updates (measured ~1/3 of the candidates stage);
    # the same run sums/lengths fall out of a one-hot masked reduction that
    # fuses into plain VPU loops.  NOTE: the C sums j in [st, ed) which
    # equals the voiced run [st, ed-1], and ed-st == run length.
    smax = Nb // 2 + 2
    sid = jnp.cumsum(st, axis=1) - 1                       # [F, Nb]
    vsid = jnp.where(v, sid, smax)
    ss = jnp.arange(smax)
    oh = vsid[:, :, None] == ss[None, None, :]             # [F, Nb, smax]
    sums = jnp.sum(jnp.where(oh, r[:, :, None], 0.0), axis=1)
    lens = jnp.sum(oh, axis=1)

    valid = lens >= 10
    means = sums / jnp.maximum(lens, 1)

    rank = jnp.cumsum(valid, axis=1) - 1
    ohc = (valid & (rank < geo.cb))[:, :, None] \
        & (rank[:, :, None] == jnp.arange(geo.cb)[None, None, :])
    return jnp.sum(jnp.where(ohc, means[:, :, None], 0.0), axis=1)


def _overlap_candidates(base):
    """Spread candidates +-3 frames (reference :987-1000).

    Args:  base [F, Cb].  Returns [F, 7*Cb]."""
    F, cb = base.shape
    layers = [base]
    for i in (1, 2, 3):
        past = jnp.roll(base, i, axis=0).at[:i].set(0.0)
        layers.append(past)
    for i in (1, 2, 3):
        fut = jnp.roll(base, -i, axis=0).at[F - i:].set(0.0)
        layers.append(fut)
    return jnp.stack(layers, axis=1).reshape(F, 7 * cb)


def _filter_bank(ym, geo):
    """f32 band filter bank [Nb, y_length]: convolutions grouped by kernel
    width (mathematically identical to the reference's circular-FFT route:
    the FFT buffer's zero padding makes the circular convolution linear).

    The band signals only seed zero-crossing CANDIDATES (refinement
    re-estimates F0 from the raw waveform), so the filter runs at
    CONV_MM_PRECISION (default: the backend's fast f32 matmul)."""
    dt = ym.dtype
    parts = []
    for lo, hi, Lg in _conv_groups(geo):
        if CONV_MODE == "matmul":
            parts.append(_band_filter_matmul(ym, geo, dt, lo, hi, Lg))
        else:
            kern = _bandpass_kernels(geo, dt, lo, hi, Lg)
            ypad = jnp.pad(ym, (Lg - 1, Lg + 1))
            parts.append(jax.lax.conv_general_dilated(
                ypad[None, None, :], kern[:, None, :],
                window_strides=(1,), padding="VALID",
                dimension_numbers=("NCW", "OIW", "NCW"),
                precision=jax.lax.Precision.DEFAULT)[0])
    return jnp.concatenate(parts, axis=0)


@functools.partial(jax.jit, static_argnames=("geo",))
def candidates_stage(y, mean_y, tpos, *, geo):
    """Stages B+C: decimated signal -> overlapped candidates [F, S]."""
    dt = y.dtype
    ym = y - mean_y

    if dt == jnp.float64:
        # parity path: the reference's circular-FFT filtering, chunked for
        # CPU memory
        y0 = jnp.concatenate(
            [ym, jnp.zeros((geo.fft_size - geo.y_length,), dt)])
        y_spectrum = jnp.fft.rfft(y0)
        bounds = jnp.asarray(geo.boundary_f0, dt)
        halves = jnp.asarray(
            [_matlab_round_py(geo.actual_fs / b * 2.0)
             for b in geo.boundary_f0], jnp.int32)
        raw = jax.lax.map(
            lambda args: _band_candidates(
                _band_filter_fft(y_spectrum, args[0], args[1], geo, dt),
                args[0], geo, tpos),
            (bounds, halves), batch_size=16)
    else:
        filt = _filter_bank(ym, geo)                  # [Nb, y_len]
        bounds = jnp.asarray(geo.boundary_f0, dt)
        raw = jax.vmap(
            lambda fi, b: _band_candidates(fi, b, geo, tpos))(filt, bounds)
    base = _detect_candidates(raw, geo)
    return _overlap_candidates(base), raw, base


# ---------------------------------------------------------------------------
# stage D: instantaneous-frequency refinement
# ---------------------------------------------------------------------------

def refine_pair_params(f0s, geo):
    """Per-pair refine geometry from (dummy-filled) candidates ``f0s`` of
    any shape [...]: half window ``hw``, window length in seconds ``wlt``,
    per-pair FFT size ``fft_p``, harmonic count ``n_harm``, harmonic bins
    ``idx_h`` [..., 6] and their global 2^max-grid bins ``gbin`` [..., 6]
    (reference getMeanF0/fixF0 sizing, harvest.cpp:844-905).  Shared by
    every refine implementation so they agree on integer geometry."""
    dt = f0s.dtype
    fs_a = geo.actual_fs
    hw = (1.5 * fs_a / f0s + 1.0).astype(jnp.int32)
    w_len = 2 * hw + 1
    fft_index = 2 + (jnp.log(w_len.astype(dt)) / C.LOG2).astype(jnp.int32)
    fft_p = jnp.left_shift(1, fft_index)
    ratio = geo.refine_fft // fft_p                    # global-bin stride
    wlt = w_len.astype(dt) / fs_a
    n_harm = jnp.minimum((fs_a / 2.0 / f0s).astype(jnp.int32), 6)
    h = jnp.arange(6)
    idx_h = _matlab_round(
        f0s[..., None] * fft_p[..., None].astype(dt) / fs_a
        * (h + 1.0))                                   # [..., 6]
    gbin = jnp.clip(idx_h * ratio[..., None], 0, geo.refine_fft // 2)
    return hw, wlt, fft_p, n_harm, idx_h, gbin


def refine_finish(Sm_re, Sm_im, Sd_re, Sd_im, f0s, active, fft_p, n_harm,
                  idx_h, geo):
    """Instantaneous-frequency F0 and score from the harmonic-bin spectra
    [..., 6] of the main and differentiated windows (reference
    harvest.cpp:907-939), with the reference's floor/ceil/score gates."""
    dt = Sm_re.dtype
    fs_a = geo.actual_fs
    h = jnp.arange(6)
    power = Sm_re ** 2 + Sm_im ** 2
    num_i = Sm_re * Sd_im - Sm_im * Sd_re
    base_freq = idx_h.astype(dt) * fs_a / fft_p[..., None].astype(dt)
    instf = jnp.where(power == 0.0, 0.0,
                      base_freq + num_i / power * fs_a / (2.0 * C.PI))
    amp = jnp.sqrt(power)
    hmask = (h < n_harm[..., None]).astype(dt)

    numer = jnp.sum(amp * instf * hmask, axis=-1)
    denom = jnp.sum(amp * (h + 1.0) * hmask, axis=-1)
    refined = numer / (denom + C.MY_SAFE_GUARD_MINIMUM)
    dev = jnp.sum(jnp.abs(instf / (h + 1.0) - f0s[..., None])
                  / f0s[..., None] * hmask, axis=-1)
    score = 1.0 / (dev / jnp.maximum(n_harm, 1)
                   + C.MY_SAFE_GUARD_MINIMUM)

    bad = ((refined < geo.f0_floor) | (refined > geo.f0_ceil)
           | (score < 2.5) | ~active)
    refined = jnp.where(bad, 0.0, refined)
    score = jnp.where(bad, 0.0, score)
    return refined, score


#: dummy F0 of inactive refine slots (keeps the pair math finite)
REFINE_DUMMY_F0 = 100.0


def _refine_chunk(y, cand, pos, geo):
    """Refine one chunk of frames; cand [Fc, S], pos [Fc].
    Reference refineF0Candidates/getMeanF0/fixF0 (:844-982).

    Production (float32) path: every pair in a frame reads the same
    603-sample neighborhood of y, so the waveform is gathered ONCE per frame
    and pair windows are built in segment coordinates m = j + (hwmax - hw).
    The induced time shift multiplies both spectra by the same unit phase,
    which cancels exactly in |S_main|^2 and Im(conj(S_main) S_diff) — so no
    correction is needed.  This removes a [pairs, W] waveform gather.
    Spectra come from a direct 6-bin DFT on the global 2^max grid (bin
    k*stride of the 2^max FFT == bin k of each pair's own FFT).
    The float64 path keeps the literal per-pair layout + batched rfft for
    bitwise golden parity."""
    dt = y.dtype
    Fc, S = cand.shape
    P = Fc * S
    f0 = cand.reshape(P)
    pp = jnp.broadcast_to(pos[:, None], (Fc, S)).reshape(P)
    active = f0 > 0.0
    f0s = jnp.where(active, f0, REFINE_DUMMY_F0)

    fs_a = geo.actual_fs
    hw, wlt, fft_p, n_harm, idx_h, gbin = refine_pair_params(f0s, geo)
    hwmax = geo.max_half_window
    Wmax = 2 * hwmax + 1

    if dt == jnp.float64:
        # ---- parity path: literal per-pair windows + batched rfft ----
        w_len = 2 * hw + 1
        pr = jnp.arange(P)[:, None]
        j = jnp.arange(Wmax)
        in_w = j[None, :] < w_len[:, None]
        base_time0 = -hw.astype(dt) / fs_a
        basic_index = _matlab_round((pp + base_time0) * fs_a + 0.001)
        base_index = basic_index[:, None] + j[None, :]
        tmp = (base_index.astype(dt) - 1.0) / fs_a - pp[:, None]
        t2 = 2.0 * C.PI * tmp / wlt[:, None]
        mw = _main_window_values(t2, geo.use_cos_table, dt)
        mw = jnp.where(in_w, mw, 0.0)
        mw_m1 = jnp.concatenate([jnp.zeros((P, 1), dt), mw[:, :-1]], axis=1)
        mw_p1 = jnp.concatenate([mw[:, 1:], jnp.zeros((P, 1), dt)], axis=1)
        dw = jnp.where(in_w, -(mw_p1 - mw_m1) / 2.0, 0.0)
        safe = jnp.clip(base_index - 1, 0, geo.y_length - 1)
        seg = y[safe]
        main = seg * mw
        diff = seg * dw
        Sm = jnp.fft.rfft(main, n=geo.refine_fft, axis=-1)
        Sd = jnp.fft.rfft(diff, n=geo.refine_fft, axis=-1)
        Sm_re, Sm_im = Sm.real[pr, gbin], Sm.imag[pr, gbin]
        Sd_re, Sd_im = Sd.real[pr, gbin], Sd.imag[pr, gbin]
    else:
        # ---- production path: frame segments + direct harmonic DFT ----
        m = jnp.arange(Wmax)
        origin = _matlab_round(pos * fs_a + 0.001)     # [Fc]
        q = origin[:, None] - 1 - hwmax + m[None, :]   # y index per (f, m)
        ys = y[jnp.clip(q, 0, geo.y_length - 1)]       # [Fc, Wseg]
        # sample times relative to the frame, from the small offset m plus
        # one per-frame shift: q / fs_a - pos would round every sample's
        # time at the scale of the absolute position (an f32 ulp at 4 s is
        # 5e-7 s), and that per-sample noise reaches the scores through the
        # differentiated window
        shift = (origin - 1 - hwmax).astype(dt) - pos * fs_a   # [Fc]
        tmp_f = (m[None, :].astype(dt) + shift[:, None]) / fs_a

        hw2 = hw.reshape(Fc, S)
        in_w = jnp.abs(m[None, None, :] - hwmax) <= hw2[:, :, None]
        t2 = (2.0 * C.PI) * tmp_f[:, None, :] / wlt.reshape(Fc, S)[:, :, None]
        mw = _main_window_values(t2, geo.use_cos_table, dt)
        mw = jnp.where(in_w, mw, 0.0)                  # [Fc, S, Wseg]
        z = jnp.zeros((Fc, S, 1), dt)
        dw = -(jnp.concatenate([mw[..., 1:], z], -1)
               - jnp.concatenate([z, mw[..., :-1]], -1)) / 2.0
        dw = jnp.where(in_w, dw, 0.0)
        main = (ys[:, None, :] * mw).reshape(P, Wmax)
        diff = (ys[:, None, :] * dw).reshape(P, Wmax)

        # direct 6-bin DFT: only the <=6 harmonic bins per pair are ever
        # read, so evaluating them directly is ~300x less FLOPs and memory
        # traffic than a full [2P, W] @ [W, 2K] matmul-DFT whose [2P, 2K]
        # spectra round-trip through device memory.  The sample index is
        # split m = 128q + r so the twiddles factor into [P,6,128] inner and
        # [P,6,Q] outer tables — ~30x fewer transcendentals than a full
        # [P,6,W] cos/sin grid, with the phase reduced exactly in int32
        # ((bin*m) mod N < 2^31) so f32 trig sees arguments in [0, 2pi).
        R = 128
        Q = -(-Wmax // R)
        padw = Q * R - Wmax
        N = geo.refine_fft
        main_q = jnp.pad(main, ((0, 0), (0, padw))).reshape(P, Q, R)
        diff_q = jnp.pad(diff, ((0, 0), (0, padw))).reshape(P, Q, R)
        rr = jnp.arange(R, dtype=jnp.int32)
        qq = jnp.arange(Q, dtype=jnp.int32)
        a_in = ((2.0 * C.PI / N)
                * ((gbin[:, :, None] * rr[None, None, :]) % N).astype(dt))
        ci, si = jnp.cos(a_in), jnp.sin(a_in)              # [P, 6, R]
        a_out = ((2.0 * C.PI / N)
                 * ((gbin[:, :, None] * (R * qq)[None, None, :]) % N
                    ).astype(dt))
        co, so = jnp.cos(a_out), jnp.sin(a_out)            # [P, 6, Q]
        # inner sums over r: S_r = A - iB per (pair, harmonic, q)
        Am = jnp.sum(main_q[:, None, :, :] * ci[:, :, None, :], -1)
        Bm = jnp.sum(main_q[:, None, :, :] * si[:, :, None, :], -1)
        Ad = jnp.sum(diff_q[:, None, :, :] * ci[:, :, None, :], -1)
        Bd = jnp.sum(diff_q[:, None, :, :] * si[:, :, None, :], -1)
        # outer combine with e^{-i theta 128 q}
        Sm_re = jnp.sum(Am * co - Bm * so, -1)
        Sm_im = -jnp.sum(Am * so + Bm * co, -1)
        Sd_re = jnp.sum(Ad * co - Bd * so, -1)
        Sd_im = -jnp.sum(Ad * so + Bd * co, -1)

    refined, score = refine_finish(Sm_re, Sm_im, Sd_re, Sd_im, f0s, active,
                                   fft_p, n_harm, idx_h, geo)
    return refined.reshape(Fc, S), score.reshape(Fc, S)


def refine_cap(S):
    """Refined-slot capacity per frame: only ~20 of the S=7*Cb candidate
    slots are ever active (observed max ~37 of 126), so the leading
    max(32, S//2) compacted slots are refined; refinement of a zero slot
    is the identity (0, 0)."""
    return min(S, max(32, S // 2))


@functools.partial(jax.jit, static_argnames=("geo", "chunk"))
def refine_stage(y, cand, tpos, *, geo, chunk=16):
    """Stage D over all frames in memory-bounded chunks.

    Active slots are compacted to the front and the leading
    ``refine_cap(S)`` are refined (see refine_cap)."""
    F, S = cand.shape
    cap = refine_cap(S)
    rows = jnp.arange(F)[:, None]
    cols = jnp.broadcast_to(jnp.arange(S)[None, :], (F, S))
    active = cand > 0.0
    rank = jnp.cumsum(active, axis=1) - 1              # rank among active
    nrank = cols - jnp.cumsum(active, axis=1)          # rank among inactive
    # unique scatter slots: active -> rank (< S), inactive -> S + nrank
    # (disjoint regions, unique within each; only [:cap] is consumed)
    slot = jnp.where(active, rank, S + nrank)
    sel_wide = jnp.zeros((F, 2 * S), jnp.int32).at[rows, slot].set(
        cols.astype(jnp.int32), unique_indices=True)
    sel = sel_wide[:, :cap]
    n_active = jnp.sum(active, axis=1, keepdims=True)
    valid = jnp.arange(cap)[None, :] < jnp.minimum(n_active, cap)
    cand_c = jnp.where(valid, jnp.take_along_axis(cand, sel, axis=1), 0.0)

    pad = (-F) % chunk
    cand_p = jnp.pad(cand_c, ((0, pad), (0, 0)))
    tpos_p = jnp.pad(tpos, (0, pad))
    cc = cand_p.reshape(-1, chunk, cap)
    tt = tpos_p.reshape(-1, chunk)
    ref, sc = jax.lax.map(
        lambda args: _refine_chunk(y, args[0], args[1], geo), (cc, tt))
    ref = ref.reshape(-1, cap)[:F]
    sc = sc.reshape(-1, cap)[:F]

    # scatter back; invalid lanes all target sel=0 with value -1 -> .max
    # keeps the true refined value (refined values are >= 0)
    ref_full = jnp.zeros((F, S), cand.dtype).at[rows, sel].max(
        jnp.where(valid, ref, -1.0))
    sc_full = jnp.zeros((F, S), cand.dtype).at[rows, sel].max(
        jnp.where(valid, sc, -1.0))
    return jnp.maximum(ref_full, 0.0), jnp.maximum(sc_full, 0.0)


# ---------------------------------------------------------------------------
# stage E: neighbor-consistency pruning
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=())
def remove_unreliable_stage(cand, score):
    """Reference removeUnreliableCandidates (:708-744): drop candidates with
    no close neighbor-frame candidate (relative error > 0.05).  The edge rows
    the C++ compares against are uninitialized-but-in-practice-zero heap;
    zeros give relative error 1.0, replicated here with explicit zero rows."""
    F, S = cand.shape
    z = jnp.zeros((1, S), cand.dtype)
    prev = jnp.concatenate([z, cand[:-1]], axis=0)   # tmp[i-1]; tmp[0] = 0
    nxt = jnp.concatenate([cand[1:], z], axis=0)     # tmp[i+1]; tmp[F-1] = 0

    def min_err(ref, others):
        # selectBestF0 with allowed_range=1.0: min(1.0, min_k |ref-c_k|/ref)
        e = jnp.abs(ref[:, :, None] - others[:, None, :]) / ref[:, :, None]
        return jnp.minimum(1.0, jnp.min(e, axis=-1))

    e1 = min_err(jnp.where(cand > 0, cand, 1.0), nxt)
    e2 = min_err(jnp.where(cand > 0, cand, 1.0), prev)
    drop = (jnp.minimum(e1, e2) > 0.05) & (cand > 0)
    interior = (jnp.arange(F) >= 1) & (jnp.arange(F) <= F - 2)
    drop = drop & interior[:, None]
    return (jnp.where(drop, 0.0, cand), jnp.where(drop, 0.0, score))


# ---------------------------------------------------------------------------
# fused device pipeline (one dispatch, one download)
# ---------------------------------------------------------------------------

#: Production near-duplicate candidate tolerance of the f32 refine
#: pre-pass (see dedup_candidates).  Stronger dedup (0.008-0.02) made the
#: vowel F0 RMSE ~5x worse against the C++ reference.
REFINE_DEDUP_TOL = 0.004


def dedup_candidates(cand, tol=None):
    """The f32 production pre-pass shared by every refine implementation:
    compact each frame's active candidates to the front in ascending
    order, and drop a value within ``tol * prev`` of its sorted
    predecessor ``prev``.  Returns [F, S], zero-padded after the survivors.

    Near-duplicate candidates refine to the same instantaneous-frequency
    attractor (and thus the same score): the +-3-frame overlap spreading
    (harvest.cpp:987-999) makes ~7x copies whose values drift by <~1%
    frame to frame, so refining one representative per tol-cluster is
    value-equivalent for every downstream consumer (argmax score,
    nearest-candidate selection and neighbour pruning operate on VALUES,
    never slot positions).  Without it the f32 path flips ~20 voicing
    decisions on the bench vowel against the C++ reference.  The f64
    parity path never takes it.  ``tol`` defaults to REFINE_DEDUP_TOL."""
    tol = REFINE_DEDUP_TOL if tol is None else tol
    F = cand.shape[0]
    cand_s = jnp.sort(jnp.where(cand > 0.0, cand, jnp.inf), axis=1)
    prev = cand_s[:, :-1]
    dup = jnp.concatenate(
        [jnp.zeros((F, 1), bool), (cand_s[:, 1:] - prev) <= tol * prev],
        axis=1) & jnp.isfinite(cand_s)
    cand_s = jnp.sort(jnp.where(dup, jnp.inf, cand_s), axis=1)
    return jnp.where(jnp.isfinite(cand_s), cand_s, 0.0)


def refine_backend(platform=None):
    """Which f32 refine implementation runs on ``platform`` (a JAX backend
    or lowering platform name; default: the default backend):
    ``"triton"`` — the adaptive Pallas kernel (ops/refine_kernel.py) on an
    NVIDIA GPU; ``"dense"`` — ``refine_stage`` on the CPU.  Any other
    platform is an error, not a fallback."""
    platform = jax.default_backend() if platform is None else platform
    if platform in ("gpu", "cuda"):
        return "triton"
    if platform == "cpu":
        return "dense"
    raise ValueError(f"no f32 refine implementation for platform "
                     f"{platform!r} (supported: gpu, cpu)")


def refine_production(y, cand, tpos, *, geo, chunk):
    """f32 stage D: the shared dedup pre-pass, then the implementation of
    the same dense semantics that ``refine_backend`` names for the
    platform the program is compiled for (so a GPU process can still run
    this program on its CPU device).  Lowering for a platform with no
    implementation fails."""
    cand = dedup_candidates(cand)

    def impl(platform):
        if refine_backend(platform) == "triton":
            from worldtpu.ops.refine_kernel import refine_stage_triton
            return functools.partial(refine_stage_triton, geo=geo)
        return functools.partial(refine_stage, geo=geo, chunk=chunk)

    return jax.lax.platform_dependent(
        y, cand, tpos, **{p: impl(p) for p in ("cpu", "cuda")})


#: Implementation-selector knobs, initialized from the validated central
#: registry (worldtpu.flags — one place for supported values, A/B'd
#: defaults, and the measurements that chose them).  These module names
#: stay mutable for tests that monkey-toggle a knob around a CPU call;
#: production processes set the environment before import (see the
#: worldtpu.flags docstring for why binding is at import time).
CONV_MODE = FLAGS.conv
CONV_MM_PRECISION = FLAGS.conv_precision
GRID_MS = FLAGS.grid_ms


def _grid_for(dtype, grid=None):
    """Internal candidate-grid period: the GRID_MS opt-in applies to the
    f32 production path only (f64 parity is pinned to the reference's
    1 ms grid); an explicit `grid` overrides."""
    if grid is not None:
        return grid
    return GRID_MS if dtype == jnp.float32 else 1


@functools.partial(jax.jit, static_argnames=("geo", "chunk", "grid"))
def harvest_device_stages(x, mean_y, *, geo, chunk=64, grid=None):
    """decimate -> candidates -> refine -> prune as ONE program.

    Returns a single flat [2*Fk*S] array (candidates ++ scores) so the
    host contour stage costs exactly one device->host transfer.

    With GRID_MS=k > 1 (f32 production opt-in; or explicit grid=k) ALL
    per-frame stages INCLUDING the downstream contour chain run on a k ms
    grid — exactly what the reference's own frame-period-parameterized
    generalBody computes at frame_period=k (harvest.cpp:1380-1441; its
    fixF0Contour constants are frame-based and unscaled by design) — and
    the consumer subsamples the k ms contour to the output frame_period
    with the same nearest-frame rule as :199-203.  Fk is
    geo.with_grid(k).f0_length; per-frame stage cost scales by 1/k."""
    dtype = x.dtype
    k = _grid_for(dtype, grid)
    geo_k = geo.with_grid(k)
    y = decimate_stage(x, ratio=geo.ratio, y_length=geo.y_length)
    tposk = jnp.arange(geo_k.f0_length, dtype=dtype) * (k / 1000.0)
    cand, _, _ = candidates_stage(y, mean_y, tposk, geo=geo_k)
    if dtype == jnp.float32:
        cand, score = refine_production(y - mean_y, cand, tposk, geo=geo_k,
                                        chunk=chunk)
    else:
        cand, score = refine_stage(y - mean_y, cand, tposk, geo=geo_k,
                                   chunk=chunk)
    cand, score = remove_unreliable_stage(cand, score)
    return jnp.concatenate([cand.reshape(-1), score.reshape(-1)])


harvest_device_stages_batch = jax.jit(
    jax.vmap(lambda x, m, geo, chunk, grid: harvest_device_stages(
        x, m, geo=geo, chunk=chunk, grid=grid),
        in_axes=(0, 0, None, None, None)),
    static_argnums=(2, 3, 4))


@functools.partial(jax.jit, static_argnames=("geo", "n_out", "chunk"))
def harvest_device_full(x, mean_y, *, geo, n_out, chunk=64):
    """Full on-device Harvest: wav -> frame-period F0 [n_out].

    Extends `harvest_device_stages` with the device contour chain
    (analysis.contour_device), so a batch costs ONE dispatch and the
    download is the F0 vector itself (vs the [F, S] candidate slab — 600x
    less transfer; the host contour path remains for f64 parity).  The
    contour chain runs on the stages' k ms grid (see harvest_device_stages)
    and fix_and_smooth subsamples it to the output frame grid."""
    from worldtpu.analysis import contour_device as CDV
    flat = harvest_device_stages(x, mean_y, geo=geo, chunk=chunk)
    k = _grid_for(x.dtype)
    F, S = geo.with_grid(k).f0_length, geo.max_candidates
    cand = flat[:F * S].reshape(F, S)
    score = flat[F * S:].reshape(F, S)
    return CDV.fix_and_smooth(cand, score, n_out, geo.frame_period,
                              grid_ms=k)


harvest_device_full_batch = jax.jit(
    jax.vmap(lambda x, m, geo, n_out, chunk: harvest_device_full(
        x, m, geo=geo, n_out=n_out, chunk=chunk),
        in_axes=(0, 0, None, None, None)),
    static_argnums=(2, 3, 4))


class ZcCapacityError(RuntimeError):
    """A band signal crossed zero more often than the candidate stage's
    static event buffer (``geo.e_max`` per band and crossing type) holds —
    events past the cap are clamped silently, so candidates for the
    affected bands may be corrupted.  See zc_capacity_violations_batch."""


@functools.partial(jax.jit, static_argnames=("geo",))
def zc_capacity_violations_batch(x, *, geo):
    """[B] count, per utterance, of (band, crossing type) signals whose
    event count exceeds ``geo.e_max`` — the static slot cap of the f32
    zero-crossing compaction (``_zero_crossings``), which otherwise clamps
    silently.  One cheap extra dispatch (decimate + filter bank + dense
    mask counts) that callers run beside the pipeline to detect
    pathological signals.  Reference analog: harvest.cpp:85-98
    preallocates a worst case and would overrun instead of detecting."""
    k = _grid_for(x.dtype)
    geo_k = geo.with_grid(k)

    def count(sig, n_eff):
        i = jnp.arange(sig.shape[1] - 1)
        m = (sig[:, :-1] > 0.0) & (sig[:, 1:] <= 0.0) & (i < n_eff - 1)
        return jnp.sum(m, axis=1)                      # [Nb]

    def one(xi):
        y = decimate_stage(xi, ratio=geo.ratio, y_length=geo.y_length)
        f = _filter_bank(y, geo_k)
        g = f[:, 1:] - f[:, :-1]
        n = jnp.stack([count(f, geo.y_length), count(-f, geo.y_length),
                       count(g, geo.y_length - 1),
                       count(-g, geo.y_length - 1)])
        return jnp.sum(n > geo_k.e_max).astype(jnp.int32)

    return jax.vmap(one)(x)


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

class HarvestKernel:
    """End-to-end Harvest for one (fs, x_length) geometry.

    Mirrors the reference facade: ctor computes all static geometry, compute()
    runs decimation -> candidates -> refinement -> pruning on device and the
    contour fixing (contour.py) on host, then subsamples the internal 1 ms
    grid to the requested frame_period (reference compute :183-208)."""

    def __init__(self, fs, x_length, f0_floor=C.FLOOR_F0, f0_ceil=C.CEIL_F0,
                 frame_period=5.0, target_fs=8000.0, channels_in_octave=40.0,
                 use_cos_table=False):
        self.geo = HarvestGeometry(
            fs, x_length, f0_floor=f0_floor, f0_ceil=f0_ceil,
            frame_period=frame_period, target_fs=target_fs,
            channels_in_octave=channels_in_octave,
            use_cos_table=use_cos_table)

    def get_samples(self):
        g = self.geo
        return 1 + int(1000.0 * g.x_length / g.fs / g.frame_period)

    def compute(self, x, dtype=jnp.float64, contour_on=None):
        g = self.geo
        x = jnp.asarray(x, dtype)
        if contour_on is None and dtype == jnp.float64:
            contour_on = "host"
        contour_on = self._auto_contour(contour_on)
        if dtype == jnp.float64:
            # parity path: the reference's int-truncating mean of the
            # decimated signal, computed exactly on host
            from worldtpu.native import int_trunc_sum
            y = decimate_stage(x, ratio=g.ratio, y_length=g.y_length)
            mean_y = int_trunc_sum(np.asarray(y)) / g.y_length
            chunk = 16
        else:
            # production path: that mean is exactly 0 whenever |y| < 1
            # (the int-truncated running sum never leaves 0); skip the
            # host round trip
            mean_y = 0.0
            chunk = 64
        if contour_on == "device":
            n_out = self.get_samples()
            f0 = np.asarray(harvest_device_full(
                x, jnp.asarray(mean_y, dtype), geo=g, n_out=n_out,
                chunk=chunk)).astype(np.float64)
            tpos = np.arange(n_out) * g.frame_period / 1000.0
            return f0, tpos
        flat = np.asarray(harvest_device_stages(
            x, jnp.asarray(mean_y, dtype), geo=g, chunk=chunk))
        return self._finish(flat, _grid_for(dtype))

    def _finish(self, flat, k=1):
        g = self.geo.with_grid(k)
        F, S = g.f0_length, g.max_candidates
        cand_h = flat[:F * S].reshape(F, S).astype(np.float64)
        score_h = flat[F * S:].reshape(F, S).astype(np.float64)
        best = contour.fix_f0_contour(cand_h, score_h, grid_ms=k)
        f0_grid = contour.smooth_f0_contour(best)

        n_out = self.get_samples()
        tpos = np.arange(n_out) * g.frame_period / 1000.0
        pick = np.minimum(g.f0_length - 1,
                          _matlab_round_np(tpos * (1000.0 / k)))
        return f0_grid[pick], tpos

    def _auto_contour(self, contour_on):
        # the device contour's static section layout is O(F^2/7) memory;
        # long single utterances (rare next to corpus streaming) fall back
        # to the host path
        if contour_on is None:
            return "device" if self.geo.f0_length <= 8192 else "host"
        return contour_on

    def compute_batch(self, x_batch, dtype=jnp.float32, chunk=32,
                      transfer_dtype=None, contour_on=None,
                      check_capacity=False):
        """Batched Harvest over [B, T] same-length utterances: one device
        dispatch + one transfer for the whole batch.

        contour_on: "device" (default) runs the full contour chain on
        device and downloads only the [B, n_out] F0 grid; "host" downloads
        the [B, F, S] candidate slab and fixes the contour on the host.

        transfer_dtype: optional narrower dtype (e.g. jnp.float16) for the
        host-path candidate/score download — halves transfer bytes at the
        cost of ~5e-4 relative F0 quantization (still far under the 1 Hz
        accuracy target; scores above the f16 range saturate, which only
        reorders near-ties).

        check_capacity: also run zc_capacity_violations_batch and raise
        ZcCapacityError if any band signal exceeds the zc kernel's
        crossing-rate capacity model (pathological inputs otherwise clamp
        silently; ~2% extra device work)."""
        g = self.geo
        contour_on = self._auto_contour(contour_on)
        x_batch = jnp.asarray(x_batch, dtype)
        mean = jnp.zeros((x_batch.shape[0],), dtype)
        if check_capacity and dtype != jnp.float64:
            v = np.asarray(zc_capacity_violations_batch(x_batch, geo=g))
            if v.any():
                bad = np.nonzero(v)[0].tolist()
                raise ZcCapacityError(
                    f"zc event capacity exceeded for utterances {bad}: "
                    f"(band, crossing type) overflow counts "
                    f"{v[bad].tolist()} — the input's band-limited "
                    f"crossing rate is outside Harvest's physical model "
                    f"(is the signal a full-band chirp or noise burst?)")
        if contour_on == "device":
            n_out = self.get_samples()
            f0s = np.asarray(harvest_device_full_batch(
                x_batch, mean, g, n_out, chunk)).astype(np.float64)
            tpos = np.arange(n_out) * g.frame_period / 1000.0
            return [(f0s[i], tpos) for i in range(x_batch.shape[0])]
        k = _grid_for(dtype)
        out = harvest_device_stages_batch(x_batch, mean, g, chunk, None)
        if transfer_dtype is not None:
            out = jnp.clip(
                out, 0.0, float(jnp.finfo(transfer_dtype).max)
            ).astype(transfer_dtype)
        flat = np.asarray(jnp.ravel(out)).astype(np.float64)
        n = 2 * g.with_grid(k).f0_length * g.max_candidates
        return [self._finish(flat[i * n:(i + 1) * n], k)
                for i in range(x_batch.shape[0])]

    def compute_corpus(self, batches, dtype=jnp.float32, chunk=32,
                       transfer_dtype=None, contour_on=None):
        """Pipelined Harvest over an iterable of [B, T] batches: batch k+1's
        device stages are dispatched (async) before batch k's download,
        overlapping downloads/host work with device compute."""
        g = self.geo
        contour_on = self._auto_contour(contour_on)
        if contour_on == "device":
            n_out = self.get_samples()
            tpos = np.arange(n_out) * g.frame_period / 1000.0
            pending = None
            for xb in batches:
                xb = jnp.asarray(xb, dtype)
                mean = jnp.zeros((xb.shape[0],), dtype)
                out = harvest_device_full_batch(xb, mean, g, n_out, chunk)
                if pending is not None:
                    f0s = np.asarray(pending).astype(np.float64)
                    for i in range(f0s.shape[0]):
                        yield f0s[i], tpos
                pending = out
            if pending is not None:
                f0s = np.asarray(pending).astype(np.float64)
                for i in range(f0s.shape[0]):
                    yield f0s[i], tpos
            return
        k = _grid_for(dtype)
        n = 2 * g.with_grid(k).f0_length * g.max_candidates
        pending = None
        for xb in batches:
            xb = jnp.asarray(xb, dtype)
            mean = jnp.zeros((xb.shape[0],), dtype)
            out = harvest_device_stages_batch(xb, mean, g, chunk, None)
            if transfer_dtype is not None:
                out = jnp.clip(
                    out, 0.0, float(jnp.finfo(transfer_dtype).max)
                ).astype(transfer_dtype)
            out = jnp.ravel(out)
            if pending is not None:
                flat = np.asarray(pending).astype(np.float64)
                for i in range(flat.shape[0] // n):
                    yield self._finish(flat[i * n:(i + 1) * n], k)
            pending = out
        if pending is not None:
            flat = np.asarray(pending).astype(np.float64)
            for i in range(flat.shape[0] // n):
                yield self._finish(flat[i * n:(i + 1) * n], k)
