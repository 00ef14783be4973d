"""Full long-audio pipeline: wav -> wav in bounded memory for arbitrarily
long single utterances.

The reference handles any duration with O(1)-per-frame memory: CheapTrick
loops one frame at a time (/root/reference/src/cheaptrick.cpp:64-88), D4C
likewise (/root/reference/src/d4c.cpp:143-169) and Synthesis streams pulse
responses into the output (/root/reference/src/synthesis.cpp:77-177).  The
batched device programs instead materialize [F, K] slabs and a
[max_pulses, fft_size] response slab — fine for utterances, fatal for a
10-minute recording (F ~ 120k x K ~ 1025 ~ GBs).

This module composes the chunked pieces into one streaming pipeline with a
single compiled chunk geometry:

  - F0: analysis.longform.LongHarvest (overlap-save chunked Harvest).
  - Envelope/aperiodicity: frame-blocked CheapTrick + D4C — each block
    sees an audio slice with a halo covering the widest analysis window
    (interior frames are then exact).
  - Synthesis: output chunked on the sample axis.  The Q32 phase
    accumulator is carried across chunks (bitwise-identical pulse
    placement to the unchunked cumsum), each chunk detects one extra
    period of lookahead pulses so the noise_size of its last owned pulse
    matches the unchunked rule, responses are overlap-added into a local
    buffer of chunk + fft_size samples, and the host accumulates buffers
    (halo = fft_size, reference OLA :118-139).  Noise is counter-based
    per GLOBAL pulse ordinal (synthesis.indexed_noise) so the waveform is
    invariant to the chunk size.

Memory: O(chunk) device, O(output) host.  tests/test_longaudio.py proves
a 60 s utterance equals the unchunked batched pipeline up to the
cross-compilation pulse-timing wobble documented there (envelope exact to
~0.05%, voiced spans sample-aligned).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from worldtpu import constants as C
from worldtpu.analysis.cheaptrick import (
    CheapTrickKernel, cheaptrick_frames)
from worldtpu.analysis.d4c import d4c_frames, d4c_max_half_c, d4c_max_half_lt
from worldtpu.analysis.longform import LongHarvest
from worldtpu.ops.interp import interp1
from worldtpu.synthesis import synthesis as S


def analysis_halo_samples(fs, f0_floor):
    """Widest temporal reach of any CheapTrick/D4C window around a frame:
    CheapTrick +-1.5 periods at its effective floor, D4C main loop +-2
    periods at kFloorF0D4C, LoveTrain +-1.5 periods at 40 Hz."""
    ct = int(1.5 * fs / min(f0_floor, C.FLOOR_F0) + 0.5)
    return max(ct, d4c_max_half_c(fs), d4c_max_half_lt(fs)) + 8


def _timebase_core(f0_blk, o0, flo, carry, *, dt, fs, fft_size, fp_s, L,
                   slack, Fb, Pmax, out_length, Fg=None):
    """Q32 pulse detection for one chunk (reference :180-288 with carried
    phase).  Returns everything both the prescan and the synthesis need.

    ``Fg``: GLOBAL coarse-knot count (the unchunked f0 length).  The f32
    segment lookup uses the same global uniform-grid formula as
    synthesis._time_base — global t, global k — evaluated on the local
    block, so the chunked pulse train is BITWISE equal to the unchunked
    one.  (interp1 on locally-shifted times rounds knife edges
    differently; ONE extra/missing pulse at a V/UV boundary permanently
    shifts every later counter-based noise ordinal — observed as a 40%
    rel-RMS divergence from a single silence gap.)"""
    lowest_f0 = fs / fft_size + 1.0
    cf0 = jnp.where(f0_blk < lowest_f0, 0.0, f0_blk)
    cvuv = jnp.where(cf0 == 0.0, 0.0, 1.0)
    # appended extrapolation knot (reference :240-242); only queried when
    # the block's last frame is the utterance's last
    cf0 = jnp.concatenate([cf0, (cf0[-1] * 2 - cf0[-2])[None]])
    cvuv = jnp.concatenate([cvuv, (cvuv[-1] * 2 - cvuv[-2])[None]])
    coarse_t = jnp.arange(Fb + 1, dtype=dt) * fp_s

    s = jnp.arange(L + slack)
    if dt == jnp.float64 or Fg is None:
        t_loc = (o0 + s).astype(dt) / fs - flo.astype(dt) * fp_s
        f0i = interp1(coarse_t, cf0, t_loc)
        vuvi = interp1(coarse_t, cvuv, t_loc)
    else:
        tg = (o0 + s).astype(dt) / fs       # global times, bitwise equal
        kg = jnp.clip((tg / fp_s).astype(jnp.int32) + 1, 1, Fg)
        kl = jnp.clip(kg - flo, 1, Fb)
        x0 = kg.astype(dt) * fp_s - fp_s
        sf = (tg - x0) / fp_s
        f0_lo, f0_hi = jnp.take(cf0, kl - 1), jnp.take(cf0, kl)
        v_lo, v_hi = jnp.take(cvuv, kl - 1), jnp.take(cvuv, kl)
        f0i = f0_lo + sf * (f0_hi - f0_lo)
        vuvi = v_lo + sf * (v_hi - v_lo)
    vuvi = jnp.where(vuvi > 0.5, 1.0, 0.0)
    f0i = jnp.where(vuvi == 0.0, C.DEFAULT_F0, f0i)

    step = (f0i / fs * 4294967296.0 + 0.5).astype(jnp.uint32)
    cum = carry.astype(jnp.int32) + jnp.cumsum(step.astype(jnp.int32))
    fbits = jax.lax.bitcast_convert_type(cum, jnp.uint32)
    carry_out = fbits[L - 1]
    wrap = fbits[1:] < fbits[:-1]
    # comparisons beyond the true output end do not exist (unchunked
    # semantics: the global last pulse's noise_size is 0 via the min rule)
    glob = o0 + s[:-1]
    wrap = wrap & (glob + 1 <= out_length - 1)

    idx = jnp.nonzero(wrap, size=Pmax,
                      fill_value=L + slack - 1)[0].astype(jnp.int32)
    n_det = jnp.minimum(jnp.sum(wrap).astype(jnp.int32), Pmax)
    det_valid = jnp.arange(Pmax) < n_det
    own = det_valid & (idx < jnp.minimum(L, out_length - o0))
    n_own = jnp.sum(own).astype(jnp.int32)
    overflowed = (jnp.sum(wrap) > Pmax) | (
        n_own == Pmax)  # lookahead pulse must also fit
    return dict(f0i=f0i, vuvi=vuvi, fbits=fbits, carry_out=carry_out,
                idx=idx, n_det=n_det, own=own, n_own=n_own,
                overflowed=overflowed)


@functools.partial(
    jax.jit,
    static_argnames=("fs", "fft_size", "fp_s", "L", "slack", "Fb", "Pmax",
                     "out_length", "n_chunks"))
def _phase_prescan(f0_full, *, fs, fft_size, fp_s, L, slack, Fb, Pmax,
                   out_length, n_chunks):
    """Sequential-in-one-dispatch scan producing each chunk's entry state
    (Q32 carry, global pulse ordinal) plus the overflow flags — the cheap
    pass that makes the expensive chunks independent."""
    dt = f0_full.dtype

    def step(st, k):
        carry, ordn = st
        o0 = k * L
        F_pad = f0_full.shape[0]
        flo = jnp.clip((o0 / (fs * fp_s)).astype(jnp.int32) - 2, 0,
                       F_pad - Fb)
        f0_blk = jax.lax.dynamic_slice(f0_full, (flo,), (Fb,))
        tb = _timebase_core(f0_blk, o0, flo, carry, dt=dt, fs=fs,
                            Fg=F_pad - Fb,
                            fft_size=fft_size, fp_s=fp_s, L=L, slack=slack,
                            Fb=Fb, Pmax=Pmax, out_length=out_length)
        return ((tb["carry_out"], ordn + tb["n_own"]),
                (carry, ordn, tb["overflowed"]))

    (_, _), (carries, ords, ovf) = jax.lax.scan(
        step, (jnp.zeros((), jnp.uint32), jnp.zeros((), jnp.int32)),
        jnp.arange(n_chunks, dtype=jnp.int32))
    return carries, ords, ovf


@functools.partial(
    jax.jit,
    static_argnames=("fs", "fft_size", "max_half_window", "fp_a", "fp_s",
                     "L", "slack", "Fb", "Pmax", "A", "halo",
                     "out_length"))
def _chunk_step(x_pad, f0_full, k, carry, ord0, key, *, fs, fft_size,
                max_half_window, fp_a, fp_s, L, slack, Fb, Pmax, A, halo,
                out_length):
    """One streaming chunk: frame-blocked CheapTrick+D4C analysis + carried
    synthesis, a single dispatch.

    Args:
        x_pad: [halo + T + tail] the full input, edge-padded by `halo`
            zeros on the left (analysis audio slices index into it).
        f0_full: [F_pad] full 5-ms-grid F0 (edge-padded), pitch scaling
            already applied.
        k: chunk index (traced scalar).
        carry: uint32 Q32 phase accumulator at the last sample of the
            previous chunk.
        ord0: int32 global pulse ordinal at chunk start.
        key: PRNG key for counter-based noise.
        L: output samples owned per chunk;  slack: lookahead samples
            (>= one period at the synthesis lowest_f0, + 1 for the
            boundary phase comparison).
        Fb: frames per analysis block;  A: audio samples per block slice;
        halo: analysis halo (samples).

    Returns:
        (buf [L + fft_size], carry', ord0', overflowed)
        buf[j] belongs at global output sample  k*L - fft_size//2 + 1 + j.
    """
    dt = x_pad.dtype
    half = fft_size // 2
    F_pad = f0_full.shape[0]
    o0 = k * L

    # ---- frame block selection ----
    # block frames [flo, flo+Fb) must cover synthesis interp for pulses in
    # [o0, o0 + L + slack) AND the analysis frames of those times
    flo = jnp.clip((o0 / (fs * fp_s)).astype(jnp.int32) - 2, 0, F_pad - Fb)
    f0_blk = jax.lax.dynamic_slice(f0_full, (flo,), (Fb,))

    # ---- analysis slice (frame times are on the ANALYSIS period) ----
    t0_blk = flo.astype(dt) * fp_a                     # first frame time
    a0 = jnp.floor(t0_blk * fs).astype(jnp.int32) - halo
    x_blk = jax.lax.dynamic_slice(x_pad, (a0 + halo,), (A,))
    tpos_blk = (flo + jnp.arange(Fb)).astype(dt) * fp_a - a0.astype(dt) / fs

    spec = cheaptrick_frames(x_blk, f0_blk, tpos_blk, fs=fs,
                             fft_size=fft_size,
                             max_half_window=max_half_window)
    ap = d4c_frames(x_blk, f0_blk, tpos_blk, fs=fs, fft_size_out=fft_size)

    # ---- chunked time base (reference :180-288 with carried phase) ----
    tb = _timebase_core(f0_blk, o0, flo, carry, dt=dt, fs=fs,
                        fft_size=fft_size, fp_s=fp_s, L=L, slack=slack,
                        Fb=Fb, Pmax=Pmax, out_length=out_length,
                        Fg=F_pad - Fb)
    fbits, idx, n_det = tb["fbits"], tb["idx"], tb["n_det"]
    own, n_own = tb["own"], tb["n_own"]
    vuvi = tb["vuvi"]
    carry_out = tb["carry_out"]
    overflowed = tb["overflowed"]

    frac = fbits.astype(dt) / 4294967296.0
    f_lo = jnp.take(frac, idx)
    f_hi = jnp.take(frac, jnp.minimum(idx + 1, L + slack - 1))
    shift = (1.0 - f_lo) / (f_hi + 1.0 - f_lo) / fs
    vuv_at = jnp.take(vuvi, idx)

    nxt = jnp.minimum(jnp.arange(Pmax) + 1, n_det - 1)
    ns = jnp.take(idx, nxt) - idx
    ns = jnp.where(own, ns, 0)

    noise = S.indexed_noise(key, ord0, Pmax, fft_size, dt)
    # GLOBAL fractional frame position (identical float ops to the
    # unchunked path) + integer block offset: floor/ceil/frac then match
    # bitwise — a locally-rebased pt flipped frame selection at knife
    # edges and decorrelated noise-region responses (r5 bug fix)
    pt = (o0 + idx).astype(dt) / fs / fp_s
    resp = S.pulse_responses(pt, shift, ns, vuv_at, own, spec, ap, noise,
                             fs=fs, fft_size=fft_size, frame_offset=flo)

    # ---- OLA into the local buffer (reference :118-139) ----
    # pulse at local sample idx writes [idx - half + 1, idx + half]; buffer
    # position j <-> local sample j - half + 1.  Masked fill rows are all
    # zero but must still target in-range offsets.
    idx = jnp.where(own, idx, 0)
    j = jnp.arange(fft_size)
    target = idx[:, None] + j[None, :]
    ok = (target < L + fft_size) & own[:, None]
    flat_t = jnp.where(ok, target, L + fft_size).reshape(-1)
    flat_v = jnp.where(ok, resp, 0.0).reshape(-1)
    buf = jnp.zeros(L + fft_size + 1, dtype=dt).at[flat_t].add(
        flat_v)[:L + fft_size]
    return buf, carry_out, ord0 + n_own, overflowed


@functools.partial(
    jax.jit,
    static_argnames=("fs", "fft_size", "max_half_window", "fp_a", "fp_s",
                     "L", "slack", "Fb", "Pmax", "A", "halo", "out_length"))
def _chunks_map(x_pad, f0_full, ks, carries, ords, key, *, fs, fft_size,
                max_half_window, fp_a, fp_s, L, slack, Fb, Pmax, A, halo,
                out_length):
    """All chunks in ONE dispatch: lax.map keeps device memory at one
    chunk's intermediates while the output is the [n, L+fft] buffer stack.
    Entry states come from _phase_prescan, so chunks are independent."""

    def one(args):
        k, carry, ordn = args
        buf, _, _, ovf = _chunk_step(
            x_pad, f0_full, k, carry, ordn, key, fs=fs, fft_size=fft_size,
            max_half_window=max_half_window, fp_a=fp_a, fp_s=fp_s, L=L,
            slack=slack, Fb=Fb, Pmax=Pmax, A=A, halo=halo,
            out_length=out_length)
        return buf, ovf

    return jax.lax.map(one, (ks, carries, ords))


class LongPipeline:
    """Streaming copy-synthesis for arbitrarily long utterances.

    One compiled chunk geometry serves any input length; device memory is
    O(chunk_frames), host memory O(output).

    Args:
        fs: sample rate.
        frame_period: analysis frame period (ms).
        chunk_frames: synthesis-output chunk length in frames (~5 s at the
            default 1000).
        f0_floor / f0_ceil: Harvest range (floor also sizes the CheapTrick
            geometry like api.CheapTrick does for the CLI).
        harvest_chunk_ms / harvest_halo_ms: LongHarvest chunking.
    """

    def __init__(self, fs, *, frame_period=5.0, chunk_frames=1000,
                 f0_floor=C.FLOOR_F0, f0_ceil=C.CEIL_F0,
                 harvest_chunk_ms=8000, harvest_halo_ms=1000):
        self.fs = fs
        self.frame_period = frame_period
        self.chunk_frames = int(chunk_frames)
        self.f0_floor = f0_floor
        self.harvest = LongHarvest(
            fs, chunk_ms=harvest_chunk_ms, halo_ms=harvest_halo_ms,
            frame_period=frame_period, f0_floor=f0_floor, f0_ceil=f0_ceil)
        ck = CheapTrickKernel(fs)
        self.fft_size = ck.fft_size
        self.max_half_window = ck.max_half_window
        self.halo = analysis_halo_samples(fs, f0_floor)

    def copy_synthesis(self, x, *, key=None, pitch_scale=1.0,
                       duration_scale=1.0, dtype=jnp.float32,
                       on_overflow="raise", parallel=False, mesh=None):
        """wav -> wav.  Returns (y [out_length], f0 [n_frames]).

        ``duration_scale`` stretches the synthesis frame period (the
        streaming analog of bench config 5's manipulation).
        ``on_overflow``: 'raise' or 'warn' when a chunk's pulse bound is
        exceeded (cannot happen for f0 <= 1.2 * DEFAULT_F0 ceilings with
        the default margin).

        ``parallel`` / ``mesh``: the Q32 phase and pulse ordinal each
        chunk starts from are the only sequential state; a cheap device
        prescan (one lax.scan over the F0 grid, no analysis/synthesis)
        computes them for every chunk, after which the expensive chunks
        are INDEPENDENT.  parallel=True runs them as one lax.map dispatch
        (same memory bound, no per-chunk host round trips); mesh=Mesh
        additionally shards the chunk axis across devices (shard_map), so
        a single long utterance scales over several devices — the overlap-save
        halo makes each chunk self-contained (SURVEY §5 long-context row).
        Results are bitwise-identical to the sequential path by
        construction (the prescan reuses _timebase_core)."""
        if key is None:
            key = jax.random.PRNGKey(0)
        fs = self.fs
        fp_a = self.frame_period / 1000.0
        fp_s = fp_a * float(duration_scale)

        f0_np, _ = self.harvest.compute(x, dtype=dtype)
        f0_np = np.asarray(f0_np, np.float64) * pitch_scale
        F_total = len(f0_np)
        out_length = int((F_total - 1) * fp_s * fs) + 1

        fft = self.fft_size
        half = fft // 2
        L = max(1, int(round(self.chunk_frames * fp_s * fs)))
        # lookahead: one period at the synthesis lowest_f0 (= fs/fft + 1,
        # so < fft samples) + the boundary comparison sample
        slack = fft + 2
        n_chunks = max(1, -(-out_length // L))

        # frame block: covers chunk + slack pulses (+2 guard each side)
        Fb = int((L + slack) / (fs * fp_s)) + 6
        Fb = min(Fb, F_total + 4)
        F_pad = F_total + Fb  # edge-pad so dynamic_slice stays in range
        f0_pad = np.concatenate(
            [f0_np, np.full(F_pad - F_total, f0_np[-1])])
        # block audio slice: frames span (Fb-1)*fp_a s + halo each side
        A = int(np.ceil((Fb - 1) * fp_a * fs)) + 2 * self.halo + 2

        x = np.asarray(x)
        T = len(x)
        need = A + int(np.ceil((F_pad - Fb) * fp_a * fs)) + 1
        x_pad = np.zeros(self.halo + max(need, T + self.halo), x.dtype)
        x_pad[self.halo:self.halo + T] = x

        x_dev = jax.device_put(jnp.asarray(x_pad, dtype))
        f0_dev = jax.device_put(jnp.asarray(f0_pad, dtype))

        # pulse bound per chunk: cycles at the fastest rate over L + slack
        max_rate = max(float(np.max(f0_np)), C.DEFAULT_F0)
        Pmax = int((L + slack) / fs * max_rate * 1.2) + 16
        Pmax = -(-Pmax // 128) * 128

        y = np.zeros(out_length + fft, np.float64)

        def land(kk, b):
            o0 = kk * L
            lo = o0 - half + 1
            b = np.asarray(b, np.float64)
            if lo < 0:
                b = b[-lo:]
                lo = 0
            hi = min(lo + len(b), len(y))
            y[lo:hi] += b[:hi - lo]

        statics = dict(fs=fs, fft_size=fft,
                       max_half_window=self.max_half_window, fp_a=fp_a,
                       fp_s=fp_s, L=L, slack=slack, Fb=Fb, Pmax=Pmax, A=A,
                       halo=self.halo, out_length=out_length)

        if parallel or mesh is not None:
            carries, ords, ovf_scan = _phase_prescan(
                f0_dev, fs=fs, fft_size=fft, fp_s=fp_s, L=L, slack=slack,
                Fb=Fb, Pmax=Pmax, out_length=out_length,
                n_chunks=n_chunks)
            nmap = n_chunks
            if mesh is not None:
                nd = int(np.prod(mesh.devices.shape))
                nmap = -(-n_chunks // nd) * nd
            # pad chunks: k >= n_chunks has every wrap masked out by the
            # out_length bound (glob+1 <= out_length-1 is False past the
            # end), so padded chunks synthesize silence
            ks = jnp.arange(nmap, dtype=jnp.int32)
            pad = nmap - n_chunks
            carries = jnp.pad(carries, (0, pad))
            ords = jnp.pad(ords, (0, pad))
            if mesh is None:
                bufs, ovf_map = _chunks_map(x_dev, f0_dev, ks, carries,
                                            ords, key, **statics)
            else:
                from jax.sharding import PartitionSpec as P
                ax = mesh.axis_names[0]
                fn = jax.shard_map(
                    lambda xp, ff, kk, cc, oo: _chunks_map(
                        xp, ff, kk, cc, oo, key, **statics),
                    mesh=mesh,
                    in_specs=(P(), P(), P(ax), P(ax), P(ax)),
                    out_specs=(P(ax), P(ax)),
                    check_vma=False)
                bufs, ovf_map = jax.jit(fn)(x_dev, f0_dev, ks, carries,
                                            ords)
            bufs_np = np.asarray(bufs)
            for k in range(n_chunks):
                land(k, bufs_np[k])
            any_ovf = bool(jnp.any(ovf_scan)) or bool(
                jnp.any(ovf_map[:n_chunks]))
        else:
            carry = jnp.zeros((), jnp.uint32)
            ord0 = jnp.zeros((), jnp.int32)
            pending = None  # (k, device buf) for overlapped download
            overflow_flags = []
            for k in range(n_chunks):
                buf, carry, ord0, ovf = _chunk_step(
                    x_dev, f0_dev, jnp.asarray(k, jnp.int32), carry, ord0,
                    key, **statics)
                buf.copy_to_host_async()
                overflow_flags.append(ovf)
                if pending is not None:
                    land(*pending)
                pending = (k, buf)
            land(*pending)
            any_ovf = bool(jnp.any(jnp.stack(overflow_flags)))

        if any_ovf:
            msg = ("pulse bound exceeded in a synthesis chunk; rerun with "
                   "a larger chunk margin")
            if on_overflow == "raise":
                raise RuntimeError(msg)
            import warnings
            warnings.warn(msg)
        return y[:out_length].astype(np.asarray(x).dtype), f0_np
