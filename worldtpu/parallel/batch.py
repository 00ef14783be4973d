"""Multi-chip sharding: data-parallel utterance batches + frame-axis
(sequence-parallel analog) sharding over a jax.sharding.Mesh.

The reference's only parallel strategy is OpenMP threads over frames/pulses
inside one address space (SURVEY.md §2 row 14).  The device equivalents:

  dp — utterance batch sharded over the 'data' mesh axis (zero collectives)
  sp — the frame/time axis sharded over the 'time' mesh axis for the
       analysis engines (each frame only needs the replicated waveform, so
       no halo is required; synthesis consumes the frame axis replicated,
       which XLA satisfies with an all-gather between devices)
  tp/pp/ep — not applicable: the vocoder has no weight matrices, layer
       stacks or experts to shard (SURVEY.md §2 rows 14-15)

Batches are padded: utterances to a common T (zero samples) and a common F
(zero = unvoiced frames); callers slice the outputs back to true lengths.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from worldtpu.analysis.cheaptrick import cheaptrick_frames
from worldtpu.analysis.d4c import d4c_frames
from worldtpu.synthesis import synthesis as _syn
from worldtpu.analysis import harvest as _hv


class MeshConfigError(ValueError):
    """Requested mesh shape does not match the available devices."""


def make_mesh(n_data=None, n_time=1, devices=None):
    """Build a ('data', 'time') mesh over the available devices.

    If the requested n_data*n_time factorization doesn't cover the device
    list, degrades to a dp-only mesh over all devices (n_time=1) rather
    than failing — frame-axis sharding is an optimization, data
    parallelism is the contract."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n == 0:
        raise MeshConfigError("no devices available for mesh construction")
    if n_data is None:
        n_data = n // max(n_time, 1)
    if n_data * n_time != n:
        # degrade: dp-only over everything we actually have
        n_data, n_time = n, 1
    arr = np.asarray(devices).reshape(n_data, n_time)
    return Mesh(arr, ("data", "time"))


def _analysis_one(x, f0, tpos, fs, fft_size, max_half_window):
    spec = cheaptrick_frames(
        x, f0, tpos, fs=fs, fft_size=fft_size,
        max_half_window=max_half_window)
    ap = d4c_frames(x, f0, tpos, fs=fs, fft_size_out=fft_size)
    return spec, ap


def _copy_syn_one(x, f0, tpos, noise, fs, fft_size, max_half_window,
                  frame_period_s, out_length, max_pulses):
    spec, ap = _analysis_one(x, f0, tpos, fs, fft_size, max_half_window)
    y = _syn.synthesis_frames_impl(
        f0, spec, ap, noise, fs=fs, fft_size=fft_size,
        frame_period_s=frame_period_s, out_length=out_length,
        max_pulses=max_pulses)
    return y, spec, ap


@functools.partial(
    jax.jit,
    static_argnames=("fs", "fft_size", "max_half_window", "out_length",
                     "max_pulses", "mesh", "return_overflow"))
def batch_copy_synthesis(x, f0, tpos, noise, *, fs, fft_size,
                         max_half_window, frame_period_s, out_length,
                         max_pulses, mesh=None, return_overflow=False):
    """Batched copy-synthesis (analysis from given F0 + resynthesis).

    Args:
        x: [B, T] padded waveforms.
        f0: [B, F] padded F0 contours (0 = unvoiced/padding).
        tpos: [F] shared frame times.
        noise: [B, max_pulses, fft_size] synthesis noise.
        mesh: optional Mesh('data', 'time'); batch is sharded over 'data'
            (dp) and the frame axis of the analysis over 'time' (the
            sequence-parallel analog) via shard_map — each device analyzes
            its frame slab against the replicated-within-data-shard
            waveform, then the frame axis is all-gathered for
            synthesis.

    Returns:
        (y [B, out_length], spec [B, F, K], ap [B, F, K]); with
        ``return_overflow`` a trailing [B] bool marking utterances whose
        true pulse count exceeded the static ``max_pulses`` bound (tail
        pulses dropped — callers resize+rerun, see api.World.copy_synthesis).
    """
    def syn_fn(xb, f0b, nb, specb, apb):
        y, ovf = jax.vmap(lambda fi, si, ai, ni: _syn.synthesis_frames_impl(
            fi, si, ai, ni, fs=fs, fft_size=fft_size,
            frame_period_s=frame_period_s, out_length=out_length,
            max_pulses=max_pulses, return_overflow=True))(
                f0b, specb, apb, nb)
        return (y, ovf) if return_overflow else (y, None)

    if mesh is None:
        spec, ap = jax.vmap(
            lambda xi, fi: _analysis_one(
                xi, fi, tpos, fs, fft_size, max_half_window))(x, f0)
        y, ovf = syn_fn(x, f0, noise, spec, ap)
        return ((y, spec, ap, ovf) if return_overflow
                else (y, spec, ap))

    def local_analysis(x_l, f0_l, tpos_l):
        # local shapes: [B/nd, T], [B/nd, F/nt], [F/nt]
        return jax.vmap(
            lambda xi, fi: _analysis_one(
                xi, fi, tpos_l, fs, fft_size, max_half_window))(x_l, f0_l)

    spec, ap = jax.shard_map(
        local_analysis, mesh=mesh,
        in_specs=(P("data", None), P("data", "time"), P("time")),
        out_specs=(P("data", "time", None), P("data", "time", None)))(
            x, f0, tpos)

    # synthesis consumes the full frame axis: constrain to data-sharded so
    # XLA all-gathers the 'time' axis
    rep = NamedSharding(mesh, P("data", None, None))
    spec_g = jax.lax.with_sharding_constraint(spec, rep)
    ap_g = jax.lax.with_sharding_constraint(ap, rep)
    y, ovf = syn_fn(x, f0, noise, spec_g, ap_g)
    y = jax.lax.with_sharding_constraint(y, NamedSharding(mesh, P("data", None)))
    return (y, spec, ap, ovf) if return_overflow else (y, spec, ap)


@functools.partial(
    jax.jit, static_argnames=("geo", "chunk", "mesh"))
def batch_harvest_device_stages(x, *, geo, mesh, chunk=32):
    """Harvest device stages (decimate -> candidates -> refine -> prune)
    for a [B, T] batch under the ('data', 'time') mesh.

    dp: utterances over 'data'.  Within each data shard the band axis of
    the candidate stage is sharded over 'time' — the device equivalent of the
    reference's OpenMP band loop (/root/reference/src/harvest.cpp:1314-1346)
    — as a STRATIFIED subset (band g lives on shard g % nt) so every shard
    compiles the same kernel geometry; the refinement stage then shards the
    frame axis (the reference's frame loop, :934-943).  Collectives: two
    all-gathers over 'time' (raw candidates, refined slabs).

    Runs the SAME production stages and grid as the single-device
    harvest_device_stages: the shared f32 dedup pre-pass and the
    platform's refine (harvest.refine_production), and the GRID_MS
    candidate grid.  Both the dedup and the refine are frame-local, so
    frame sharding leaves them unchanged.

    Returns [B, 2*Fk*S] flat cand++score rows (same as
    harvest_device_stages per utterance; Fk = geo.with_grid(k).f0_length)."""
    nt = mesh.shape["time"]
    Nb = geo.n_channels
    nbl = -(-Nb // nt)
    dt = x.dtype
    k = _hv._grid_for(dt)
    geo_k = geo.with_grid(k)
    F, S = geo_k.f0_length, geo_k.max_candidates
    fl = -(-F // nt)

    padb = nt * nbl - Nb
    bounds = jnp.pad(jnp.asarray(geo.boundary_f0, dt), (0, padb),
                     constant_values=1.0)
    # stratified interleave: shard t row j <-> global band t + j*nt
    order = (jnp.arange(nt)[:, None] + jnp.arange(nbl)[None, :] * nt)
    bounds_i = bounds[order.reshape(-1)].reshape(nt, nbl)
    Lmax = geo.max_filter_half
    if _hv.CONV_MODE == "matmul":
        # per-shard shifted-kernel banks (blocked-Toeplitz matmul form;
        # see harvest._bank_from_kern_np) as a 'time'-sharded operand —
        # padded bands get zero kernel rows, same as the conv path
        kern_np = _hv._bandpass_kernels_np(geo)         # [Nb, taps]
        kern_np = np.pad(kern_np, ((0, padb), (0, 0)))
        order_np = (np.arange(nt)[:, None] + np.arange(nbl)[None, :] * nt)
        kern_np = kern_np[order_np.reshape(-1)].reshape(nt, nbl, -1)
        banks = [_hv._bank_from_kern_np(kern_np[t]) for t in range(nt)]
        Wb = banks[0][0]
        kern_i = jnp.asarray(np.stack([kb for _, kb in banks]))
        # [nt, 128W, 128*nbl]
    else:
        kern = jnp.pad(_hv._bandpass_kernels(geo, dt), ((0, padb), (0, 0)))
        kern_i = kern[order.reshape(-1)].reshape(nt, nbl, -1)
        Wb = None

    def cell(x_l, kern_s, bounds_s):
        # x_l [Bl, T]; kern_s [1, nbl, taps]; bounds_s [1, nbl]
        kern_s = kern_s[0]
        bounds_s = bounds_s[0]
        tix = jax.lax.axis_index("time")
        tposk = jnp.arange(F, dtype=dt) * (k / 1000.0)

        def one(xi):
            y = _hv.decimate_stage(xi, ratio=geo.ratio,
                                   y_length=geo.y_length)
            if _hv.CONV_MODE == "matmul":
                # same matmul form (and precision) as the single-chip
                # candidates_stage so sharded == unsharded stays bitwise
                filt = _hv._band_filter_matmul_kb(
                    y, kern_s, Wb, Lmax, geo.y_length, dt)
            else:
                ypad = jnp.pad(y, (geo.max_filter_half - 1,
                                   geo.max_filter_half + 1))
                filt = jax.lax.conv_general_dilated(
                    ypad[None, None, :], kern_s[:, None, :],
                    window_strides=(1,), padding="VALID",
                    dimension_numbers=("NCW", "OIW", "NCW"),
                    # same precision as the single-device candidates_stage
                    # so sharded == unsharded holds on an accelerator too
                    precision=jax.lax.Precision.DEFAULT)[0]  # [nbl, y_len]
            raw_l = jax.vmap(
                lambda fi, b: _hv._band_candidates(fi, b, geo_k, tposk))(
                    filt, bounds_s)
            # reassemble the full band axis in global order
            # gathered rows are in (shard t, row j) order; global band
            # index is t + j*nt
            raw_g = jax.lax.all_gather(raw_l, "time", axis=0, tiled=True)
            raw = raw_g.reshape(nt, nbl, -1).transpose(1, 0, 2).reshape(
                nt * nbl, -1)[:Nb]
            base = _hv._detect_candidates(raw, geo_k)
            cand = _hv._overlap_candidates(base)         # [F, S] replicated
            # frame-axis shard for refinement
            cand_p = jnp.pad(cand, ((0, nt * fl - F), (0, 0)))
            tpos_p = jnp.pad(tposk, (0, nt * fl - F))
            c_l = jax.lax.dynamic_slice(
                cand_p, (tix * fl, jnp.zeros((), tix.dtype)), (fl, S))
            t_l = jax.lax.dynamic_slice(tpos_p, (tix * fl,), (fl,))
            if dt == jnp.float32:
                r_l, s_l = _hv.refine_production(y, c_l, t_l, geo=geo_k,
                                                 chunk=chunk)
            else:
                r_l, s_l = _hv.refine_stage(y, c_l, t_l, geo=geo_k,
                                            chunk=chunk)
            r_g = jax.lax.all_gather(
                jnp.stack([r_l, s_l]), "time", axis=1, tiled=True)
            ref, sco = r_g[0, :F], r_g[1, :F]
            ref, sco = _hv.remove_unreliable_stage(ref, sco)
            return jnp.concatenate([ref.reshape(-1), sco.reshape(-1)])

        return jax.vmap(one)(x_l)

    # check_vma=False: the output IS 'time'-replicated (it is produced from
    # all-gathered values), but the static checker cannot infer that through
    # refine_stage; bitwise sharded==unsharded is asserted in tests instead.
    return jax.shard_map(
        cell, mesh=mesh, check_vma=False,
        in_specs=(P("data", None), P("time", None, None), P("time", None)),
        out_specs=P("data", None))(x, kern_i, bounds_i)


@functools.partial(
    jax.jit,
    static_argnames=("geo", "fs", "fft_size", "max_half_window",
                     "frame_period_s", "out_length", "max_pulses", "mesh",
                     "chunk", "return_overflow"))
def batch_wav_to_wav(x, noise, *, geo, fs, fft_size, max_half_window,
                     frame_period_s, out_length, max_pulses, mesh=None,
                     chunk=32, pitch_scale=1.0, return_overflow=False):
    """The flagship ONE-DISPATCH pipeline: [B, T] wavs -> Harvest F0 (with
    on-device contour fixing) -> optional pitch scaling -> CheapTrick +
    D4C -> synthesis -> [B, out_length] wavs.  F0 never leaves the device;
    duration modification is the frame_period_s at synthesis (reference
    test.cpp's ParameterModification analog).  mesh=None runs single-chip;
    a ('data','time') mesh shards it (dp x sp + band-parallel Harvest).
    ``return_overflow`` appends a [B] bool of pulse-bound overflows so a
    production stream sized by synthesis.capacity_max_pulses self-checks
    (see that docstring)."""
    from worldtpu.analysis import harvest as _h

    n_grid = 1 + int(1000.0 * geo.x_length / geo.fs / geo.frame_period)
    if mesh is None:
        mean = jnp.zeros((x.shape[0],), x.dtype)
        f0 = _h.harvest_device_full_batch(x, mean, geo, n_grid, chunk)
    else:
        f0 = batch_harvest_f0(x, geo=geo, n_out=n_grid, mesh=mesh,
                              chunk=chunk)
    F = f0.shape[1]
    f0 = (f0 * pitch_scale).astype(x.dtype)
    if mesh is not None:
        # frame axis must divide the 'time' mesh axis; padded frames are
        # unvoiced and synthesize nothing inside out_length
        nt = mesh.shape["time"]
        f0 = jnp.pad(f0, ((0, 0), (0, (-F) % nt)))
        F = f0.shape[1]
    tpos = (jnp.arange(F, dtype=x.dtype)
            * (geo.frame_period / 1000.0))
    outs = batch_copy_synthesis(
        x, f0, tpos, noise, fs=fs, fft_size=fft_size,
        max_half_window=max_half_window, frame_period_s=frame_period_s,
        out_length=out_length, max_pulses=max_pulses, mesh=mesh,
        return_overflow=return_overflow)
    if return_overflow:
        y, _, _, ovf = outs
        return y, f0[:, :n_grid], ovf
    y = outs[0]
    return y, f0[:, :n_grid]


@functools.partial(
    jax.jit,
    static_argnames=("geo", "fs", "fft_size", "max_half_window", "mesh",
                     "chunk"))
def batch_analyze(x, *, geo, fs, fft_size, max_half_window, mesh=None,
                  chunk=32, pitch_scale=1.0):
    """Fused one-dispatch analysis: [B, T] wavs -> (f0 [B, F], spec
    [B, F, K], ap [B, F, K]) — Harvest (with on-device contour fixing) +
    CheapTrick + D4C as ONE program, so a single utterance pays one
    dispatch + one download instead of per-stage round trips (the
    reference demo's four-stage workflow, /root/reference/test/test.cpp:
    288-384, where each stage is a separate call)."""
    from worldtpu.analysis import harvest as _h

    n_grid = 1 + int(1000.0 * geo.x_length / geo.fs / geo.frame_period)
    if mesh is None:
        mean = jnp.zeros((x.shape[0],), x.dtype)
        f0 = _h.harvest_device_full_batch(x, mean, geo, n_grid, chunk)
    else:
        f0 = batch_harvest_f0(x, geo=geo, n_out=n_grid, mesh=mesh,
                              chunk=chunk)
    f0 = (f0 * pitch_scale).astype(x.dtype)
    tpos = jnp.arange(n_grid, dtype=x.dtype) * (geo.frame_period / 1000.0)
    if mesh is None:
        spec, ap = jax.vmap(
            lambda xi, fi: _analysis_one(
                xi, fi, tpos, fs, fft_size, max_half_window))(x, f0)
    else:
        def local_analysis(x_l, f0_l, tpos_l):
            return jax.vmap(
                lambda xi, fi: _analysis_one(
                    xi, fi, tpos_l, fs, fft_size, max_half_window))(
                        x_l, f0_l)
        spec, ap = jax.shard_map(
            local_analysis, mesh=mesh,
            in_specs=(P("data", None), P("data", None), P(None)),
            out_specs=(P("data", None, None), P("data", None, None)))(
                x, f0, tpos)
    return f0, spec, ap


@functools.partial(
    jax.jit, static_argnames=("geo", "n_out", "chunk", "mesh"))
def batch_harvest_f0(x, *, geo, n_out, mesh, chunk=32):
    """Full sharded Harvest wav -> frame-period F0 [B, n_out]: the device
    stages under the mesh (batch_harvest_device_stages) followed by the
    on-device contour chain (analysis.contour_device), data-parallel per
    utterance.  With this the whole wav->wav pipeline runs on device under
    the mesh — no host round trip between Harvest and synthesis."""
    from worldtpu.analysis import contour_device as CDV
    flat = batch_harvest_device_stages(x, geo=geo, mesh=mesh, chunk=chunk)
    k = _hv._grid_for(x.dtype)
    geo_k = geo.with_grid(k)
    F, S = geo_k.f0_length, geo_k.max_candidates
    cand = flat[:, :F * S].reshape(-1, F, S)
    score = flat[:, F * S:].reshape(-1, F, S)
    f0 = jax.vmap(
        lambda c, s: CDV.fix_and_smooth(c, s, n_out, geo.frame_period,
                                        grid_ms=k))(cand, score)
    if mesh is not None:
        f0 = jax.lax.with_sharding_constraint(
            f0, NamedSharding(mesh, P("data", None)))
    return f0


def pad_batch(waves, fs, frame_period_ms=5.0):
    """Pad a list of 1-D waveforms to a [B, T] batch + frame geometry.

    Returns (x [B,T], lengths, n_frames_per_utt, F, out_length)."""
    lengths = np.array([len(w) for w in waves])
    T = int(lengths.max())
    B = len(waves)
    x = np.zeros((B, T), dtype=np.asarray(waves[0]).dtype)
    for i, w in enumerate(waves):
        x[i, :len(w)] = w
    n_frames = (1000.0 * lengths / fs / frame_period_ms).astype(int) + 1
    F = int(n_frames.max())
    out_length = int((F - 1) * frame_period_ms / 1000.0 * fs) + 1
    return x, lengths, n_frames, F, out_length
