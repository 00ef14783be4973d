"""Command-line interface: analyze / synthesize / copy-syn.

Mirrors the reference demo workflow (/root/reference/test/test.cpp:288-384):
wav -> Harvest -> CheapTrick -> D4C -> [f0 scale / formant stretch] ->
Synthesis -> wav, with the same per-stage init/compute timing printout and
byte-compatible parameter files for interop with the C++ world.

Usage:
    python -m worldtpu.cli copy-syn in.wav out.wav [--f0-scale S] [--formant-scale R]
    python -m worldtpu.cli analyze in.wav prefix      # writes prefix.{f0,spec,ap}
    python -m worldtpu.cli synthesize prefix out.wav
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


_METRICS = None  # set by main() when --metrics-json is given


def _timed(label, fn, *args, _stage=None, **kw):
    t0 = time.time()
    out = fn(*args, **kw)
    try:
        import jax
        jax.block_until_ready(out)
    except Exception:
        pass
    dt = time.time() - t0
    print(f"\t {label}:\t{dt * 1000:.3f} [msec]")
    if _METRICS is not None and _stage:
        _METRICS.add(_stage, dt)
    return out


def _analyze(x, fs, frame_period, f0_floor, dtype):
    import jax.numpy as jnp
    from worldtpu import api

    print("\nF0 estimation (Harvest)")
    hopt = api.HarvestOption(frame_period=frame_period, f0_floor=f0_floor)
    t0 = time.time()
    harvest = api.Harvest(fs, hopt)
    kern = harvest._kernel(len(x))
    print(f"\t initialize:\t{(time.time() - t0) * 1000:.3f} [msec]")
    tpos, f0 = _timed("compute", harvest.compute, x, dtype=dtype,
                      _stage="harvest")

    print("\nSpectral envelope estimation (CheapTrick)")
    t0 = time.time()
    cheaptrick = api.CheapTrick(fs)
    print(f"\t initialize:\t{(time.time() - t0) * 1000:.3f} [msec]")
    spec = _timed("compute", cheaptrick.compute, x, tpos, f0, dtype=dtype,
                  _stage="cheaptrick")

    print("\nAperiodicity estimation (D4C)")
    t0 = time.time()
    d4c = api.D4C(fs)
    print(f"\t initialize:\t{(time.time() - t0) * 1000:.3f} [msec]")
    ap = _timed("compute", d4c.compute, x, tpos, f0, cheaptrick.fft_size,
                dtype=dtype, _stage="d4c")
    return tpos, f0, np.asarray(spec), np.asarray(ap), cheaptrick.fft_size


def _modify(f0, spec, fs, fft_size, f0_scale, formant_scale):
    """Reference ParameterModification (/root/reference/test/test.cpp:201-243)."""
    f0 = f0 * f0_scale
    if formant_scale == 1.0:
        return f0, spec
    import jax
    import jax.numpy as jnp
    from worldtpu.ops.interp import interp1
    k = fft_size // 2 + 1
    freq1 = formant_scale * np.arange(k) / fft_size * fs
    freq2 = np.arange(k, dtype=float) / fft_size * fs
    logsp = jnp.log(jnp.asarray(spec))
    warped = jax.vmap(lambda v: interp1(
        jnp.asarray(freq1), v, jnp.asarray(freq2)))(logsp)
    out = np.exp(np.asarray(warped))
    if formant_scale < 1.0:
        cut = int(fft_size / 2.0 * formant_scale)
        out[:, cut:] = out[:, cut - 1:cut]
    return f0, out


def _synthesize(f0, spec, ap, fs, fft_size, frame_period, dtype, seed=0):
    import jax
    from worldtpu import api
    print("\nSynthesis")
    out_length = int((len(f0) - 1) * frame_period / 1000.0 * fs) + 1
    t0 = time.time()
    syn = api.Synthesis(fs, fft_size, frame_period)
    print(f"\t initialize:\t{(time.time() - t0) * 1000:.3f} [msec]")
    y = _timed("compute", syn.compute, f0, spec, ap, out_length,
               key=jax.random.PRNGKey(seed), dtype=dtype,
               _stage="synthesis")
    return np.asarray(y)


def _run_fused(args, x, fs, profile_region):
    """--fused: the whole workflow as one device program (api.World)."""
    from worldtpu import api
    from worldtpu.io import params, wav

    world = api.World(fs, frame_period=args.frame_period,
                      f0_floor=args.f0_floor)
    t0 = time.time()
    with profile_region():
        if args.command == "analyze" or args.formant_scale != 1.0:
            tpos, f0, spec, ap = world.analyze(
                x, pitch_scale=args.f0_scale)
            if args.command == "analyze":
                print(f"\nfused analyze:\t{(time.time()-t0)*1000:.3f} [msec]")
                params.write_f0(args.output + ".f0", f0, args.frame_period)
                params.write_spectral_envelope(
                    args.output + ".spec", spec, fs, args.frame_period,
                    world.fft_size)
                params.write_aperiodicity(
                    args.output + ".ap", ap, fs, args.frame_period,
                    world.fft_size)
                print(f"wrote {args.output}.{{f0,spec,ap}}")
                return 0
            # formant warp needs the spectra on host: warp then synthesize
            f0, spec = _modify(f0, spec, fs, world.fft_size, 1.0,
                               args.formant_scale)
            y = _synthesize(f0, spec, ap, fs, world.fft_size,
                            args.frame_period, None, args.seed)
        else:
            y, f0 = world.copy_synthesis(
                x, pitch_scale=args.f0_scale, key=None)
    print(f"\nfused copy-syn:\t{(time.time()-t0)*1000:.3f} [msec]")
    if args.profile:
        print(f"wrote jax.profiler trace to {args.profile}")
    wav.wavwrite(args.output, y, fs)
    print(f"wrote {args.output}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="worldtpu")
    p.add_argument("command", choices=["analyze", "synthesize", "copy-syn"])
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--frame-period", type=float, default=5.0)
    p.add_argument("--f0-floor", type=float, default=40.0,
                   help="Harvest f0 floor (the reference demo uses 40)")
    p.add_argument("--f0-scale", type=float, default=1.0)
    p.add_argument("--formant-scale", type=float, default=1.0)
    p.add_argument("--f32", action="store_true",
                   help="float32 compute (the production path)")
    p.add_argument("--platform", default=None,
                   help="jax platform override (cpu / cuda)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics-json", default=None,
                   help="write per-stage structured metrics (wall_s, rtf, "
                        "frames) as one JSON document to this path")
    p.add_argument("--fused", action="store_true",
                   help="run analysis (and copy-syn resynthesis) as ONE "
                        "fused device program (api.World) instead of "
                        "per-stage calls, each of which pays a dispatch "
                        "and a download; implies --f32, prints one "
                        "combined timing")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler device trace of the "
                        "compute region into DIR (view with TensorBoard "
                        "or xprof; the device-time analog of the "
                        "reference's per-stage chrono printout, "
                        "/root/reference/test/test.cpp:36-45)")
    args = p.parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from worldtpu.runtime import setup_compile_cache
    setup_compile_cache()
    dtype = None
    import jax.numpy as jnp
    if args.f32:
        dtype = jnp.float32
    else:
        jax.config.update("jax_enable_x64", True)
        dtype = jnp.float64

    from worldtpu.io import params, wav

    global _METRICS
    if args.metrics_json:
        from worldtpu.metrics import MetricsRecorder
        _METRICS = MetricsRecorder()

    import contextlib

    def profile_region():
        if args.profile:
            return jax.profiler.trace(args.profile)
        return contextlib.nullcontext()

    if args.command in ("analyze", "copy-syn"):
        x, fs, nbit = wav.wavread(args.input)
        print("File information")
        print(f"Sampling : {fs} [Hz] {nbit} [Bit]")
        print(f"Length {len(x)} [sample]")
        print(f"Length {len(x) / fs} [sec]")
        if args.fused:
            return _run_fused(args, x, fs, profile_region)
        with profile_region():
            tpos, f0, spec, ap, fft_size = _analyze(
                x, fs, args.frame_period, args.f0_floor, dtype)
            if args.command == "copy-syn":
                f0, spec = _modify(f0, spec, fs, fft_size,
                                   args.f0_scale, args.formant_scale)
                y = _synthesize(f0, spec, ap, fs, fft_size,
                                args.frame_period, dtype, args.seed)
        if args.profile:
            print(f"wrote jax.profiler trace to {args.profile}")
        if args.command == "analyze":
            params.write_f0(args.output + ".f0", f0, args.frame_period)
            params.write_spectral_envelope(
                args.output + ".spec", spec, fs, args.frame_period, fft_size)
            params.write_aperiodicity(
                args.output + ".ap", ap, fs, args.frame_period, fft_size)
            print(f"\nwrote {args.output}.{{f0,spec,ap}}")
            return 0
        wav.wavwrite(args.output, y, fs)
        print(f"\nwrote {args.output}")
        if _METRICS is not None:
            _METRICS.audio_s = len(x) / fs
            for m in _METRICS.entries:
                m.audio_s = _METRICS.audio_s
                m.frames = len(f0)
            _METRICS.emit_json(args.metrics_json)
            print(f"wrote {args.metrics_json}")
        return 0

    # synthesize from parameter files
    f0, tpos, fp = params.read_f0(args.input + ".f0")
    spec, meta = params.read_spectral_envelope(args.input + ".spec")
    ap, _ = params.read_aperiodicity(args.input + ".ap")
    fs, fft_size = meta["fs"], meta["fft_size"]
    with profile_region():
        f0, spec = _modify(f0, spec, fs, fft_size,
                           args.f0_scale, args.formant_scale)
        y = _synthesize(f0, spec, ap, fs, fft_size, fp, dtype, args.seed)
    if args.profile:
        print(f"wrote jax.profiler trace to {args.profile}")
    wav.wavwrite(args.output, y, fs)
    print(f"\nwrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
