#!/usr/bin/env python
"""Smoke test of the production path on NVIDIA GPUs.

    python chip_smoke.py          # one GPU: phases (a)-(f) below
    python chip_smoke.py --four   # four GPUs: the dp x sp mesh path only

One process; no child process imports JAX.  Phases, in order:

  (a) device: the backend must be "gpu"; prints the JAX version, device
      kind and count, the card's name and power limit (nvidia-smi) and the
      compile-cache directory;
  (b) the Triton refine kernel as compiled for the card against the dense
      refine_stage, at the bench's config-5 width (3 s at 22.05 kHz,
      f0_floor 40, every frame), plus the repo's ``gpu``-marked tests;
  (c) the main path: parallel.batch.batch_wav_to_wav on an 8-utterance
      22.05 kHz batch with pitch 1.2 and duration 1.25 (bench config 5),
      then the 48 kHz single-utterance program (bench config 4): compile
      time, steady wall time, memory;
  (d) the other entry points: api.World.copy_synthesis and the per-stage
      Harvest/CheapTrick/D4C/Synthesis facade on the 16/22.05/48 kHz
      fixtures, and longaudio.LongPipeline on a 60 s utterance;
  (e) correctness: f32 F0 and CheapTrick against the C++ reference dumps;
      every Harvest stage of the (c) batch on the card fed the host CPU's
      inputs (each stage's own difference), the analysis and synthesis
      from the CPU's F0, and the (c) F0 against the CPU running the same
      stages with and without the card's TF32 filter-bank rounding;
  (f) float64: the CLI's default copy-synthesis of the 16 kHz fixture
      against the C++ resynthesis.

Every gate prints its value beside its limit and the reason for the limit.
Any failure exits non-zero.  On success the last line of standard output
is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import gzip
import json
import pathlib
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
FIXTURES = REPO / "tests" / "fixtures"

#: bench config 5 (bench.py): 22.05 kHz corpus batches, B = 8, pitch x1.2,
#: duration x1.25, f0_floor 40
FS5, B5, PITCH5, DUR5 = 22050, 8, 1.2, 1.25

_failures = []
#: persistent compile-cache events of this process (jax.monitoring)
_cache_events = {"/jax/compilation_cache/cache_hits": 0,
                 "/jax/compilation_cache/cache_misses": 0}


def log(*a):
    print(*a, flush=True)


def gate(name, value, ok, limit, why):
    """Record one gate: ``ok`` is whether ``value`` meets ``limit``."""
    log(f"  gate {name}: {value!r} (limit {limit}) "
        f"{'PASS' if ok else 'FAIL'} — {why}")
    if not ok:
        _failures.append(name)


def run_phase(name, fn, *args, **kw):
    log(f"\n== phase {name}")
    t0 = time.time()
    try:
        out = fn(*args, **kw)
    except Exception:
        traceback.print_exc(file=sys.stdout)
        _failures.append(f"phase {name} raised")
        out = None
    log(f"== phase {name} done in {time.time() - t0:.1f} s; compile cache "
        f"so far: {_cache_events}")
    return out


def _f0_stats(a, b):
    """(F0 RMSE on frames both call voiced, VUV agreement)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = min(a.shape[-1], b.shape[-1])
    a, b = a[..., :n], b[..., :n]
    both = (a > 0) & (b > 0)
    rmse = float(np.sqrt(np.mean((a[both] - b[both]) ** 2))) if both.any() \
        else 0.0
    return rmse, float(np.mean((a > 0) == (b > 0)))


def _frame_agreement(a, b, tol_hz=1.0):
    """Share of frames both call unvoiced, or both voiced within tol_hz."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same = ((a == 0) & (b == 0)) | ((a > 0) & (b > 0)
                                    & (np.abs(a - b) <= tol_hz))
    return float(np.mean(same))


def _short_time_rms(y, w=160):
    y = np.asarray(y, np.float64)
    n = (y.shape[-1] // w) * w
    return np.sqrt(np.mean(y[..., :n].reshape(*y.shape[:-1], -1, w) ** 2,
                           -1))


# --------------------------------------------------------------------------
# (a) device
# --------------------------------------------------------------------------

def phase_device(want_count):
    import jax

    platform = jax.default_backend()
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU — JAX's default backend is "
                         f"{platform!r}; this smoke test needs an NVIDIA GPU")
    from worldtpu import runtime

    cache = runtime.setup_compile_cache()

    def count(event, **_):
        if event in _cache_events:
            _cache_events[event] += 1

    jax.monitoring.register_event_listener(count)
    info = runtime.device_info()
    log(f"jax {jax.__version__}; device_kind {info['kind']!r}; "
        f"device count {info['count']}")
    log(f"compile cache: {cache}")
    if info["count"] < want_count:
        raise SystemExit(f"chip_smoke: needs {want_count} GPUs, JAX sees "
                         f"{info['count']}")
    return info


# --------------------------------------------------------------------------
# (b) refine kernel vs the dense reference
# --------------------------------------------------------------------------

def phase_kernel(fs=FS5, dur=3.0):
    import jax
    import jax.numpy as jnp
    from bench import synth_utterance
    from worldtpu.analysis import harvest as H
    from worldtpu.ops.refine_kernel import refine_stage_triton

    x = synth_utterance(fs, dur, 120.0, 5)
    geo = H.HarvestGeometry(fs, len(x), f0_floor=40.0)
    y = H.decimate_stage(jnp.asarray(x), ratio=geo.ratio,
                         y_length=geo.y_length)
    tpos = jnp.arange(geo.f0_length, dtype=jnp.float32) / 1000.0
    cand, _, _ = H.candidates_stage(y, 0.0, tpos, geo=geo)
    cand = H.dedup_candidates(cand)
    t0 = time.time()
    r1, s1 = jax.block_until_ready(
        refine_stage_triton(y, cand, tpos, geo=geo))
    log(f"  kernel compile+first run {time.time() - t0:.2f} s; frames "
        f"{geo.f0_length}, slots {cand.shape[1]}, mean active "
        f"{float(jnp.mean(jnp.sum(cand > 0, axis=1))):.2f}")
    with jax.default_matmul_precision("highest"):
        r0, s0 = H.refine_stage(y, cand, tpos, geo=geo)
    r0, r1 = np.asarray(r0), np.asarray(r1)
    act = (r0 > 0) | (r1 > 0)
    d = np.abs(r1 - r0)[act]
    frac = float(np.mean(d > 0.1)) if d.size else 0.0
    p999 = float(np.quantile(d, 0.999)) if d.size else 0.0
    log(f"  refined slots {int(act.sum())}; max |diff| "
        f"{float(d.max()) if d.size else 0.0:.3e} Hz")
    gate("refine_frac_gt_0.1hz", frac, frac <= 1e-4, "<= 1e-4",
         "same math, f32 sums in another order; a slot may flip only at "
         "a score-2.5 / floor / ceiling knife edge")
    gate("refine_p999_hz", p999, p999 <= 0.005, "<= 0.005 Hz",
         "CPU interpreter agreement is ~1e-4 Hz; libdevice vs XLA cos/sin "
         "adds ulp-level differences")

    # the repo's gpu-marked tests, run here on the card
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "test_kernels", REPO / "tests" / "test_kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in sorted(dir(mod)):
        fn = getattr(mod, name)
        marks = [m.name for m in getattr(fn, "pytestmark", [])]
        if name.startswith("test_") and "gpu" in marks:
            fn(gpu=None)
            log(f"  gpu test {name}: PASS")


# --------------------------------------------------------------------------
# (c) the main path
# --------------------------------------------------------------------------

def config5_batch(n=B5, fs=FS5, seed0=0):
    """Bench config 5's synthetic corpus batch: n speech-shaped utterances
    from bench.synth_utterance_diverse, padded to a 4096-sample multiple."""
    from bench import synth_utterance_diverse

    waves = [synth_utterance_diverse(fs, seed0 + i) for i in range(n)]
    T = -(-max(len(w) for w in waves) // 4096) * 4096
    x = np.zeros((n, T), np.float32)
    for i, w in enumerate(waves):
        x[i, :len(w)] = w
    return x


def _program_statics(T, fs, pitch, dur):
    """(Harvest geometry, batch_copy_synthesis static arguments) of the
    wav->wav program for T-sample utterances."""
    from worldtpu import constants as C
    from worldtpu.analysis.cheaptrick import CheapTrickKernel
    from worldtpu.analysis.harvest import HarvestKernel
    from worldtpu.synthesis import synthesis as S

    hk = HarvestKernel(fs, T, f0_floor=40.0)
    ck = CheapTrickKernel(fs)
    out_len = int((hk.get_samples() - 1) * 0.005 * dur * fs) + 1
    mp = S.capacity_max_pulses(out_len, fs,
                               f0_cap=C.DEFAULT_F0 * max(pitch, 1.0))
    return hk.geo, dict(fs=fs, fft_size=ck.fft_size,
                        max_half_window=ck.max_half_window,
                        frame_period_s=0.005 * dur, out_length=out_len,
                        max_pulses=mp)


def wav_to_wav_program(T, B, fs, *, pitch=1.0, dur=1.0, mesh=None):
    """The jitted wav->wav program of batch_wav_to_wav for a [B, T] batch,
    with its noise input (threefry, so identical on every backend)."""
    import jax
    import jax.numpy as jnp
    from worldtpu.parallel import batch as Bt
    from worldtpu.synthesis import synthesis as S

    geo, st = _program_statics(T, fs, pitch, dur)
    noise = S.make_noise(jax.random.PRNGKey(0), B * st["max_pulses"],
                         st["fft_size"], jnp.float32).reshape(
                             B, st["max_pulses"], -1)

    def fn(x, nz):
        return Bt.batch_wav_to_wav(x, nz, geo=geo, mesh=mesh,
                                   pitch_scale=pitch, return_overflow=True,
                                   **st)

    F = 1 + int(1000.0 * geo.x_length / geo.fs / geo.frame_period)
    return jax.jit(fn), noise, st["out_length"], F


def copy_synthesis_program(T, fs, *, pitch=1.0, dur=1.0):
    """The analysis + synthesis half of wav_to_wav_program, from a given
    (already pitch-scaled) F0 [B, F]: jitted fn(x, f0, noise) -> y."""
    import jax
    import jax.numpy as jnp
    from worldtpu.parallel import batch as Bt

    geo, st = _program_statics(T, fs, pitch, dur)

    def fn(x, f0, nz):
        tpos = jnp.arange(f0.shape[1], dtype=x.dtype) * (
            geo.frame_period / 1000.0)
        return Bt.batch_copy_synthesis(x, f0, tpos, nz, **st)[0]

    return jax.jit(fn)


def harvest_stage_programs(geo, chunk=32):
    """The f32 Harvest of batch_wav_to_wav (harvest_device_full with its
    production grid, dedup and platform refine) as one jitted program per
    stage over a [B, ...] batch: a list of (stage, fn, input stages), where
    "x" names the waveform batch.  Chained, they compute what the fused
    program computes; fed the same inputs on two devices, they isolate
    each stage's own difference."""
    import jax
    import jax.numpy as jnp
    from worldtpu.analysis import contour_device as CDV
    from worldtpu.analysis import harvest as H

    k = H._grid_for(jnp.float32)
    gk = geo.with_grid(k)
    tpos = jnp.arange(gk.f0_length, dtype=jnp.float32) * (k / 1000.0)
    bounds = jnp.asarray(gk.boundary_f0, jnp.float32)
    n_out = 1 + int(1000.0 * geo.x_length / geo.fs / geo.frame_period)
    v = jax.vmap

    def refine(y, c):
        return jnp.stack(H.refine_production(y, c, tpos, geo=gk,
                                             chunk=chunk))

    def contour(rs):
        return CDV.fix_and_smooth(rs[0], rs[1], n_out, geo.frame_period,
                                  grid_ms=k)

    progs = [
        ("decimate", lambda x: H.decimate_stage(
            x, ratio=geo.ratio, y_length=geo.y_length), ("x",)),
        ("filter_bank", lambda y: H._filter_bank(y, gk), ("decimate",)),
        ("band_candidates", lambda f: v(
            lambda fi, b: H._band_candidates(fi, b, gk, tpos))(f, bounds),
         ("filter_bank",)),
        ("detect_overlap", lambda r: H._overlap_candidates(
            H._detect_candidates(r, gk)), ("band_candidates",)),
        ("dedup", H.dedup_candidates, ("detect_overlap",)),
        ("refine", refine, ("decimate", "dedup")),
        ("prune", lambda rs: jnp.stack(H.remove_unreliable_stage(*rs)),
         ("refine",)),
        ("contour_base", lambda rs: CDV.search_f0_base(rs[0], rs[1]),
         ("prune",)),
        ("contour", contour, ("prune",)),
    ]
    return [(name, jax.jit(v(fn)), ins) for name, fn, ins in progs]


def run_stages(progs, x, device):
    """Chain the stage programs on ``device``: {stage: numpy output}."""
    import jax

    outs = {"x": jax.device_put(x, device)}
    for name, fn, ins in progs:
        outs[name] = fn(*(outs[i] for i in ins))
    return {k: np.asarray(o) for k, o in outs.items()}


def stage_parts(name, out):
    """The (part, array) pieces of a stage output that stage_difference
    compares: refine and prune stack [F0, score]; the rest are one piece."""
    out = np.asarray(out)
    if name in ("refine", "prune"):
        return [(f"{name}_f0", out[..., 0, :, :]),
                (f"{name}_score", out[..., 1, :, :])]
    return [(name, out)]


def stage_difference(part, a, b):
    """How far stage output ``a`` is from ``b``.  Signals (decimate,
    filter bank): relative RMS difference.  Candidate, F0 and score slabs:
    the share of entries that differ in voicing (zero vs non-zero) or by
    more than a relative tolerance — 1e-3 for F0 values (0.1 Hz at 100 Hz),
    1e-2 for scores (a score is the reciprocal of a small mean relative
    deviation: the CPU's f32 refine against f64 moves it by up to 9e-3)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if part in ("decimate", "filter_bank"):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    tol = 1e-2 if part.endswith("_score") else 1e-3
    off = ((a > 0) != (b > 0)) | (np.abs(a - b) > tol * np.abs(b))
    return float(np.mean(off))


def _time_program(label, f, args, card, reps=5):
    import jax
    t0 = time.time()
    compiled = f.lower(*args).compile()
    t_compile = time.time() - t0
    out = jax.block_until_ready(compiled(*args))
    walls = []
    for _ in range(reps):
        t0 = time.time()
        jax.block_until_ready(compiled(*args))
        walls.append(time.time() - t0)
    log(f"  {label}: compile {t_compile:.2f} s; steady wall min "
        f"{min(walls) * 1e3:.3f} ms median {np.median(walls) * 1e3:.3f} ms "
        f"over {reps} runs with block_until_ready [{card}]")
    log(f"  {label}: memory_analysis {compiled.memory_analysis()}")
    return compiled, out


def _check_wav_to_wav(label, out, B, out_len, F):
    y, f0, ovf = (np.asarray(o) for o in out)
    ok = (y.shape == (B, out_len) and f0.shape == (B, F)
          and bool(np.isfinite(y).all()) and bool(np.isfinite(f0).all()))
    gate(f"{label}_shapes_finite", (y.shape, f0.shape), ok,
         f"y {(B, out_len)}, f0 {(B, F)}, all finite", "output contract")
    gate(f"{label}_no_overflow", int(ovf.sum()), not ovf.any(), "0",
         "the static pulse capacity covers speech at pitch x1.2")
    peak = float(np.abs(y).max())
    gate(f"{label}_not_silent", peak, peak > 0.01, "> 0.01",
         "resynthesized speech has energy")


def phase_main(card, x5=None, x4_dur=3.0):
    import jax
    import jax.numpy as jnp
    from bench import synth_utterance

    if x5 is None:
        x5 = config5_batch()
    B, T = x5.shape
    f5, noise5, out5, F5 = wav_to_wav_program(T, B, FS5, pitch=PITCH5,
                                              dur=DUR5)
    args5 = (jnp.asarray(x5), noise5)
    c5, out = _time_program(f"config-5 batch B={B} T={T} @22.05 kHz", f5,
                            args5, card)
    _check_wav_to_wav("config5", out, B, out5, F5)
    # the OLA scatter-add uses atomics on the GPU: two runs of one program
    # may differ at rounding level
    out_b = c5(*args5)
    y1, y2 = np.asarray(out[0]), np.asarray(out_b[0])
    dev = float(np.abs(y1 - y2).max() / max(np.abs(y1).max(), 1e-12))
    gate("config5_run_to_run_rel", dev, dev <= 1e-5, "<= 1e-5 of peak",
         "atomic f32 adds in the OLA reorder ~10 overlapping pulse "
         "responses per sample: ulp-level, never structural")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}")

    fs4 = 48000
    x4 = synth_utterance(fs4, x4_dur, 180.0, 4)[None]
    f4, noise4, out4, F4 = wav_to_wav_program(x4.shape[1], 1, fs4)
    _, o4 = _time_program("config-4 single 48 kHz", f4,
                          (jnp.asarray(x4), noise4), card)
    _check_wav_to_wav("config4", o4, 1, out4, F4)
    return x5, noise5, out


# --------------------------------------------------------------------------
# (d) other entry points
# --------------------------------------------------------------------------

def _read_fixture(name):
    from worldtpu.io import params, wav
    x, fs, _ = wav.wavread(FIXTURES / f"{name}.wav")
    f0, tpos, fp = params.read_f0(FIXTURES / f"{name}.f0.gz")
    spec, meta = params.read_spectral_envelope(FIXTURES / f"{name}.spec.gz")
    return np.asarray(x), fs, np.asarray(f0), np.asarray(tpos), spec, meta


def phase_entry_points(long_s=60.0):
    import jax.numpy as jnp
    from bench import synth_utterance_diverse
    from worldtpu import api
    from worldtpu.longaudio import LongPipeline

    for name in ("t16", "t22", "t48"):
        x, fs, *_ = _read_fixture(name)
        y, f0 = api.World(fs, f0_floor=40.0).copy_synthesis(x)
        ok = np.isfinite(y).all() and np.isfinite(f0).all() \
            and abs(len(y) - len(x)) <= 0.005 * fs + 1
        gate(f"world_copy_synthesis_{name}", (len(y), len(f0)), bool(ok),
             "finite, length within a frame of the input", "entry point")

        f32 = jnp.float32
        tpos, f0 = api.Harvest(fs, api.HarvestOption(f0_floor=40.0)).compute(
            x, dtype=f32)
        ct = api.CheapTrick(fs)
        spec = np.asarray(ct.compute(x, tpos, f0, dtype=f32))
        ap = np.asarray(api.D4C(fs).compute(x, tpos, f0, ct.fft_size,
                                            dtype=f32))
        out_len = int((len(f0) - 1) * 0.005 * fs) + 1
        y = np.asarray(api.Synthesis(fs, ct.fft_size, 5.0).compute(
            f0, spec, ap, out_len, dtype=f32))
        ok = all(np.isfinite(a).all() for a in (f0, spec, ap, y)) \
            and y.shape == (out_len,)
        gate(f"facade_stages_{name}", (len(f0), spec.shape, y.shape),
             bool(ok), "finite, shapes", "entry point")

    fs = FS5
    parts, n, seed = [], 0, 100
    while n < long_s * fs:
        w = synth_utterance_diverse(fs, seed)
        parts.append(w)
        n += len(w)
        seed += 1
    x = np.concatenate(parts)[:int(long_s * fs)]
    t0 = time.time()
    y, f0 = LongPipeline(fs, f0_floor=40.0).copy_synthesis(x)
    ok = np.isfinite(y).all() and np.isfinite(f0).all() \
        and abs(len(y) - len(x)) <= 0.005 * fs + 1 and (f0 > 0).mean() > 0.2
    gate(f"long_pipeline_{long_s:g}s", (len(y), float((f0 > 0).mean())),
         bool(ok), "finite, input length, > 20% voiced", "entry point "
         f"(chunked synthesis OLA; {time.time() - t0:.1f} s incl. compile)")


# --------------------------------------------------------------------------
# (e) correctness on the card
# --------------------------------------------------------------------------

#: f32 F0 against the C++ dumps: (RMSE limit on frames both call voiced,
#: Hz).  Each sits between the card's reading (TF32 filter bank; the CPU
#: reproduces it with the bank's operands rounded to TF32) and a
#: lower-precision control, the bank's operands rounded to bf16, measured
#: on the CPU: t16 0.0054 / 0.125, t22 0.0076 / 0.114, t48 0.142 / 1.96 Hz
F0_RMSE_LIMIT = {"t16": 0.03, "t22": 0.03, "t48": 0.5}
#: CheapTrick from the C++ F0 against the C++ envelope (MCD, dB): the card
#: reads <= 0.00024 dB, the CPU 0.00007-0.00021 dB; the same f32 CheapTrick
#: on the waveform rounded to float16 reads 0.10-0.20 dB
MCD_LIMIT = 0.005

#: Stage-by-stage limits for the config-5 batch, each stage on the card fed
#: the CPU's inputs (harvest_stage_programs, stage_difference):
#: part -> (limit, reason).  Relative RMS for decimate and the filter bank,
#: the share of entries off (voicing, or beyond the part's relative
#: tolerance) for the rest.  The card's readings (one H100, 700 W) are in
#: each reason; a limit sits a stated margin above its reading and below
#: what a known-wrong implementation reads.
STAGE_LIMITS = {
    "decimate": (1e-6, "f32 sums in another order; card 9.2e-9"),
    "filter_bank": (4e-4, "Precision.DEFAULT runs the bank matmul in TF32 "
                    "on the card: card 1.61e-4, the CPU's TF32 emulation "
                    "1.61e-4, a bf16 bank 1.29e-3"),
    "band_candidates": (1e-5, "zero crossings of the same bank: a crossing "
                        "within rounding of zero can flip; card 3.0e-7"),
    "detect_overlap": (1e-5, "run means over bands in another order; "
                       "card 0"),
    "dedup": (1e-6, "sort and compare, exact; card 0"),
    "refine_f0": (1e-6, "the Triton kernel vs the dense refine_stage, the "
                  "same math in another f32 order: card 0 (4.5M slots; the "
                  "kernel with absolute-time windows read 3.8e-6, a "
                  "missing dedup 0.18)"),
    "refine_score": (1e-4, "as above, scores to 1e-2 relative: card 0 (the "
                     "kernel with absolute-time windows read 1.7e-2)"),
    "prune_f0": (1e-6, "neighbour ratios of the same values; card 0"),
    "prune_score": (1e-6, "as above; card 0"),
    "contour_base": (1e-4, "argmax of the same scores; card 0 (35.7k "
                     "frames)"),
    "contour": (1e-4, "the contour chain on the same candidates; card 0"),
}


def _bank_tf32_reference(y, gk, device):
    """CPU reference of the card's production filter bank for a [B, L]
    batch of decimated signals: the same blocked-Toeplitz matmul
    (harvest._band_filter_matmul_kb) with both operands rounded to TF32
    (10 mantissa bits, nearest) and the products summed in f32 — what a
    Precision.DEFAULT f32 matmul computes on the card."""
    import jax
    import jax.numpy as jnp
    from worldtpu.analysis import harvest as H

    def tf32(a):
        b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
        b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
        return b.astype(np.uint32).view(np.float32)

    banks = [(H._conv_matmul_bank(gk, lo, hi, Lg), Lg)
             for lo, hi, Lg in H._conv_groups(gk)]

    def one(yr):
        return jnp.concatenate([
            H._band_filter_matmul_kb(yr, tf32(kb), W, Lg, gk.y_length,
                                     jnp.float32)
            for (W, kb), Lg in banks], axis=0)

    return np.asarray(jax.jit(jax.vmap(one))(
        jax.device_put(tf32(y), device)))


def phase_vs_reference():
    import jax.numpy as jnp
    from bench import quality_metrics
    from worldtpu.analysis.cheaptrick import CheapTrickKernel
    from worldtpu.analysis.harvest import HarvestKernel

    for name in ("t16", "t22", "t48"):
        x, fs, f0_ref, tpos_ref, spec_ref, _ = _read_fixture(name)
        hk = HarvestKernel(fs, len(x), f0_floor=40.0)
        f0, _ = hk.compute(jnp.asarray(x, jnp.float32), dtype=jnp.float32)
        rmse, vuv = _f0_stats(f0, f0_ref)
        lim = F0_RMSE_LIMIT[name]
        gate(f"f0_rmse_{name}", rmse, rmse <= lim, f"<= {lim} Hz",
             "TF32 filter bank; a bf16 bank fails (see F0_RMSE_LIMIT)")
        vlim = 1.0 - 1.5 / len(f0_ref)
        gate(f"f0_vuv_{name}", vuv, vuv >= vlim, f">= {vlim:.5f}",
             "at most one voicing flip (the TF32 control flips none; the "
             "bf16 control flips 3 of t48's 201 frames)")
        spec = np.asarray(CheapTrickKernel(fs)(
            jnp.asarray(x, jnp.float32), jnp.asarray(f0_ref, jnp.float32),
            jnp.asarray(tpos_ref, jnp.float32)))
        mcd = quality_metrics(f0_ref, f0_ref, spec, spec_ref)["mcd_db"]
        gate(f"cheaptrick_mcd_{name}", mcd, mcd <= MCD_LIMIT,
             f"<= {MCD_LIMIT} dB", "f32 FFTs in another order; a float16 "
             "input fails (see MCD_LIMIT)")


def phase_batch_vs_cpu(main):
    import jax
    import jax.numpy as jnp
    from worldtpu.analysis import harvest as H

    if main is None:
        raise RuntimeError("phase (c) produced no batch to compare")
    x5, noise5, out_gpu = main
    T = x5.shape[1]
    geo, _ = _program_statics(T, FS5, PITCH5, DUR5)
    gk = geo.with_grid(H._grid_for(jnp.float32))
    progs = harvest_stage_programs(geo)
    cpu, card = jax.devices("cpu")[0], jax.devices()[0]

    # every stage on the CPU, chained; then each stage on the card fed the
    # CPU's inputs, so a reading is that stage's own difference
    ref = run_stages(progs, x5, cpu)
    for name, fn, ins in progs:
        got = np.asarray(fn(*(jax.device_put(ref[i], card) for i in ins)))
        for (part, g), (_, r) in zip(stage_parts(name, got),
                                     stage_parts(name, ref[name])):
            d = stage_difference(part, g, r)
            lim, why = STAGE_LIMITS[part]
            gate(f"stage_{part}_vs_cpu", d, d <= lim, f"<= {lim}", why)
            log("    per utterance: " + " ".join(
                f"{stage_difference(part, gu, ru):.2e}"
                for gu, ru in zip(g, r)))
        if name == "filter_bank":
            bank_tf32 = _bank_tf32_reference(ref["decimate"], gk, cpu)
            d = stage_difference(name, got, bank_tf32)
            gate("stage_filter_bank_vs_cpu_tf32", d, d <= 5e-6, "<= 5e-6",
                 "TF32 products are exact in f32, so only the order of "
                 "the f32 sums differs: card 7.3e-7 (operands truncated "
                 "instead of rounded would read ~1e-4)")

    # the downstream half (CheapTrick, D4C, synthesis) from the CPU's F0
    f0_c = (ref["contour"] * np.float32(PITCH5)).astype(np.float32)
    syn = copy_synthesis_program(T, FS5, pitch=PITCH5, dur=DUR5)
    y_c = np.asarray(syn(*jax.device_put((x5, f0_c, noise5), cpu)))
    y_g = np.asarray(syn(x5, f0_c, noise5))
    d = float(np.quantile(np.abs(_short_time_rms(y_g)
                                 - _short_time_rms(y_c)), 0.99))
    gate("stage_copy_synthesis_vs_cpu", d, d <= 1e-4, "<= 1e-4",
         "same F0 and noise: f32 FFT sums and OLA atomics in another "
         "order; card 1.4e-5")

    # end to end: the card's production F0 against the CPU chain with the
    # card's TF32 filter bank, and against the plain f32 CPU chain
    tf = dict(ref)
    tf["filter_bank"] = bank_tf32
    names = [n for n, _, _ in progs]
    for name, fn, ins in progs[names.index("filter_bank") + 1:]:
        tf[name] = np.asarray(fn(*(jax.device_put(tf[i], cpu)
                                   for i in ins)))
    f0_g = np.asarray(out_gpu[1])
    agree = {}
    for label, chain in (("cpu_tf32", tf), ("cpu_f32", ref)):
        f0_r = (chain["contour"] * np.float32(PITCH5)).astype(np.float32)
        rmse, vuv = _f0_stats(f0_g, f0_r)
        agree[label] = _frame_agreement(f0_g, f0_r)
        log(f"  production batch F0 vs {label}: RMSE {rmse:.4f} Hz on "
            f"frames both voice, VUV {vuv:.5f}, frames agreeing "
            f"{agree[label]:.5f}")
    gate("batch_f0_agreement_vs_cpu_tf32", agree["cpu_tf32"],
         agree["cpu_tf32"] >= 0.999, ">= 0.999",
         "the CPU runs the card's TF32 bank rounding, so only f32 sum "
         "order differs: card 1.0 (RMSE 0.0001 Hz); the kernel with "
         "absolute-time windows alone moved it to 0.9959")
    gate("batch_f0_agreement_vs_cpu_f32", agree["cpu_f32"],
         agree["cpu_f32"] >= 0.955, ">= 0.955",
         "TF32 bank vs f32 on this hard audio: card 0.96805, the CPU's "
         "TF32 emulation 0.9686, a bf16 bank 0.9454")


# --------------------------------------------------------------------------
# (f) float64 CLI copy-synthesis
# --------------------------------------------------------------------------

#: the CLI's f64 copy-synthesis of t16 against the C++ resynthesis, on CPU
CPU_F64 = {"st_rms_median_rel": 0.00285, "corr": 0.8538}


def phase_f64():
    from worldtpu import cli
    from worldtpu.io import wav

    with tempfile.TemporaryDirectory() as d:
        out = str(pathlib.Path(d) / "t16_f64.wav")
        rc = cli.main(["copy-syn", str(FIXTURES / "t16.wav"), out])
        gate("cli_f64_rc", rc, rc == 0, "0", "CLI contract")
        y, _, _ = wav.wavread(out)
    ref = np.frombuffer(gzip.open(FIXTURES / "t16.syn.f64.gz").read(), "<f8")
    n = min(len(y), len(ref))
    y, ref = np.asarray(y[:n], np.float64), ref[:n]
    ra, rb = _short_time_rms(y), _short_time_rms(ref)
    loud = rb > 0.1 * rb.max()
    rel = float(np.median(np.abs(ra[loud] - rb[loud]) / rb[loud]))
    corr = float(np.corrcoef(y, ref)[0, 1])
    c = CPU_F64
    gate("f64_short_time_rms_median_rel", rel,
         rel <= c["st_rms_median_rel"] + 0.005,
         f"<= CPU {c['st_rms_median_rel']} + 0.005",
         "same f64 math; cuFFT is not bitwise equal to the CPU FFT and "
         "the noise stream differs from the C++ one")
    gate("f64_waveform_corr", corr, corr >= c["corr"] - 0.02,
         f">= CPU {c['corr']} - 0.02", "as above")


# --------------------------------------------------------------------------
# --four: the mesh path
# --------------------------------------------------------------------------

def phase_four(card, x=None):
    import jax
    import jax.numpy as jnp
    from worldtpu.analysis.cheaptrick import CheapTrickKernel
    from worldtpu.analysis.harvest import HarvestKernel
    from worldtpu.parallel import batch as Bt

    if x is None:
        x = config5_batch(n=2 * B5)
    B, T = x.shape
    dev0 = jax.devices()[0]
    f1, noise, out_len, F = wav_to_wav_program(T, B, FS5, pitch=PITCH5,
                                               dur=DUR5)
    args = (jnp.asarray(x), noise)
    _, ref = _time_program(f"wav_to_wav B={B} on devices[0]", f1,
                           jax.device_put(args, dev0), card)
    hk = HarvestKernel(FS5, T, f0_floor=40.0)
    ck = CheapTrickKernel(FS5)
    fa = jax.jit(lambda xx, mesh=None: Bt.batch_analyze(
        xx, geo=hk.geo, fs=FS5, fft_size=ck.fft_size,
        max_half_window=ck.max_half_window, mesh=mesh),
        static_argnames=("mesh",))
    a_ref = [np.asarray(o) for o in fa(jax.device_put(args[0], dev0))]
    for nd, nt in ((4, 1), (2, 2)):
        mesh = Bt.make_mesh(nd, nt)
        fm, _, _, _ = wav_to_wav_program(T, B, FS5, pitch=PITCH5, dur=DUR5,
                                         mesh=mesh)
        _, out = _time_program(f"wav_to_wav B={B} mesh {nd}x{nt}", fm,
                               args, card)
        _check_wav_to_wav(f"mesh{nd}x{nt}", out, B, out_len, F)
        rmse, vuv = _f0_stats(out[1], ref[1])
        gate(f"mesh{nd}x{nt}_f0_rmse_vs_single", rmse, rmse <= 0.5,
             "<= 0.5 Hz", "the mesh path filters all bands with one "
             "full-width matmul per shard, the single-device path with "
             "width-grouped ones: sums may run in another order "
             "(measured equal on four H100s)")
        gate(f"mesh{nd}x{nt}_f0_vuv_vs_single", vuv, vuv >= 0.99,
             ">= 0.99", "knife-edge voicing flips from those candidates")
        d = float(np.quantile(np.abs(_short_time_rms(out[0])
                                     - _short_time_rms(ref[0])), 0.99))
        gate(f"mesh{nd}x{nt}_short_time_rms_p99_vs_single", d, d <= 0.02,
             "<= 0.02", "a moved knife-edge pulse and OLA atomics")
        a = [np.asarray(o) for o in fa(args[0], mesh=mesh)]
        rmse, vuv = _f0_stats(a[0], a_ref[0])
        gate(f"mesh{nd}x{nt}_analyze_f0_rmse_vs_single", rmse,
             rmse <= 0.5, "<= 0.5 Hz", "as for wav_to_wav")
        gate(f"mesh{nd}x{nt}_analyze_f0_vuv_vs_single", vuv,
             vuv >= 0.99, ">= 0.99", "as for wav_to_wav")
        same = (a[0] == a_ref[0])[..., None]
        rel = np.abs(a[1] - a_ref[1]) / np.maximum(a_ref[1], 1e-30)
        sp_rel = float(np.median(rel[np.broadcast_to(same, rel.shape)]))
        gate(f"mesh{nd}x{nt}_analyze_spec_median_rel_vs_single", sp_rel,
             sp_rel <= 1e-4, "<= 1e-4 on frames with equal F0",
             "same CheapTrick on the same F0: f32 FFT rounding only")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-GPU mesh path and what it is "
                        "compared with")
    args = p.parse_args(argv)
    want = 4 if args.four else 1
    info = phase_device(want)
    from worldtpu import runtime

    smi = runtime.gpu_name_and_power_limit()
    card = "; ".join(smi) if smi else "nvidia-smi unavailable"
    log(f"nvidia-smi name, power.limit: {card}")
    if args.four:
        run_phase("four: mesh path", phase_four, card)
    else:
        run_phase("b: refine kernel vs dense reference", phase_kernel)
        main_out = run_phase("c: main path", phase_main, card)
        run_phase("d: other entry points", phase_entry_points)
        run_phase("e1: correctness against the C++ reference",
                  phase_vs_reference)
        run_phase("e2: the batch stage by stage against the CPU",
                  phase_batch_vs_cpu, main_out)
        run_phase("f: float64 CLI copy-synthesis", phase_f64)
    log(f"\ncompile cache events: {_cache_events}")
    if _failures:
        log(f"chip_smoke: FAILED: {_failures}")
        return 1
    log(f"nvidia-smi name, power.limit: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
