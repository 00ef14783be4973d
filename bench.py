#!/usr/bin/env python
"""Benchmark: the five BASELINE.md configs + quality metrics vs the C++
reference, measured at runtime.

Configs (driver BASELINE.json):
  1. Harvest F0 contour, one 3 s 16 kHz utterance, frame_period = 5 ms
  2. CheapTrick spectral envelope from Harvest F0, same utterance
  3. D4C aperiodicity + band-aperiodicity/envelope codec round-trip
  4. Full analysis->synthesis copy-synthesis of a single 48 kHz utterance
  5. Batched corpus copy-synthesis with pitch/duration manipulation
     (LJSpeech-like synthetic corpus, 22.05 kHz, streamed through
     io.corpus from a real wav directory)

The C++ reference binary is built once into /tmp/refbuild (sources from
/root/reference, per-stage chrono timings parsed from its stdout) and run
on the same wavs, so vs_baseline is measured, not hardcoded.  Quality
metrics (F0 RMSE, voicing agreement, mel-cepstral distortion) come from the
reference's parameter dumps on config 1's utterance.

Timing method: inputs staged on device; Harvest's host contour stage and
its transfers ARE timed.  Each config: 1 compile warmup, then best of
`reps` timed runs (steady state).  A run needs a GPU: on any other backend
it fails instead of timing the CPU.

Prints ONE JSON line:
    {"metric", "value", "unit", "vs_baseline", "configs", "quality",
     "kernel_parity", "device"}
value/vs_baseline are config 5 (the corpus stream), the headline number;
"device" names the platform, device kind and count, and the card's name
and power limit as nvidia-smi reports them.
"""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

FALLBACK_CPP_RTF = 3.17  # measured r1 on this container; used if build fails
REPS = int(os.environ.get("WORLDTPU_BENCH_REPS", "3"))
CONFIGS = os.environ.get("WORLDTPU_BENCH_CONFIGS", "1,2,3,4,5").split(",")


def synth_utterance(fs, dur, f0_base, seed):
    """LJSpeech-like synthetic vowel: vibrato harmonics + unvoiced gap."""
    rng = np.random.RandomState(seed)
    n = int(fs * dur)
    t = np.arange(n) / fs
    f0 = f0_base * 2 ** ((30 / 1200) * np.sin(2 * np.pi * 5.0 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = np.zeros(n)
    for k in range(1, 25):
        x += np.sin(k * phase) / k
    x /= np.max(np.abs(x)) * 1.3
    env = np.ones(n)
    g0, g1 = int(0.45 * n), int(0.55 * n)
    env[g0:g1] = 0.0
    x = x * env + 0.002 * rng.randn(n)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def synth_utterance_diverse(fs, seed):
    """Speech-shaped synthetic utterance for the corpus bench: variable
    length (1.5-4.5 s), per-'speaker' f0 base (105-280 Hz), alternating
    voiced vowels / fricative-like noise bursts / silent pauses with onset
    and offset ramps, plus leading/trailing silence.  Stresses exactly what
    identical vowels don't: voicing boundaries, silence-heavy frames,
    breathy (noise-dominated) segments, and length-diverse batch padding."""
    rng = np.random.RandomState(seed)
    dur = float(rng.uniform(1.5, 4.5))
    f0_base = float(rng.uniform(105.0, 280.0))
    n = int(fs * dur)
    x = np.zeros(n, np.float64)
    pos = int(rng.uniform(0.05, 0.20) * fs)        # leading silence
    phase = rng.uniform(0, 2 * np.pi)
    while pos < n - int(0.08 * fs):
        kind = rng.choice(["vowel", "fric", "pause"], p=[0.55, 0.25, 0.20])
        seg = int(rng.uniform(0.12, 0.45) * fs)
        seg = min(seg, n - pos)
        if kind == "pause":
            pos += seg
            continue
        t = np.arange(seg) / fs
        ramp = min(seg // 4, int(0.02 * fs)) or 1   # 20 ms onset/offset
        env = np.ones(seg)
        env[:ramp] = np.linspace(0, 1, ramp)
        env[-ramp:] = np.linspace(1, 0, ramp)
        if kind == "vowel":
            # declining contour + vibrato, like a stressed syllable
            f0 = (f0_base * 2 ** (rng.uniform(-0.15, 0.35)
                                  - 0.1 * t / max(t[-1], 1e-6)
                                  + (25 / 1200) * np.sin(2 * np.pi * 5 * t)))
            ph = phase + 2 * np.pi * np.cumsum(f0) / fs
            s = np.zeros(seg)
            for k in range(1, 20):
                s += np.sin(k * ph) / k
            s /= 2.2
            # breathiness: add aspiration noise at a random mix
            s += rng.uniform(0.01, 0.08) * rng.randn(seg)
            phase = ph[-1] % (2 * np.pi)
        else:
            # fricative: high-passed noise (diff of white noise)
            w = rng.randn(seg + 1)
            s = 0.25 * np.diff(w)
        x[pos:pos + seg] += env * s * rng.uniform(0.5, 1.0)
        pos += seg
    x += 0.0015 * rng.randn(n)
    peak = np.max(np.abs(x))
    if peak > 0:
        x *= 0.8 / peak
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def synth_utterance_pathological(fs, seed):
    """The voice qualities Harvest's heuristics were designed around and
    plain vowels never exercise: vocal fry (low-F0 pulse train with heavy
    period jitter + shimmer), diplophonia (alternating long/short periods
    producing subharmonics / doubled harmonics), plus mains hum, DC offset
    and room noise.  A modal-voice segment anchors the contour."""
    rng = np.random.RandomState(seed)
    dur = 3.2
    n = int(fs * dur)
    x = np.zeros(n, np.float64)

    def glottal_pulse(width):
        # Rosenberg-ish asymmetric pulse
        t = np.linspace(0, 1, width, endpoint=False)
        op, cl = 0.6, 0.3
        p = np.where(t < op, 0.5 * (1 - np.cos(np.pi * t / op)),
                     np.where(t < op + cl,
                              np.cos(0.5 * np.pi * (t - op) / cl), 0.0))
        return p - p.mean()

    def pulse_train(t0, t1, f0_base, jitter, shimmer, diplo=0.0):
        pos = int(t0 * fs)
        end = int(t1 * fs)
        alt = 0
        while pos < end:
            per = fs / (f0_base * 2 ** (rng.uniform(-jitter, jitter)))
            if diplo > 0.0 and alt % 2:
                per *= 1.0 + diplo
            width = max(8, int(per * 0.9))
            amp = 0.5 * 2 ** (rng.uniform(-shimmer, shimmer))
            seg = glottal_pulse(width) * amp
            hi = min(n, pos + width)
            x[pos:hi] += seg[:hi - pos]
            pos += int(per)
            alt += 1

    # modal anchor vowel
    pulse_train(0.15, 1.0, 170.0, 0.01, 0.05)
    # vocal fry: ~60 Hz, 25% jitter, strong shimmer
    pulse_train(1.1, 1.9, 62.0, 0.25, 0.5)
    # diplophonia: 150 Hz with alternating +40% periods
    pulse_train(2.0, 2.9, 150.0, 0.02, 0.1, diplo=0.4)
    # room noise + 50 Hz mains hum + DC offset
    t = np.arange(n) / fs
    x += 0.004 * rng.randn(n)
    x += 0.01 * np.sin(2 * np.pi * 50.0 * t)
    x += 0.02
    peak = np.max(np.abs(x))
    if peak > 0:
        x *= 0.8 / peak
    return np.clip(x, -0.99, 0.99).astype(np.float32)


#: real recorded audio baked into the container (pygame examples) — not
#: speech, but true recordings (room tone, transients, broadband content);
#: used as an algorithm-parity case in the quality block since the image
#: has no downloadable speech corpora (zero egress)
REAL_RECORDING = pathlib.Path(
    "/opt/venv/lib/python3.12/site-packages/pygame/examples/data/"
    "house_lo.wav")


# --------------------------------------------------------------------------
# C++ reference: build + measure
# --------------------------------------------------------------------------

def build_reference():
    """Build the reference timing binary and the single-threaded parameter
    dumper into /tmp/refbuild (cached).  Returns (bench_bin, dump_bin) or
    (None, None) if the toolchain/sources are unavailable."""
    rb = pathlib.Path("/tmp/refbuild")
    bench_bin, dump_bin = rb / "bench_test", rb / "dump_st"
    if bench_bin.exists() and dump_bin.exists():
        return bench_bin, dump_bin
    ref = pathlib.Path("/root/reference")
    if not ref.exists() or shutil.which("g++") is None:
        return None, None
    try:
        rb.mkdir(exist_ok=True)
        for d in ("src", "include", "tools", "test"):
            shutil.copytree(ref / d, rb / d, dirs_exist_ok=True)
        shutil.copy(pathlib.Path(__file__).parent / "tests/tools/dump.cpp",
                    rb / "dump.cpp")
        src = sorted(str(p) for p in (rb / "src").glob("*.cpp"))
        common = src + [str(rb / "tools/audioio.cpp"),
                        str(rb / "tools/parameterio.cpp")]
        subprocess.run(
            ["g++", "-std=c++11", "-O3", "-fopenmp",
             "-I", str(rb / "include"), "-I", str(rb / "tools"),
             "-o", str(bench_bin), str(rb / "test/test.cpp")] + common,
            check=True, capture_output=True, timeout=300)
        subprocess.run(
            ["g++", "-std=c++11", "-O2",
             "-I", str(rb / "include"), "-I", str(rb / "tools"),
             "-o", str(dump_bin), str(rb / "dump.cpp")] + common,
            check=True, capture_output=True, timeout=300)
        return bench_bin, dump_bin
    except Exception:
        return None, None


def measure_reference(bench_bin, wav_path, workdir):
    """Per-stage compute times (seconds) of the reference demo binary:
    {'harvest': s, 'cheaptrick': s, 'd4c': s, 'synthesis': s, 'total': s}.
    Parses the 'compute:\\t N [msec]' lines of test.cpp
    (/root/reference/test/test.cpp:112-113,159-160,196-197,262-263)."""
    if bench_bin is None:
        return None
    try:
        r = subprocess.run(
            [str(bench_bin), str(wav_path), str(workdir / "refout")],
            capture_output=True, text=True, timeout=600, cwd=str(workdir))
        times = [float(m) / 1000.0 for m in
                 re.findall(r"compute:\s*([0-9.e+-]+)\s*\[msec\]", r.stdout)]
        if len(times) != 4:
            return None
        keys = ("harvest", "cheaptrick", "d4c", "synthesis")
        out = dict(zip(keys, times))
        out["total"] = sum(times)
        return out
    except Exception:
        return None


# --------------------------------------------------------------------------
# quality metrics
# --------------------------------------------------------------------------

def mel_cepstra(spec, n=25):
    """[F, n] linear-frequency cepstra of a power spectrogram (host)."""
    logp = np.log(np.maximum(np.asarray(spec, np.float64), 1e-300))
    mirrored = np.concatenate([logp, logp[:, 1:-1][:, ::-1]], -1)
    ceps = np.fft.rfft(mirrored, axis=-1).real / mirrored.shape[-1]
    return ceps[:, :n]


def quality_metrics(f0_ours, f0_ref, spec_ours, spec_ref):
    n = min(len(f0_ours), len(f0_ref))
    a, b = np.asarray(f0_ours[:n], np.float64), np.asarray(f0_ref[:n])
    both = (a > 0) & (b > 0)
    f0_rmse = float(np.sqrt(np.mean((a[both] - b[both]) ** 2)))
    vuv = float(np.mean((a > 0) == (b > 0)))
    ca = mel_cepstra(spec_ours[:n])
    cb = mel_cepstra(spec_ref[:n])
    d = ca[:, 1:] - cb[:, 1:]
    mcd_frames = (10.0 / np.log(10.0)) * np.sqrt(
        2.0 * np.sum(d * d, axis=-1))
    return {"f0_rmse_hz": round(f0_rmse, 6),
            "vuv_agreement": round(vuv, 4),
            "mcd_db": round(float(np.mean(mcd_frames[both])), 6)}


# --------------------------------------------------------------------------
# timed runs
# --------------------------------------------------------------------------

def best_wall(fn, reps=REPS):
    fn()  # compile + warm
    walls = []
    for _ in range(reps):
        t0 = time.time()
        fn()
        walls.append(time.time() - t0)
    return min(walls)


def amortized_wall(dispatch, reps=REPS, k=8):
    """Steady-state per-call wall of a device-resident program: `dispatch`
    enqueues one run and returns device arrays WITHOUT synchronizing; k
    dispatches share ONE sync, as a production pipeline with many
    utterances in flight does.  The single-call `best_wall` numbers stay
    reported as `rtf` (cold = dispatch + sync every call); this is
    `rtf_amortized`."""
    import jax
    jax.block_until_ready(dispatch())  # compile + warm
    best = np.inf
    for _ in range(reps):
        t0 = time.time()
        out = None
        for _ in range(k):
            out = dispatch()
        jax.block_until_ready(out)
        best = min(best, (time.time() - t0) / k)
    return best


def main():
    import jax
    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench: no GPU — JAX's default backend is "
                         f"{jax.default_backend()!r}")
    import jax.numpy as jnp
    from worldtpu import codec
    from worldtpu import constants as C
    from worldtpu import runtime
    from worldtpu.analysis.cheaptrick import CheapTrickKernel, cheaptrick_frames
    from worldtpu.analysis.d4c import d4c_frames
    from worldtpu.analysis.harvest import HarvestKernel
    from worldtpu.io import corpus as corpus_io
    from worldtpu.io import params as params_io
    from worldtpu.io import wav as wav_io
    from worldtpu.parallel import batch as B
    from worldtpu.synthesis import synthesis as S

    runtime.setup_compile_cache()
    device = runtime.device_info()
    device["nvidia_smi"] = runtime.gpu_name_and_power_limit()
    work = pathlib.Path(tempfile.mkdtemp(prefix="worldtpu_bench_"))
    bench_bin, dump_bin = build_reference()
    configs = {}
    quality = {}

    # ---- shared single utterance: 3 s 16 kHz (configs 1-3) ----
    fs1 = 16000
    x1 = synth_utterance(fs1, 3.0, 160.0, 0)
    wav_io.wavwrite(work / "u16.wav", x1.astype(np.float64), fs1)
    ref1 = measure_reference(bench_bin, work / "u16.wav", work)

    hk1 = HarvestKernel(fs1, len(x1), f0_floor=40.0)
    ck1 = CheapTrickKernel(fs1)
    x1_dev = jax.device_put(jnp.asarray(x1))
    jax.block_until_ready(x1_dev)

    f0_ours, tpos_ours = hk1.compute(x1_dev, dtype=jnp.float32)
    F1 = len(f0_ours)
    f0_dev = jax.device_put(jnp.asarray(f0_ours, jnp.float32))
    tp_dev = jax.device_put(jnp.asarray(tpos_ours, jnp.float32))

    if "1" in CONFIGS:
        from worldtpu.analysis import harvest as H1
        w = best_wall(lambda: hk1.compute(x1_dev, dtype=jnp.float32))
        n_out1a = hk1.get_samples()
        mean0a = jnp.zeros((), jnp.float32)
        wa = amortized_wall(lambda: H1.harvest_device_full(
            x1_dev, mean0a, geo=hk1.geo, n_out=n_out1a, chunk=64))
        configs["1_harvest_3s_16k"] = {
            "rtf": round(3.0 / w, 2),
            "rtf_amortized": round(3.0 / wa, 2),
            "cpp_rtf": round(3.0 / ref1["harvest"], 2) if ref1 else None}

    if "2" in CONFIGS:
        def run2():
            out = cheaptrick_frames(
                x1_dev, f0_dev, tp_dev, fs=fs1, fft_size=ck1.fft_size,
                max_half_window=ck1.max_half_window)
            jax.block_until_ready(out)
            return out
        w = best_wall(run2)
        wa = amortized_wall(lambda: cheaptrick_frames(
            x1_dev, f0_dev, tp_dev, fs=fs1, fft_size=ck1.fft_size,
            max_half_window=ck1.max_half_window))
        configs["2_cheaptrick_3s_16k"] = {
            "rtf": round(3.0 / w, 2),
            "rtf_amortized": round(3.0 / wa, 2),
            "cpp_rtf": round(3.0 / ref1["cheaptrick"], 2) if ref1 else None}

    if "3" in CONFIGS:
        n_ap = codec.get_number_of_aperiodicities(fs1)

        def run3():
            ap = d4c_frames(x1_dev, f0_dev, tp_dev, fs=fs1,
                            fft_size_out=ck1.fft_size)
            cap = codec.code_aperiodicity(ap, fs=fs1, fft_size=ck1.fft_size)
            dap = codec.decode_aperiodicity(cap, fs=fs1,
                                            fft_size=ck1.fft_size)
            spec = cheaptrick_frames(
                x1_dev, f0_dev, tp_dev, fs=fs1, fft_size=ck1.fft_size,
                max_half_window=ck1.max_half_window)
            cse = codec.code_spectral_envelope(
                spec, fs=fs1, fft_size=ck1.fft_size, n_dims=32)
            dse = codec.decode_spectral_envelope(
                cse, fs=fs1, fft_size=ck1.fft_size, n_dims=32)
            jax.block_until_ready((dap, dse))
            return dap
        def disp3():
            ap = d4c_frames(x1_dev, f0_dev, tp_dev, fs=fs1,
                            fft_size_out=ck1.fft_size)
            cap = codec.code_aperiodicity(ap, fs=fs1, fft_size=ck1.fft_size)
            dap = codec.decode_aperiodicity(cap, fs=fs1,
                                            fft_size=ck1.fft_size)
            spec = cheaptrick_frames(
                x1_dev, f0_dev, tp_dev, fs=fs1, fft_size=ck1.fft_size,
                max_half_window=ck1.max_half_window)
            cse = codec.code_spectral_envelope(
                spec, fs=fs1, fft_size=ck1.fft_size, n_dims=32)
            dse = codec.decode_spectral_envelope(
                cse, fs=fs1, fft_size=ck1.fft_size, n_dims=32)
            return dap, dse

        def run3_d4c_only():
            ap = d4c_frames(x1_dev, f0_dev, tp_dev, fs=fs1,
                            fft_size_out=ck1.fft_size)
            jax.block_until_ready(ap)
            return ap

        w = best_wall(run3)
        wa = amortized_wall(disp3)
        w_d4c = best_wall(run3_d4c_only)
        wa_d4c = amortized_wall(lambda: d4c_frames(
            x1_dev, f0_dev, tp_dev, fs=fs1, fft_size_out=ck1.fft_size))
        configs["3_d4c_codec_3s_16k"] = {
            # like-for-like vs cpp_rtf (D4C compute alone)
            "rtf_d4c_only": round(3.0 / w_d4c, 2),
            "rtf_d4c_only_amortized": round(3.0 / wa_d4c, 2),
            # the full config-3 pipeline (D4C + aperiodicity codec
            # round-trip + CheapTrick + envelope codec round-trip)
            "rtf": round(3.0 / w, 2),
            "rtf_amortized": round(3.0 / wa, 2),
            "cpp_rtf": round(3.0 / ref1["d4c"], 2) if ref1 else None}

    # ---- compiled refine kernel vs the dense refine on the card, same
    #      deduplicated candidates: a compile divergence fails here instead
    #      of surfacing as unexplained F0 drift ----
    kernel_parity = {}
    if os.environ.get("WORLDTPU_BENCH_KERNEL_PARITY", "1") != "0":
        from worldtpu.analysis import harvest as H
        from worldtpu.ops.refine_kernel import refine_stage_triton

        geo1 = hk1.geo
        y1 = H.decimate_stage(x1_dev, ratio=geo1.ratio,
                              y_length=geo1.y_length)
        tpos1 = jnp.arange(geo1.f0_length, dtype=jnp.float32) / 1000.0
        cand1 = H.dedup_candidates(H.candidates_stage(
            y1, jnp.zeros((), jnp.float32), tpos1, geo=geo1)[0])
        r_k, _ = refine_stage_triton(y1, cand1, tpos1, geo=geo1)
        with jax.default_matmul_precision("highest"):
            r_d, _ = H.refine_stage(y1, cand1, tpos1, geo=geo1, chunk=32)
        r_k, r_d = np.asarray(r_k), np.asarray(r_d)
        dd = np.abs(r_k - r_d)[(r_k > 0) | (r_d > 0)]
        kernel_parity["refine_frac_gt_0.1hz"] = round(float(
            np.mean(dd > 0.1)), 5) if dd.size else 0.0
        kernel_parity["refine_p999_hz"] = round(float(
            np.quantile(dd, 0.999)), 5) if dd.size else 0.0
        # knife edges (score 2.5 / floor / ceil gates) allowed at a
        # bounded rate; not assert: must survive python -O
        if kernel_parity["refine_frac_gt_0.1hz"] >= 0.02:
            raise RuntimeError(f"kernel parity gate: refine: "
                               f"{kernel_parity}")

    # ---- quality vs reference dumps: >= 4 utterances (synthetic vowel,
    #      diverse speech-shaped, pathological creak/fry/diplophonia, and
    #      a real recording), per-utterance + mean + worst-case ----
    if dump_bin is not None \
            and os.environ.get("WORLDTPU_BENCH_QUALITY", "1") != "0":
        qutts = [("vowel", work / "u16.wav")]
        try:
            # seed 102: the reference BINARY segfaults/aborts on several
            # diverse seeds (101/103 segv, 105 abort — a C++ Harvest
            # overrun on silence-heavy multi-section audio that worldtpu
            # handles; see ROADMAP r5); quality needs a seed the oracle
            # survives
            p = work / "qdiv.wav"
            wav_io.wavwrite(
                p, synth_utterance_diverse(fs1, 102).astype(np.float64),
                fs1)
            qutts.append(("diverse", p))
            p = work / "qpath.wav"
            wav_io.wavwrite(
                p,
                synth_utterance_pathological(fs1, 202).astype(np.float64),
                fs1)
            qutts.append(("pathological", p))
            if REAL_RECORDING.exists():
                # transcode: the C++ wav reader rejects the original 8-bit
                # container variant; rewrite preserves the recorded content
                xr, fsr, _ = wav_io.wavread(REAL_RECORDING)
                p = work / "qreal.wav"
                wav_io.wavwrite(p, np.asarray(xr, np.float64), fsr)
                qutts.append(("real_recording", p))
        except Exception:
            pass

        per_utt = {}
        for qname, qpath in qutts:
            try:
                pre = work / f"q_{qname}"
                subprocess.run(
                    [str(dump_bin), str(qpath), str(pre), "5.0"],
                    check=True, capture_output=True, timeout=600,
                    cwd=str(work))
                f0_ref, _, _ = params_io.read_f0(f"{pre}.f0")
                spec_ref, _ = params_io.read_spectral_envelope(
                    f"{pre}.spec")
                xq, fsq, _ = wav_io.wavread(qpath)
                xq = np.asarray(xq, np.float32)
                hkq = HarvestKernel(fsq, len(xq), f0_floor=40.0)
                ckq = CheapTrickKernel(fsq)
                xq_dev = jax.device_put(jnp.asarray(xq))
                f0q, tposq = hkq.compute(xq_dev, dtype=jnp.float32)
                specq = np.asarray(cheaptrick_frames(
                    xq_dev, jnp.asarray(f0q, jnp.float32),
                    jnp.asarray(tposq, jnp.float32), fs=fsq,
                    fft_size=ckq.fft_size,
                    max_half_window=ckq.max_half_window))
                per_utt[qname] = quality_metrics(
                    f0q, f0_ref, specq, spec_ref)
            except Exception as e:  # per-utterance best-effort
                per_utt[qname] = {"error": str(e)[:120]}

        ok = {k: v for k, v in per_utt.items() if "error" not in v}
        if ok:
            quality = dict(ok.get("vowel") or next(iter(ok.values())))
            quality["per_utterance"] = per_utt
            quality["n_utterances"] = len(ok)
            quality["mean_f0_rmse_hz"] = round(float(np.mean(
                [v["f0_rmse_hz"] for v in ok.values()])), 6)
            quality["worst_f0_rmse_hz"] = round(float(np.max(
                [v["f0_rmse_hz"] for v in ok.values()])), 6)
            quality["worst_vuv_agreement"] = round(float(np.min(
                [v["vuv_agreement"] for v in ok.values()])), 4)
            quality["worst_mcd_db"] = round(float(np.max(
                [v["mcd_db"] for v in ok.values()])), 6)
            # hard gates (VERDICT r4 item 4): the established vowel case
            # must hold its measured margins — a silent regression fails
            # the bench instead of being absorbed
            v0 = ok.get("vowel")
            if v0 is not None:
                if v0["vuv_agreement"] < 0.998:
                    raise RuntimeError(f"quality gate: vowel vuv "
                                       f"{v0['vuv_agreement']} < 0.998")
                if v0["f0_rmse_hz"] > 0.5:
                    raise RuntimeError(f"quality gate: vowel f0 rmse "
                                       f"{v0['f0_rmse_hz']} > 0.5 Hz")
                if v0["mcd_db"] > 0.1:
                    raise RuntimeError(f"quality gate: vowel mcd "
                                       f"{v0['mcd_db']} > 0.1 dB")
        else:
            quality = {"error": "no quality utterance succeeded",
                       "per_utterance": per_utt}

    # ---- config 4: single 48 kHz copy-synthesis ----
    if "4" in CONFIGS:
        fs4 = 48000
        x4 = synth_utterance(fs4, 3.0, 180.0, 4)
        wav_io.wavwrite(work / "u48.wav", x4.astype(np.float64), fs4)
        ref4 = measure_reference(bench_bin, work / "u48.wav", work)
        hk4 = HarvestKernel(fs4, len(x4), f0_floor=40.0)
        ck4 = CheapTrickKernel(fs4)
        x4_dev = jax.device_put(jnp.asarray(x4)[None])
        jax.block_until_ready(x4_dev)
        F4 = hk4.get_samples()
        out_len4 = int((F4 - 1) * 0.005 * fs4) + 1
        # static (data-independent) pulse bound — the timed path is fully
        # self-contained on unseen audio; overflow is flagged in-program
        mp4 = S.capacity_max_pulses(out_len4, fs4)
        noise4 = S.make_noise(jax.random.PRNGKey(1), mp4, ck4.fft_size,
                              jnp.float32)[None]

        def run4():
            # the fused single-dispatch wav->wav program (F0 never visits
            # the host) — one dispatch + one download per utterance
            y, _, ovf = B.batch_wav_to_wav(
                x4_dev, noise4, geo=hk4.geo, fs=fs4,
                fft_size=ck4.fft_size, max_half_window=ck4.max_half_window,
                frame_period_s=0.005, out_length=out_len4, max_pulses=mp4,
                mesh=None, return_overflow=True)
            jax.block_until_ready(y)
            return y, ovf
        if np.asarray(run4()[1]).any():   # not assert: must survive -O
            raise RuntimeError("config 4: static pulse capacity overflowed")
        w = best_wall(run4)
        wa = amortized_wall(lambda: B.batch_wav_to_wav(
            x4_dev, noise4, geo=hk4.geo, fs=fs4,
            fft_size=ck4.fft_size, max_half_window=ck4.max_half_window,
            frame_period_s=0.005, out_length=out_len4, max_pulses=mp4,
            mesh=None)[0])
        configs["4_copysyn_3s_48k"] = {
            "rtf": round(3.0 / w, 2),
            "rtf_amortized": round(3.0 / wa, 2),
            "cpp_rtf": round(3.0 / ref4["total"], 2) if ref4 else None}

    # ---- config 5 (headline): batched corpus copy-synthesis with
    #      pitch/duration manipulation, streamed via io.corpus ----
    #
    # WORLDTPU_BENCH_CORPUS=<dir> streams a real wav directory (variable
    # lengths; batches grouped by length by the loader); otherwise an
    # LJSpeech-like synthetic corpus is generated.  The timed path includes
    # the device->host download and CorpusBatch.slice_outputs (the
    # production IO step), overlapped with the next batch's compute via
    # async dispatch.
    rtf5 = None
    cpp_rtf5 = None
    if "5" in CONFIGS:
        n_batch = int(os.environ.get("WORLDTPU_BENCH_BATCH", "8"))
        n_utts = int(os.environ.get("WORLDTPU_BENCH_UTTS", str(2 * n_batch)))
        corpus_env = os.environ.get("WORLDTPU_BENCH_CORPUS")
        if corpus_env and pathlib.Path(corpus_env).is_dir():
            cdir = pathlib.Path(corpus_env)
            corpus_src = str(cdir)
            fs5 = None  # taken from the corpus files
        else:
            # variable-length, silence-/onset-heavy, multi-speaker corpus:
            # length diversity exercises batch re-padding, multiple compiled
            # shapes, and slice_outputs in the timed path
            fs5 = 22050
            cdir = work / "corpus"
            cdir.mkdir()
            for i in range(n_utts):
                wav_io.wavwrite(
                    cdir / f"lj{i:03d}.wav",
                    synth_utterance_diverse(fs5, i).astype(np.float64), fs5)
            corpus_src = "synthetic-diverse"

        batches = corpus_io.load_corpus(cdir, batch_size=n_batch,
                                        pad_to=4096, frames_to=16)
        fs5 = batches[0].fs
        first_wav = corpus_io.scan_corpus(cdir)[0]
        ref5 = measure_reference(bench_bin, first_wav, work)
        ref5_len = wav_io.wav_info(first_wav)[0] / fs5
        cpp_rtf5 = round(ref5_len / ref5["total"], 2) if ref5 else None

        # duration manipulation: resynthesize at 1.25x length (frame period
        # 6.25 ms at synthesis; reference analog: test.cpp's
        # ParameterModification changes f0/formants, duration scaling is the
        # frame_period counterpart)
        pitch_scale = 1.2
        dur_scale = 1.25
        ck5 = CheapTrickKernel(fs5)
        kernels = {}   # T -> HarvestKernel
        prepped = []   # (batch, x_dev, noise, mp, out_len)
        audio_seconds = 0.0
        for b in batches:
            T = b.x.shape[1]
            if T not in kernels:
                kernels[T] = HarvestKernel(fs5, T, f0_floor=40.0)
            hk = kernels[T]
            x_dev = jax.device_put(jnp.asarray(b.x))
            jax.block_until_ready(x_dev)
            out_len = int((b.F - 1) * 0.005 * dur_scale * fs5) + 1
            # static (data-independent) pulse capacity: the timed path is
            # self-contained on unseen audio — no F0 prepass; the program
            # flags overflow (checked after the run).  256-quantized so
            # length-diverse batches share compiled programs.  The voiced
            # f0 cap scales with the pitch manipulation (real corpora can
            # voice near the 500 Hz cap; scaled that exceeds the default).
            mp = S.capacity_max_pulses(
                out_len, fs5, f0_cap=C.DEFAULT_F0 * pitch_scale)
            noise = S.make_noise(
                jax.random.PRNGKey(0), b.x.shape[0] * mp, ck5.fft_size,
                jnp.float32).reshape(b.x.shape[0], mp, -1)
            prepped.append((b, x_dev, noise, mp, out_len))
            audio_seconds += float(b.lengths[b.valid].sum()) / fs5

        def run_batch(item):
            b, x_dev, noise, mp, out_len = item
            hk = kernels[x_dev.shape[1]]
            y, _, ovf = B.batch_wav_to_wav(
                x_dev, noise, geo=hk.geo, fs=fs5,
                fft_size=ck5.fft_size,
                max_half_window=ck5.max_half_window,
                frame_period_s=0.005 * dur_scale,
                out_length=out_len, max_pulses=mp,
                mesh=None, pitch_scale=pitch_scale,
                return_overflow=True)
            return y, ovf

        def pipeline(cycles=1):
            """Stream every batch `cycles` times; the download + unpad of
            batch k overlaps batch k+1's dispatched compute."""
            outs = []
            ovfs = []
            pending = None  # (CorpusBatch, device y)
            for _ in range(cycles):
                for item in prepped:
                    y, ovf = run_batch(item)
                    y.copy_to_host_async()
                    ovf.copy_to_host_async()   # overlapped like y
                    ovfs.append(ovf)
                    if pending is not None:
                        outs.extend(pending[0].slice_outputs(pending[1]))
                    pending = (item[0], y)
            outs.extend(pending[0].slice_outputs(pending[1]))
            if any(np.asarray(o).any() for o in ovfs):  # survive python -O
                raise RuntimeError(
                    "config 5: static pulse capacity overflowed")
            return outs

        outs = pipeline(1)  # compile + warm
        assert all(np.isfinite(o).all() for o in outs), "non-finite output"
        n_cycles = 3 if len(prepped) == 1 else 1
        import contextlib
        prof_dir = os.environ.get("WORLDTPU_BENCH_PROFILE")
        prof_ctx = (jax.profiler.trace(prof_dir) if prof_dir
                    else contextlib.nullcontext())
        walls = []
        with prof_ctx:
            for _ in range(2):
                t0 = time.time()
                pipeline(n_cycles)
                walls.append(time.time() - t0)
        rtf5 = round(n_cycles * audio_seconds / min(walls), 2)
        configs["5_corpus_pitch_duration_8x3s_22k"] = {
            "rtf": rtf5, "cpp_rtf": cpp_rtf5,
            "pitch_scale": pitch_scale, "duration_scale": dur_scale,
            "corpus": corpus_src, "n_utterances": sum(
                int(b.valid.sum()) for b in batches),
            "audio_seconds": round(audio_seconds, 2)}

    headline = rtf5 if rtf5 is not None else max(
        (c["rtf"] for c in configs.values()), default=0.0)
    base = cpp_rtf5 or FALLBACK_CPP_RTF
    print(json.dumps({
        "metric": "analysis+resynthesis real-time factor per chip "
                  "(corpus stream with pitch/duration manipulation, "
                  "variable-length multi-speaker 22.05kHz batches, "
                  "float32, full Harvest+CheapTrick+D4C+Synthesis, "
                  "self-contained timed path)",
        "value": headline,
        "unit": "x realtime",
        "vs_baseline": round(headline / base, 2),
        "configs": configs,
        "quality": quality,
        "kernel_parity": kernel_parity,
        "cpp_baseline_measured": bench_bin is not None,
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
