"""ops.trig seed-and-rotate window evaluation: exactness + consumers.

The f32 production paths of CheapTrick/D4C evaluate their F0-adaptive
windows through ops.trig.cos_affine; these tests pin (1) the helper
against literal jnp.cos at f32 round-off and (2) the consumers' f32
outputs against the literal-f64 parity path on a synthetic utterance.
"""

import numpy as np
import jax.numpy as jnp

from worldtpu.ops import trig


def test_cos_affine_matches_literal():
    rng = np.random.RandomState(0)
    F, W = 64, 2115
    # angle steps matching the real window range: pi*f0*(2/4/fs) for
    # f0 in [40, 800] at fs=22050 -> alpha in [0.0045, 0.23]
    alpha = rng.uniform(0.004, 0.25, F).astype(np.float32)
    beta = (-alpha * rng.randint(0, 1200, F)).astype(np.float32)
    got = np.asarray(trig.cos_affine(jnp.asarray(alpha),
                                     jnp.asarray(beta), W))
    i = np.arange(W, dtype=np.float64)
    want = np.cos(alpha[:, None].astype(np.float64) * i
                  + beta[:, None].astype(np.float64))
    # error budget: f32 argument round-off (alpha*q up to ~300 rad ->
    # ~1.5e-5 arg ulp) plus the 2-term combine's ~2 ulp
    assert np.abs(got - want).max() < 5e-5

    c1, c2 = trig.cos_affine(jnp.asarray(alpha), jnp.asarray(beta), W,
                             second=True)
    want2 = np.cos(2.0 * (alpha[:, None].astype(np.float64) * i
                          + beta[:, None].astype(np.float64)))
    assert np.abs(np.asarray(c2) - want2).max() < 1e-4


def _synthetic(fs, dur=0.6):
    t = np.arange(int(fs * dur)) / fs
    f0_true = 160.0 + 40.0 * np.sin(2 * np.pi * 2.1 * t)
    phase = 2 * np.pi * np.cumsum(f0_true) / fs
    x = (0.6 * np.sin(phase) + 0.25 * np.sin(2 * phase)
         + 0.1 * np.sin(3 * phase)
         + 0.003 * np.random.RandomState(7).randn(len(t)))
    F = int(dur * 1000 / 5) + 1
    tpos = np.arange(F) * 0.005
    f0 = 160.0 + 40.0 * np.sin(2 * np.pi * 2.1 * tpos)
    return x, f0, tpos


def test_cheaptrick_f32_matches_f64():
    from worldtpu.analysis.cheaptrick import CheapTrickKernel

    fs = 22050
    x, f0, tpos = _synthetic(fs)
    kern = CheapTrickKernel(fs, f0_floor=71.0)
    lo = np.asarray(kern(jnp.asarray(x, jnp.float32),
                         jnp.asarray(f0, jnp.float32),
                         jnp.asarray(tpos, jnp.float32)))
    hi = np.asarray(kern(jnp.asarray(x, jnp.float64),
                         jnp.asarray(f0, jnp.float64),
                         jnp.asarray(tpos, jnp.float64)))
    rel = np.abs(lo - hi) / (np.abs(hi) + 1e-12)
    assert np.quantile(rel, 0.99) < 2e-2, np.quantile(rel, 0.99)
    # spectral distortion in dB: the bench MCD gate analogue
    sd = np.sqrt(np.mean((10 * np.log10(lo + 1e-12)
                          - 10 * np.log10(hi + 1e-12)) ** 2))
    assert sd < 0.05, sd


def test_d4c_f32_matches_f64():
    from worldtpu.analysis.d4c import d4c_frames
    from worldtpu.ops.fftutil import fft_size_for_cheaptrick

    fs = 22050
    x, f0, tpos = _synthetic(fs)
    fft_out = fft_size_for_cheaptrick(fs, 71.0)
    lo = np.asarray(d4c_frames(jnp.asarray(x, jnp.float32),
                               jnp.asarray(f0, jnp.float32),
                               jnp.asarray(tpos, jnp.float32),
                               fs=fs, fft_size_out=fft_out))
    hi = np.asarray(d4c_frames(jnp.asarray(x, jnp.float64),
                               jnp.asarray(f0, jnp.float64),
                               jnp.asarray(tpos, jnp.float64),
                               fs=fs, fft_size_out=fft_out))
    assert np.all(np.isfinite(lo))
    # aperiodicity lives in (0, 1]; compare absolutely
    assert np.quantile(np.abs(lo - hi), 0.99) < 2e-2
