"""D4C parity vs the C++ reference fixtures."""

import numpy as np
import jax.numpy as jnp
import pytest

from conftest import load_fixture
from worldtpu.analysis.d4c import d4c_frames


@pytest.mark.parametrize("name", ["t16", "t48", "t22"])
def test_d4c_parity(name):
    f = load_fixture(name)
    got = np.asarray(d4c_frames(
        jnp.asarray(f.x), jnp.asarray(f.f0), jnp.asarray(f.tpos),
        fs=f.fs, fft_size_out=f.fft_size))
    want = f.ap
    err = np.abs(got - want)
    # the reference injects ~1e-12 randn dither into its windowed waveforms;
    # aperiodicity is bounded in (0,1], so absolute error is the right gauge
    assert np.quantile(err, 0.999) < 1e-6, (
        f"q999={np.quantile(err, 0.999)}, max={err.max()}")
    assert err.max() < 1e-3, f"max err {err.max()}"


def test_d4c_float32_underflow_is_finite():
    """f32 production path: a near-pure tone underflows high-frequency
    smoothed-power bins to exactly 0; the group-delay divide must not turn
    that into inf/NaN aperiodicity (regression: corpus utterances went NaN
    mid-stream)."""
    import jax

    fs = 16000
    t = np.arange(int(fs * 1.1)) / fs
    rng = np.random.RandomState(0)
    x = (0.4 * np.sin(2 * np.pi * 190 * t)
         + 0.2 * np.sin(2 * np.pi * 380 * t)
         + 0.005 * rng.randn(len(t))).astype(np.float32)
    F = int(1000 * len(x) / fs / 5.0) + 1
    f0 = np.full(F, 190.0, np.float32)
    tpos = (np.arange(F) * 0.005).astype(np.float32)
    ap = np.asarray(d4c_frames(
        jnp.asarray(x), jnp.asarray(f0), jnp.asarray(tpos),
        fs=fs, fft_size_out=1024))
    assert ap.dtype == np.float32
    assert np.all(np.isfinite(ap)), "non-finite aperiodicity in f32 path"
    assert np.all((ap > 0) & (ap <= 1.0))


@pytest.mark.parametrize("name", ["t16", "t48", "t22"])
def test_d4c_dithered_parity(name):
    """With the exact xorshift dither stream (continued from CheapTrick's
    consumption, matching the reference demo's single-threaded call order),
    D4C parity is FFT-backend-limited (~1e-12).  Stream sites:
    /root/reference/src/d4c.cpp:291 via loveTrain (:216), the two centroids
    (:417-420), and the smoothed power spectrum (:488); frames skipped by
    the LoveTrain threshold draw nothing (:147)."""
    from worldtpu.analysis import dither as D
    from worldtpu.analysis.cheaptrick import CheapTrickKernel
    from worldtpu.analysis.d4c import (
        love_train_ap0, d4c_max_half_lt, d4c_max_half_c)

    f = load_fixture(name)
    kern = CheapTrickKernel(f.fs, f0_floor=71.0)
    _, _, gen = D.cheaptrick_dither(
        f.f0, f.fs, kern.fft_size, kern.max_half_window)
    lt, gen = D.d4c_love_train_dither(f.f0, f.fs, d4c_max_half_lt(f.fs), gen)
    ap0 = np.asarray(love_train_ap0(
        jnp.asarray(f.x), jnp.asarray(f.f0), jnp.asarray(f.tpos), fs=f.fs,
        lt_dither=jnp.asarray(lt)))
    active = (f.f0 != 0) & (ap0 > 0.85)
    c1, c2, h, gen = D.d4c_body_dither(
        f.f0, active, f.fs, d4c_max_half_c(f.fs), gen)
    got = np.asarray(d4c_frames(
        jnp.asarray(f.x), jnp.asarray(f.f0), jnp.asarray(f.tpos),
        fs=f.fs, fft_size_out=f.fft_size,
        lt_dither=jnp.asarray(lt), c1_dither=jnp.asarray(c1),
        c2_dither=jnp.asarray(c2), h_dither=jnp.asarray(h)))
    err = np.abs(got - f.ap)
    assert err.max() < 1e-10, f"max abs err {err.max()}"


def test_d4c_low_f0_shifted_centroid_no_truncation():
    """The gather-free shifted centroid must equal the literal windowed
    path even when a near-floor f0 pushes the +0.25/f0-shifted window past
    fft_d4c segment samples (regression: rfft(n=fft_d4c) silently truncated
    the tail; the fix folds it back circularly)."""
    import jax.numpy as jnp
    import numpy as np
    from worldtpu.analysis.d4c import d4c_frames, d4c_max_half_c

    fs = 22050
    dur = 1.0
    n = int(fs * dur)
    t = np.arange(n) / fs
    f0v = 48.0
    x = np.sin(2 * np.pi * f0v * t) + 0.3 * np.sin(4 * np.pi * f0v * t)
    x = (x * 0.4).astype(np.float64)
    F = 1 + int(dur / 0.005)
    tpos = np.arange(F) * 0.005
    f0 = np.full(F, f0v)

    kw = dict(fs=fs, fft_size_out=2048)
    ap_fast = np.asarray(d4c_frames(
        jnp.asarray(x), jnp.asarray(f0), jnp.asarray(tpos), **kw))
    zeros = jnp.zeros((F, 2 * d4c_max_half_c(fs) + 1))
    ap_lit = np.asarray(d4c_frames(
        jnp.asarray(x), jnp.asarray(f0), jnp.asarray(tpos),
        c1_dither=zeros, c2_dither=zeros, **kw))
    np.testing.assert_allclose(ap_fast, ap_lit, rtol=2e-4, atol=2e-6)


def test_approx_max_k_exact_top_set():
    """The pinned recall_target in the f32 coarse-aperiodicity path must
    recover the exact top-(boundary+1) sum on adversarial spectra: 60
    decades of dynamic range plus k-way near-ties (VERDICT r2 item 5;
    reference exact semantics: /root/reference/src/d4c.cpp:494-499).

    On CPU and GPU approx_max_k lowers to exact top_k, so this pins the
    API contract on every supported backend.
    """
    import jax

    k = 31
    rng = np.random.RandomState(7)
    base = 10.0 ** rng.uniform(-30, 30, size=(512, 1025))
    ties = base.copy()
    ties[:, 100:100 + k] = ties[:, 99:100]  # k near-identical top values
    for arr in (base, ties):
        x = jnp.asarray(arr, jnp.float32)
        exact = jnp.sum(jax.lax.top_k(x, k)[0], axis=-1)
        approx = jnp.sum(
            jax.lax.approx_max_k(x, k, recall_target=0.95)[0], axis=-1)
        np.testing.assert_array_equal(np.asarray(exact), np.asarray(approx))
