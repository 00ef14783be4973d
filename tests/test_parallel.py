"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import load_fixture
from worldtpu.analysis.cheaptrick import CheapTrickKernel
from worldtpu.parallel import batch as B
from worldtpu.synthesis import synthesis as S

pytestmark = pytest.mark.slow


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def _setup_batch(f, n_rep=8):
    kern = CheapTrickKernel(f.fs)
    F = len(f.f0)
    # pad frames to a multiple of the time axis (2)
    Fp = F + (-F) % 2
    f0 = np.zeros((n_rep, Fp))
    f0[:, :F] = f.f0
    x = np.tile(f.x, (n_rep, 1))
    tpos = np.arange(Fp) * 0.005
    out_length = int((Fp - 1) * 0.005 * f.fs) + 1
    mp = S.default_max_pulses(out_length, f.fs)
    noise = S.make_noise(jax.random.PRNGKey(0), mp, kern.fft_size,
                         jnp.float64)
    noise = jnp.tile(noise[None], (n_rep, 1, 1))
    return kern, x, f0, tpos, out_length, mp, noise


def test_batch_copy_synthesis_sharded_matches_single():
    f = load_fixture("t22")
    kern, x, f0, tpos, out_length, mp, noise = _setup_batch(f)
    mesh = B.make_mesh(n_data=4, n_time=2)

    y, spec, ap = B.batch_copy_synthesis(
        jnp.asarray(x), jnp.asarray(f0), jnp.asarray(tpos), noise,
        fs=f.fs, fft_size=kern.fft_size,
        max_half_window=kern.max_half_window, frame_period_s=0.005,
        out_length=out_length, max_pulses=mp, mesh=mesh)

    y1, spec1, ap1 = B.batch_copy_synthesis(
        jnp.asarray(x[:1]), jnp.asarray(f0[:1]), jnp.asarray(tpos),
        noise[:1], fs=f.fs, fft_size=kern.fft_size,
        max_half_window=kern.max_half_window, frame_period_s=0.005,
        out_length=out_length, max_pulses=mp, mesh=None)

    assert y.shape == (8, out_length)
    # all batch rows identical inputs -> identical outputs
    np.testing.assert_allclose(np.asarray(y[3]), np.asarray(y[0]),
                               rtol=0, atol=0)
    # sharded result == unsharded result
    np.testing.assert_allclose(np.asarray(y[0]), np.asarray(y1[0]),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(spec[0]), np.asarray(spec1[0]),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ap[0]), np.asarray(ap1[0]),
                               rtol=1e-9, atol=1e-12)


def test_data_only_mesh():
    f = load_fixture("t22")
    kern, x, f0, tpos, out_length, mp, noise = _setup_batch(f)
    mesh = B.make_mesh(n_data=8, n_time=1)
    y, _, _ = B.batch_copy_synthesis(
        jnp.asarray(x), jnp.asarray(f0), jnp.asarray(tpos), noise,
        fs=f.fs, fft_size=kern.fft_size,
        max_half_window=kern.max_half_window, frame_period_s=0.005,
        out_length=out_length, max_pulses=mp, mesh=mesh)
    assert bool(jnp.all(jnp.isfinite(y)))


def test_batch_harvest_sharded_matches_single():
    """Sharded wav->candidates Harvest (band + frame axes over 'time',
    utterances over 'data') == the single-device fused stages, bitwise."""
    from worldtpu.analysis import harvest as H

    f = load_fixture("t16")
    fs = f.fs
    T = len(f.x)
    geo = H.HarvestGeometry(fs, T)
    x = np.tile(np.asarray(f.x, np.float32), (4, 1))
    # two distinct rows so dp sharding is actually exercised
    x[1] *= 0.5
    x[3] *= 0.25
    mesh = B.make_mesh(n_data=4, n_time=2)

    flat_sh = B.batch_harvest_device_stages(
        jnp.asarray(x), geo=geo, mesh=mesh, chunk=16)

    flat_1 = H.harvest_device_stages_batch(
        jnp.asarray(x), jnp.zeros((4,), jnp.float32), geo, 16, 1)

    np.testing.assert_array_equal(np.asarray(flat_sh), np.asarray(flat_1))


def test_wav_to_wav_sharded():
    """Full wav -> f0 (sharded Harvest + host contour) -> wav (sharded
    copy-synthesis): the complete multi-chip pipeline."""
    from worldtpu.analysis import harvest as H

    f = load_fixture("t16")
    fs = f.fs
    T = len(f.x)
    x = np.tile(np.asarray(f.x, np.float32), (4, 1))
    mesh = B.make_mesh(n_data=4, n_time=2)

    hk = H.HarvestKernel(fs, T)
    geo = hk.geo
    flat = np.asarray(B.batch_harvest_device_stages(
        jnp.asarray(x), geo=geo, mesh=mesh, chunk=16)).astype(np.float64)
    f0s = []
    n_out = hk.get_samples()
    for i in range(4):
        f0_i, _ = hk._finish(flat[i])
        f0s.append(f0_i)
    f0 = np.stack(f0s)
    assert f0.shape == (4, n_out)
    # production f32 harvest should stay close to the f64 golden contour
    v = f.f0 > 0
    rmse = np.sqrt(np.mean((f0[0][v] - f.f0[v]) ** 2))
    assert rmse < 1.0, rmse

    kern = CheapTrickKernel(fs)
    F = n_out + (-n_out) % 2
    f0p = np.zeros((4, F), np.float32)
    f0p[:, :n_out] = f0
    tpos = np.arange(F) * 0.005
    out_length = int((F - 1) * 0.005 * fs) + 1
    mp = S.default_max_pulses(out_length, fs)
    noise = S.make_noise(jax.random.PRNGKey(0), mp, kern.fft_size,
                         jnp.float32)
    noise = jnp.tile(noise[None], (4, 1, 1))
    y, _, _ = B.batch_copy_synthesis(
        jnp.asarray(x), jnp.asarray(f0p), jnp.asarray(tpos, jnp.float32),
        noise, fs=fs, fft_size=kern.fft_size,
        max_half_window=kern.max_half_window, frame_period_s=0.005,
        out_length=out_length, max_pulses=mp, mesh=mesh)
    y = np.asarray(y)
    assert y.shape == (4, out_length)
    assert np.all(np.isfinite(y))
    assert np.sqrt(np.mean(y[0] ** 2)) > 0.05


def test_batch_harvest_f0_device_contour_sharded():
    """Sharded all-device wav->F0 (device stages + device contour under the
    mesh) == unsharded compute_batch with device contour."""
    from worldtpu.analysis import harvest as H

    f = load_fixture("t16")
    fs = f.fs
    T = len(f.x)
    x = np.tile(np.asarray(f.x, np.float32), (4, 1))
    x[1] *= 0.5
    x[3] *= 0.25
    mesh = B.make_mesh(n_data=4, n_time=2)

    hk = H.HarvestKernel(fs, T)
    n_out = hk.get_samples()
    f0_sh = np.asarray(B.batch_harvest_f0(
        jnp.asarray(x), geo=hk.geo, n_out=n_out, mesh=mesh, chunk=16))
    res = hk.compute_batch(x, contour_on="device", chunk=16)
    f0_1 = np.stack([r[0] for r in res])
    assert f0_sh.shape == (4, n_out)
    np.testing.assert_allclose(f0_sh, f0_1, rtol=0, atol=1e-4)
    v = f.f0 > 0
    rmse = np.sqrt(np.mean((f0_sh[0][v] - f.f0[v]) ** 2))
    assert rmse < 1.0, rmse


def test_batch_wav_to_wav_one_dispatch():
    """Flagship one-dispatch wav->wav with pitch/duration modification,
    sharded == unsharded."""
    from worldtpu.analysis import harvest as H

    f = load_fixture("t16")
    fs = f.fs
    T = len(f.x)
    x = np.tile(np.asarray(f.x, np.float32), (4, 1))
    x[1] *= 0.5
    hk = H.HarvestKernel(fs, T)
    kern = CheapTrickKernel(fs)
    n_out = hk.get_samples()
    F = n_out
    out_length = int((F - 1) * 0.005 * 1.25 * fs) + 1
    mp = S.default_max_pulses(out_length, fs)
    noise = S.make_noise(jax.random.PRNGKey(0), mp, kern.fft_size,
                         jnp.float32)
    noise = jnp.tile(noise[None], (4, 1, 1))
    kw = dict(geo=hk.geo, fs=fs, fft_size=kern.fft_size,
              max_half_window=kern.max_half_window,
              frame_period_s=0.005 * 1.25, out_length=out_length,
              max_pulses=mp, chunk=16, pitch_scale=1.2)
    y1, f01 = B.batch_wav_to_wav(jnp.asarray(x), noise, mesh=None, **kw)
    assert y1.shape == (4, out_length)
    assert bool(jnp.all(jnp.isfinite(y1)))
    assert float(jnp.max(jnp.abs(y1))) > 0.01
    mesh = B.make_mesh(n_data=4, n_time=2)
    y2, f02 = B.batch_wav_to_wav(jnp.asarray(x), noise, mesh=mesh, **kw)
    np.testing.assert_allclose(np.asarray(f02), np.asarray(f01),
                               rtol=0, atol=1e-4)
    # waveforms: V/UV knife-edges can flip single pulses; compare
    # short-time RMS profiles
    w = 160
    n = (out_length // w) * w
    r1 = np.sqrt(np.mean(np.asarray(y1)[:, :n].reshape(4, -1, w) ** 2, -1))
    r2 = np.sqrt(np.mean(np.asarray(y2)[:, :n].reshape(4, -1, w) ** 2, -1))
    np.testing.assert_allclose(r2, r1, atol=0.02)


def test_distributed_single_process():
    """Multi-host entry point degrades to a no-op single-process setup:
    init is idempotent, the global mesh covers the virtual devices, and
    process-local batches become sharded global arrays."""
    from worldtpu.parallel import (global_mesh, init_distributed,
                                   process_local_batch)

    init_distributed()      # no coordinator configured -> logged no-op
    init_distributed()      # idempotent
    mesh = global_mesh(n_time=2)
    assert mesh.shape["data"] * mesh.shape["time"] == 8
    xb = np.arange(32, dtype=np.float32).reshape(4, 8)
    (gx,) = process_local_batch(mesh, [xb])
    assert gx.shape == (4, 8)
    np.testing.assert_array_equal(np.asarray(gx), xb)
