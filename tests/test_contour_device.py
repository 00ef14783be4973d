"""Device-side contour chain vs the host oracle.

`analysis.contour_device` re-derives fixF0Contour + smoothF0Contour
(/root/reference/src/harvest.cpp:254-703) as one jittable program; these
tests pin it against the host `analysis.contour` port (itself golden-parity
tested in test_harvest.py) on fixture dumps and synthetic contours, in f64
(expect agreement to solver noise) and f32 (expect sub-0.05 Hz agreement
with identical voicing)."""

import gzip
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from worldtpu.analysis import contour as CH
from worldtpu.analysis import contour_device as CD

from test_harvest import HarvestDump

pytestmark = pytest.mark.slow


def _chain_device(cand, score):
    return CD.smooth_f0_contour(
        CD.fix_step4(CD.fix_step3(CD.fix_step2(CD.fix_step1(
            CD.search_f0_base(cand, score), 0.008), 6),
            cand, score, 0.18), 9))


def _chain_host(cand, score):
    return CH.smooth_f0_contour(CH.fix_f0_contour(cand, score))


def _synth_candidates(F, S, seed):
    r = np.random.RandomState(seed)
    cand = np.zeros((F, S))
    score = np.zeros((F, S))
    t = np.arange(F)
    f0 = 150 + 60 * np.sin(2 * np.pi * t / 500)
    voiced = np.sin(2 * np.pi * t / 700) > -0.4
    for _ in range(6):
        a = r.randint(0, F - 30)
        voiced[a:a + r.randint(2, 25)] = False
    for f in range(F):
        if not voiced[f]:
            if r.rand() < 0.2:
                k = r.randint(1, 4)
                cand[f, :k] = r.uniform(60, 500, k)
                score[f, :k] = r.uniform(0.1, 3, k)
            continue
        k = r.randint(1, min(8, S))
        cand[f, 0] = f0[f] * (1 + 0.003 * r.randn())
        score[f, 0] = 20 + r.rand() * 50
        cand[f, 1:k] = f0[f] * np.exp(0.3 * r.randn(k - 1))
        score[f, 1:k] = r.uniform(0.1, 30, k - 1)
    return cand, score


@pytest.mark.parametrize("name", ["t16", "t22"])
def test_device_contour_fixture_f64(name):
    d = HarvestDump(name)
    got = np.asarray(_chain_device(jnp.asarray(d.cand_prune),
                                   jnp.asarray(d.score_prune)))
    np.testing.assert_allclose(got, d.smoothed, rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", ["t16", "t22"])
def test_device_contour_fixture_f32(name):
    d = HarvestDump(name)
    ref = _chain_host(d.cand_prune, d.score_prune)
    got = np.asarray(_chain_device(
        jnp.asarray(d.cand_prune, jnp.float32),
        jnp.asarray(d.score_prune, jnp.float32)))
    assert np.array_equal(got > 0, ref > 0)
    assert np.abs(got - ref).max() < 0.05


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_contour_synthetic(seed):
    cand, score = _synth_candidates(1501, 28, seed)
    ref = _chain_host(cand, score)
    got = np.asarray(_chain_device(jnp.asarray(cand), jnp.asarray(score)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)


def test_compute_batch_device_contour_matches_host():
    """HarvestKernel.compute_batch contour_on='device' vs 'host' (f32)."""
    from worldtpu.analysis.harvest import HarvestKernel

    fs, dur = 16000, 1.0
    n = int(fs * dur)
    t = np.arange(n) / fs
    f0 = 160 * 2 ** ((30 / 1200) * np.sin(2 * np.pi * 5.0 * t))
    ph = 2 * np.pi * np.cumsum(f0) / fs
    x = sum(np.sin(k * ph) / k for k in range(1, 20))
    x /= np.max(np.abs(x)) * 1.3
    g0, g1 = int(0.4 * n), int(0.5 * n)
    x[g0:g1] = 0.0
    xb = np.stack([x, np.roll(x, 1000)]).astype(np.float32)

    hk = HarvestKernel(fs, n)
    dev = hk.compute_batch(xb, contour_on="device")
    hst = hk.compute_batch(xb, contour_on="host")
    for (fd, td), (fh, th) in zip(dev, hst):
        np.testing.assert_allclose(td, th)
        assert np.array_equal(fd > 0, fh > 0)
        assert np.abs(fd - fh).max() < 0.05
