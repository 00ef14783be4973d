"""Harvest per-stage + end-to-end parity vs the instrumented C++ dumps."""

import gzip
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest

from conftest import load_fixture
from worldtpu.analysis import contour
from worldtpu.analysis import harvest as H

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


class HarvestDump:
    """Parses the probe_harvest.cpp per-stage dump."""

    _cache = {}

    def __init__(self, name):
        raw = gzip.open(FIXTURES / f"{name}.harvest.gz").read()
        o = [0]

        def i32():
            v = int(np.frombuffer(raw[o[0]:o[0] + 4], "<i4")[0])
            o[0] += 4
            return v

        def f64(n):
            v = np.frombuffer(raw[o[0]:o[0] + 8 * n], "<f8").copy()
            o[0] += 8 * n
            return v

        self.fs = i32()
        self.x_length = i32()
        self.ratio = i32()
        self.y_length = i32()
        self.fft_size = i32()
        self.n_channels = i32()
        self.f0_length = i32()
        self.max_candidates = i32()
        self.boundary_f0 = f64(self.n_channels)
        self.y = f64(self.fft_size)
        self.raw = np.stack(
            [f64(self.f0_length) for _ in range(self.n_channels)])
        self.noc = i32()
        F, S = self.f0_length, self.max_candidates
        self.cand_detect = np.stack([f64(S) for _ in range(F)])
        self.cand_overlap = np.stack([f64(S) for _ in range(F)])
        self.cand_refine = np.stack([f64(S) for _ in range(F)])
        self.score_refine = np.stack([f64(S) for _ in range(F)])
        self.cand_prune = np.stack([f64(S) for _ in range(F)])
        self.score_prune = np.stack([f64(S) for _ in range(F)])
        self.base_contour = f64(F)
        self.step1 = f64(F)
        self.step2 = f64(F)
        self.step3 = f64(F)
        self.step4 = f64(F)
        self.smoothed = f64(F)

    @classmethod
    def load(cls, name):
        if name not in cls._cache:
            cls._cache[name] = cls(name)
        return cls._cache[name]


def _geo_and_y(name):
    d = HarvestDump.load(name)
    f = load_fixture(name)
    geo = H.HarvestGeometry(d.fs, d.x_length, f0_floor=40.0)
    assert geo.ratio == d.ratio
    assert geo.y_length == d.y_length
    assert geo.fft_size == d.fft_size
    assert geo.n_channels == d.n_channels
    assert geo.f0_length == d.f0_length
    assert geo.max_candidates == d.max_candidates
    np.testing.assert_allclose(geo.boundary_f0, d.boundary_f0, rtol=1e-13)

    y = H.decimate_stage(jnp.asarray(f.x), ratio=geo.ratio,
                         y_length=geo.y_length)
    return d, f, geo, y


@pytest.mark.parametrize("name", ["t22", "t16"])
def test_decimation_stage(name):
    d, f, geo, y = _geo_and_y(name)
    # dump stores y AFTER (int-truncated) mean removal — which is exactly 0
    got = np.asarray(y)
    np.testing.assert_allclose(got, d.y[:geo.y_length], rtol=1e-9, atol=1e-12)
    assert np.all(d.y[geo.y_length:] == 0.0)


def _remap_to_ref(mine, cb, noc, width):
    """Repack worldtpu's fixed-stride-cb slot layout into the reference's
    dynamic-stride-noc layout (slots beyond noc per layer must be zero)."""
    F = mine.shape[0]
    m = mine.reshape(F, 7, cb)
    assert np.all(m[:, :, noc:] == 0.0)
    packed = m[:, :, :noc].reshape(F, 7 * noc)
    out = np.zeros((F, width), mine.dtype)
    out[:, :7 * noc] = packed
    return out


@pytest.mark.parametrize("name", ["t22", "t16"])
def test_candidates_stage(name):
    d, f, geo, y = _geo_and_y(name)
    tpos = jnp.arange(geo.f0_length, dtype=jnp.float64) / 1000.0
    cand, raw, base = H.candidates_stage(y, 0.0, tpos, geo=geo)
    raw = np.asarray(raw)
    np.testing.assert_allclose(raw, d.raw, rtol=1e-6, atol=1e-8)
    got = _remap_to_ref(np.asarray(cand), geo.cb, d.noc, d.max_candidates)
    np.testing.assert_allclose(got, d.cand_overlap, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("name", ["t22", "t16"])
def test_refine_and_prune_stages(name):
    d, f, geo, y = _geo_and_y(name)
    tpos = jnp.arange(geo.f0_length, dtype=jnp.float64) / 1000.0
    cand, raw, base = H.candidates_stage(y, 0.0, tpos, geo=geo)
    cand, score = H.refine_stage(y, cand, tpos, geo=geo)
    got_c = _remap_to_ref(np.asarray(cand), geo.cb, d.noc, d.max_candidates)
    got_s = _remap_to_ref(np.asarray(score), geo.cb, d.noc, d.max_candidates)
    np.testing.assert_allclose(got_c, d.cand_refine, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_s, d.score_refine, rtol=1e-5, atol=1e-5)
    cand2, score2 = H.remove_unreliable_stage(cand, score)
    got2 = _remap_to_ref(np.asarray(cand2), geo.cb, d.noc, d.max_candidates)
    np.testing.assert_allclose(got2, d.cand_prune, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", ["t22", "t16"])
def test_contour_stages(name):
    d = HarvestDump.load(name)
    base = contour.search_f0_base(d.cand_prune, d.score_prune)
    np.testing.assert_allclose(base, d.base_contour, rtol=1e-9)
    s1 = contour.fix_step1(d.base_contour, 0.008)
    np.testing.assert_allclose(s1, d.step1, rtol=1e-9)
    s2 = contour.fix_step2(d.step1, 6)
    np.testing.assert_allclose(s2, d.step2, rtol=1e-9)
    s3 = contour.fix_step3(d.step2, d.cand_prune, d.score_prune, 0.18)
    np.testing.assert_allclose(s3, d.step3, rtol=1e-9)
    s4 = contour.fix_step4(d.step3, 9)
    np.testing.assert_allclose(s4, d.step4, rtol=1e-9)
    sm = contour.smooth_f0_contour(d.step4)
    np.testing.assert_allclose(sm, d.smoothed, rtol=1e-8, atol=1e-8)


def test_harvest_cos_table_parity():
    """use_cos_table=True against a dedicated C++ dump (t22.f0costab)."""
    import gzip as _gz
    f = load_fixture("t22")
    want = np.frombuffer(
        _gz.open(FIXTURES / "t22.f0costab.gz").read(), "<f8")
    kern = H.HarvestKernel(f.fs, len(f.x), f0_floor=40.0, frame_period=5.0,
                           use_cos_table=True)
    f0, _ = kern.compute(f.x)
    assert len(f0) == len(want)
    rmse = np.sqrt(np.mean((f0 - want) ** 2))
    assert rmse < 1e-6, f"cos-table F0 RMSE {rmse} Hz"


def test_harvest_batch_matches_single():
    f = load_fixture("t22")
    kern = H.HarvestKernel(f.fs, len(f.x), f0_floor=40.0, frame_period=5.0)
    f0_single, tpos = kern.compute(f.x, dtype=jnp.float32)
    outs = kern.compute_batch(np.tile(f.x, (3, 1)))
    for f0_b, tpos_b in outs:
        np.testing.assert_allclose(f0_b, f0_single, rtol=0, atol=0)
    # pipelined corpus API yields the same results
    corpus = [np.tile(f.x, (2, 1)), np.tile(f.x, (2, 1))]
    got = list(kern.compute_corpus(corpus))
    assert len(got) == 4
    for f0_b, _ in got:
        np.testing.assert_allclose(f0_b, f0_single, rtol=0, atol=0)
    # f16-transfer variant stays within the accuracy budget
    (f0_h, _), = kern.compute_batch(f.x[None, :], transfer_dtype=jnp.float16)
    both = (f0_h > 0) & (f0_single > 0)
    assert np.mean((f0_h > 0) == (f0_single > 0)) > 0.99
    assert np.sqrt(np.mean((f0_h[both] - f0_single[both]) ** 2)) < 0.2


@pytest.mark.parametrize("name", ["t22", "t16", "t48"])
def test_harvest_end_to_end(name):
    f = load_fixture(name)
    kern = H.HarvestKernel(f.fs, len(f.x), f0_floor=40.0, frame_period=5.0)
    assert kern.get_samples() == len(f.f0)
    f0, tpos = kern.compute(f.x)
    np.testing.assert_allclose(tpos, f.tpos, rtol=1e-12)
    err = np.abs(f0 - f.f0)
    rmse = np.sqrt(np.mean(err ** 2))
    assert rmse < 1e-6, f"F0 RMSE {rmse} Hz"
    assert err.max() < 1e-4, f"max F0 err {err.max()} Hz"


def test_band_filter_matmul_matches_conv():
    """The blocked-Toeplitz matmul form of the band filter bank computes
    the same correlation as conv_general_dilated (f32 rounding only)."""
    import jax
    rng = np.random.RandomState(7)
    geo = H.HarvestKernel(16000, 16000, f0_floor=40.0).geo
    ym = jnp.asarray(rng.randn(geo.y_length).astype(np.float32) * 0.1)
    for lo, hi, Lg in H._conv_groups(geo):
        kern = H._bandpass_kernels(geo, jnp.float32, lo, hi, Lg)
        ypad = jnp.pad(ym, (Lg - 1, Lg + 1))
        oc = jax.lax.conv_general_dilated(
            ypad[None, None, :], kern[:, None, :], window_strides=(1,),
            padding="VALID", dimension_numbers=("NCW", "OIW", "NCW"),
            precision=jax.lax.Precision.HIGHEST)[0]
        om = H._band_filter_matmul(ym, geo, jnp.float32, lo, hi, Lg)
        scale = float(np.abs(np.asarray(oc)).max())
        np.testing.assert_allclose(np.asarray(om), np.asarray(oc),
                                   rtol=0, atol=3e-6 * scale)


def test_grid_stride_2ms():
    """GRID_MS=2 (opt-in coarse candidate grid) stays within its documented
    quality envelope vs the golden C++ F0, and GRID_MS=1 is the default."""
    import gzip
    from worldtpu.io import wav as wav_io
    from worldtpu.io import params as params_io
    assert H.GRID_MS == 1
    x, fs, _ = wav_io.wavread("tests/fixtures/t16.wav")
    f0_ref, _, _ = params_io.read_f0("tests/fixtures/t16.f0.gz")
    x = np.asarray(x, np.float32)
    hk = H.HarvestKernel(fs, len(x))
    old = H.GRID_MS
    try:
        H.GRID_MS = 2
        for f in (H.candidates_stage, H.harvest_device_stages,
                  H.harvest_device_full):
            f.clear_cache()
        f0, _ = hk.compute(jnp.asarray(x), dtype=jnp.float32)
    finally:
        H.GRID_MS = old
        for f in (H.candidates_stage, H.harvest_device_stages,
                  H.harvest_device_full):
            f.clear_cache()
    f0 = np.asarray(f0)
    ref = np.asarray(f0_ref)[:len(f0)]
    vb = (f0 > 0) & (ref > 0)
    vuv = float(np.mean((f0 > 0) == (ref > 0)))
    rmse = float(np.sqrt(np.mean((f0[vb] - ref[vb]) ** 2)))
    # coarse grid loses voicing-boundary resolution (the extension walk
    # can miss a contour peak inside the 2 ms step); the bulk contour
    # stays within ~0.1 Hz (documented fast-mode envelope)
    assert vuv > 0.96, vuv
    assert rmse < 5.0, rmse
    assert float(np.median(np.abs(f0[vb] - ref[vb]))) < 0.2


def test_zc_capacity_violations():
    """zc event capacity: zero overflows on real speech, detected
    overflows (and a raising compute_batch) on a pathological input whose
    out-of-band energy leaks through a low band's FIR stopband at a
    crossing rate far above that band's e_max slot cap (the f32
    compaction clamps silently otherwise)."""
    x, fs, _ = __import__("worldtpu.io.wav", fromlist=["wavread"]).wavread(
        "tests/fixtures/t16.wav")
    x = np.asarray(x, np.float32)
    hk = H.HarvestKernel(fs, len(x))
    v = np.asarray(H.zc_capacity_violations_batch(
        jnp.asarray(x[None]), geo=hk.geo))
    assert v.shape == (1,)
    assert (v == 0).all(), v

    # pathological: a bare 3 kHz tone — every band's in-band content is
    # ~zero, the stopband leak IS the band signal, crossing at 3 kHz
    t = np.arange(len(x)) / fs
    chirp = np.sin(2 * np.pi * 3000.0 * t).astype(np.float32)
    v_bad = np.asarray(H.zc_capacity_violations_batch(
        jnp.asarray(chirp[None]), geo=hk.geo))
    assert v_bad.sum() > 0, v_bad

    with pytest.raises(H.ZcCapacityError):
        hk.compute_batch(chirp[None], check_capacity=True)
