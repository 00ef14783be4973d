"""The f32 refine pre-pass shared by every refine implementation
(harvest.dedup_candidates) and the platform's choice of implementation."""

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import load_fixture
from worldtpu.analysis import harvest as H


def test_dedup_candidates_exact_rule():
    """Sort ascending, drop a value within tol*prev of its sorted
    predecessor (the predecessor itself may be dropped), compact to the
    front, zero-pad."""
    tol = 0.004
    row = [0.0, 200.0, 100.0, 100.3, 0.0, 100.6, 200.9, 150.0, 100.0]
    # sorted: 100, 100, 100.3, 100.6, 150, 200, 200.9
    #   100 (first) keep; 100 dup; 100.3 dup (0.3 <= 0.4); 100.6 dup
    #   (0.3 <= 0.4012); 150 keep; 200 keep; 200.9 keep (0.9 > 0.8)
    got = np.asarray(H.dedup_candidates(jnp.asarray([row], jnp.float32),
                                        tol))
    want = [100.0, 150.0, 200.0, 200.9, 0, 0, 0, 0, 0]
    np.testing.assert_allclose(got[0], want, rtol=1e-6)
    # all-zero rows stay zero; tol=0 only merges exact duplicates
    z = np.asarray(H.dedup_candidates(jnp.zeros((2, 5), jnp.float32)))
    assert (z == 0).all()
    exact = np.asarray(H.dedup_candidates(
        jnp.asarray([[3.0, 1.0, 3.0, 2.0]], jnp.float32), 0.0))
    np.testing.assert_array_equal(exact[0], [1.0, 2.0, 3.0, 0.0])


def test_dedup_leaves_f64_path_untouched():
    """The f64 parity stages run the dense refine on the reference's own
    candidate layout: harvest_device_stages == the explicit stage chain
    with no pre-pass, slot for slot (to the rounding of separately
    compiled programs; a dedup would move values between slots)."""
    f = load_fixture("t22")
    geo = H.HarvestGeometry(f.fs, len(f.x), f0_floor=40.0)
    x = jnp.asarray(f.x, jnp.float64)
    flat = np.asarray(H.harvest_device_stages(x, 0.0, geo=geo, chunk=16))
    y = H.decimate_stage(x, ratio=geo.ratio, y_length=geo.y_length)
    tpos = jnp.arange(geo.f0_length, dtype=jnp.float64) / 1000.0
    cand, _, _ = H.candidates_stage(y, 0.0, tpos, geo=geo)
    cand, score = H.refine_stage(y, cand, tpos, geo=geo, chunk=16)
    cand, score = H.remove_unreliable_stage(cand, score)
    want = np.concatenate([np.asarray(cand).ravel(),
                           np.asarray(score).ravel()])
    np.testing.assert_allclose(flat, want, rtol=1e-9, atol=1e-9)


# measured on CPU before the shared pre-pass existed (dense refine, no
# dedup): VUV agreement 1.0 on all three fixtures, F0 RMSE 1.2e-4 /
# 3.2e-5 / 2.4e-4 Hz; with it 0.0054 / 0.0040 / 0.142 Hz.  VUV must not
# drop; RMSE gates are the measured value plus a margin.
@pytest.mark.parametrize("name,rmse_max", [
    ("t16", 0.02), ("t22", 0.02), ("t48", 0.3)])
def test_dense_refine_after_dedup_vs_cpp(name, rmse_max):
    """The production f32 chain (dedup + dense refine on CPU) against the
    C++ reference F0 dumps."""
    f = load_fixture(name)
    hk = H.HarvestKernel(f.fs, len(f.x), f0_floor=40.0)
    f0, _ = hk.compute(jnp.asarray(np.asarray(f.x, np.float32)),
                       dtype=jnp.float32)
    ref = np.asarray(f.f0)[:len(f0)]
    vb = (f0 > 0) & (ref > 0)
    assert np.mean((f0 > 0) == (ref > 0)) == 1.0
    rmse = float(np.sqrt(np.mean((f0[vb] - ref[vb]) ** 2)))
    assert rmse < rmse_max, rmse


@pytest.mark.parametrize("platform,want", [
    ("gpu", "triton"), ("cuda", "triton"), ("cpu", "dense"),
    ("rocm", None)])
def test_refine_backend_choice(platform, want):
    """GPU -> the Triton kernel, CPU -> dense refine_stage, anything else
    is an error (no fallback)."""
    if want is None:
        with pytest.raises(ValueError, match="rocm"):
            H.refine_backend(platform)
    else:
        assert H.refine_backend(platform) == want
    assert H.refine_backend() == "dense"   # the test process runs on CPU
