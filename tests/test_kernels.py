"""The Pallas (Triton) refine kernel against the dense jnp refine.

Here the kernel runs in the Pallas interpreter, and is lowered for CUDA
(Triton IR) without compiling.  Its compiled form runs on the GPU in
``chip_smoke.py`` phase (b) and in the ``gpu``-marked test below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from worldtpu.analysis import harvest as H
from worldtpu.ops.refine_kernel import refine_stage_triton


def _vowel(fs, dur, f0_base, seed):
    rng = np.random.RandomState(seed)
    T = int(fs * dur)
    t = np.arange(T) / fs
    f0t = f0_base * 2 ** (0.2 * np.sin(2 * np.pi * 3 * t))
    x = np.sin(2 * np.pi * np.cumsum(f0t) / fs)
    x += 0.4 * np.sin(4 * np.pi * np.cumsum(f0t) / fs)
    x[int(0.2 * T):int(0.3 * T)] = 0.0
    return (x * 0.5 + 0.003 * rng.randn(T)).astype(np.float32)


def _deduped_inputs(fs, f0b, dur=0.3, seed=1):
    x = _vowel(fs, dur, f0b, seed)
    geo = H.HarvestGeometry(fs, len(x))
    y = H.decimate_stage(jnp.asarray(x), ratio=geo.ratio,
                         y_length=geo.y_length)
    tpos = jnp.arange(geo.f0_length, dtype=jnp.float32) / 1000.0
    cand, _, _ = H.candidates_stage(y, 0.0, tpos, geo=geo)
    return geo, y, H.dedup_candidates(cand), tpos


@pytest.mark.parametrize("fs,f0b", [(16000, 180.0), (22050, 120.0)])
def test_refine_kernel_matches_jnp_path(fs, f0b):
    """Interpreted kernel == dense refine_stage on the same deduplicated
    candidates: same slots, values to f32 summation order."""
    geo, y, cand, tpos = _deduped_inputs(fs, f0b)
    r0, s0 = H.refine_stage(y, cand, tpos, geo=geo)
    r1, s1 = refine_stage_triton(y, cand, tpos, geo=geo, interpret=True)
    r0, s0, r1, s1 = map(np.asarray, (r0, s0, r1, s1))
    assert r1.shape == r0.shape == cand.shape
    np.testing.assert_array_equal(r1 > 0, r0 > 0)
    np.testing.assert_allclose(r1, r0, rtol=0, atol=2e-3)
    np.testing.assert_allclose(s1, s0, rtol=1e-3)


def test_refine_kernel_vmap_matches_single():
    """Under vmap (the batched pipeline) every row equals its own call."""
    geo, y, cand, tpos = _deduped_inputs(16000, 150.0, dur=0.2)
    r1, s1 = refine_stage_triton(y, cand, tpos, geo=geo, interpret=True)
    half = jnp.where(jnp.arange(cand.shape[1]) < 3, cand, 0.0)
    rb, sb = jax.vmap(lambda c: refine_stage_triton(
        y, c, tpos, geo=geo, interpret=True))(jnp.stack([cand, half]))
    np.testing.assert_array_equal(np.asarray(rb[0]), np.asarray(r1))
    np.testing.assert_array_equal(np.asarray(sb[0]), np.asarray(s1))
    r2, _ = refine_stage_triton(y, half, tpos, geo=geo, interpret=True)
    np.testing.assert_array_equal(np.asarray(rb[1]), np.asarray(r2))


def test_refine_kernel_lowers_for_cuda():
    """The batched kernel at config-5 width (3 s at 22.05 kHz, f0_floor 40)
    lowers to a Triton custom call for CUDA; only the PTX compile needs
    the card."""
    fs = 22050
    geo = H.HarvestGeometry(fs, 3 * fs, f0_floor=40.0)
    F, S = geo.f0_length, geo.max_candidates
    tpos = jnp.arange(F, dtype=jnp.float32) / 1000.0
    f = jax.jit(jax.vmap(
        lambda y, c: refine_stage_triton(y, c, tpos, geo=geo),
        in_axes=(None, 0)))
    low = f.trace(jax.ShapeDtypeStruct((geo.y_length,), jnp.float32),
                  jax.ShapeDtypeStruct((8, F, S), jnp.float32)
                  ).lower(lowering_platforms=("cuda",))
    assert "xla.gpu.triton" in low.as_text()


@pytest.mark.parametrize("platform,kernel", [
    ("cuda", True), ("cpu", False), ("rocm", None)])
def test_refine_production_lowers_per_platform(platform, kernel):
    """The production refine picks its implementation per compiled
    platform: the Triton kernel for CUDA, the dense refine for the CPU,
    and no program at all elsewhere."""
    fs = 16000
    geo = H.HarvestGeometry(fs, fs // 4)
    F, S = geo.f0_length, geo.max_candidates
    f = jax.jit(lambda y, c, t: H.refine_production(y, c, t, geo=geo,
                                                    chunk=16))
    args = (jax.ShapeDtypeStruct((geo.y_length,), jnp.float32),
            jax.ShapeDtypeStruct((F, S), jnp.float32),
            jax.ShapeDtypeStruct((F,), jnp.float32))
    if kernel is None:
        with pytest.raises(NotImplementedError):
            f.trace(*args).lower(lowering_platforms=(platform,))
        return
    text = f.trace(*args).lower(lowering_platforms=(platform,)).as_text()
    assert ("xla.gpu.triton" in text) == kernel


def test_refine_kernel_cos_table_window():
    """use_cos_table=True: the kernel reads the reference's quarter-wave
    cosine table for the main window, like the dense path."""
    x = _vowel(16000, 0.2, 170.0, 3)
    geo = H.HarvestGeometry(16000, len(x), use_cos_table=True)
    y = H.decimate_stage(jnp.asarray(x), ratio=geo.ratio,
                         y_length=geo.y_length)
    tpos = jnp.arange(geo.f0_length, dtype=jnp.float32) / 1000.0
    cand, _, _ = H.candidates_stage(y, 0.0, tpos, geo=geo)
    cand = H.dedup_candidates(cand)
    r0, s0 = H.refine_stage(y, cand, tpos, geo=geo)
    r1, s1 = refine_stage_triton(y, cand, tpos, geo=geo, interpret=True)
    np.testing.assert_array_equal(np.asarray(r1) > 0, np.asarray(r0) > 0)
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r0), rtol=0,
                               atol=2e-3)


@pytest.mark.gpu
def test_refine_kernel_compiled_matches_dense(gpu):
    """The compiled kernel on the card == dense refine_stage (full f32
    matmul precision).  F0 to the interpreted test's tolerance; scores
    to 5e-3: a score is the reciprocal of a small mean harmonic
    deviation, so f32 evaluation order and the card's libdevice cos/sin
    (vs XLA's) move it by up to ~1.3e-3 relative (measured on an H100)."""
    geo, y, cand, tpos = _deduped_inputs(22050, 120.0)
    with jax.default_matmul_precision("highest"):
        r0, s0 = H.refine_stage(y, cand, tpos, geo=geo)
    r1, s1 = refine_stage_triton(y, cand, tpos, geo=geo)
    r0, s0, r1, s1 = map(np.asarray, (r0, s0, r1, s1))
    np.testing.assert_array_equal(r1 > 0, r0 > 0)
    np.testing.assert_allclose(r1, r0, rtol=0, atol=2e-3)
    np.testing.assert_allclose(s1, s0, rtol=5e-3)
