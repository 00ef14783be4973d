"""Process set-up shared by the entry points, and chip_smoke.py's refusal
to run without a GPU."""

import os
import pathlib
import subprocess
import sys

import jax

from worldtpu import runtime

REPO = pathlib.Path(__file__).resolve().parents[1]


def _restore_cache_dir(old):
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_set(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX uses it and the helper sets
    nothing."""
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path))
    try:
        assert runtime.setup_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == old
    finally:
        _restore_cache_dir(old)


def test_compile_cache_env_unset(monkeypatch):
    """Without it, the cache goes to the checkout's .jax_cache — a fixed
    path, not a temporary one."""
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    try:
        want = str(REPO / ".jax_cache")
        assert runtime.setup_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert runtime.setup_compile_cache() == want
    finally:
        _restore_cache_dir(old)


def test_chip_smoke_fails_without_gpu():
    """On the CPU the smoke test exits non-zero, names the platform it
    found, and prints no ok line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=str(REPO), env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr and "'cpu'" in r.stderr
    assert '"ok"' not in r.stdout


def _smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    return chip_smoke


def _t16_stages(cs):
    import numpy as np

    from worldtpu.analysis.harvest import HarvestKernel
    from worldtpu.io import wav
    x, fs, _ = wav.wavread(REPO / "tests" / "fixtures" / "t16.wav")
    x = np.asarray(x, np.float32)[None]
    geo = HarvestKernel(fs, x.shape[1], f0_floor=40.0).geo
    progs = cs.harvest_stage_programs(geo)
    return x, geo, progs, cs.run_stages(progs, x, jax.devices("cpu")[0])


def test_smoke_stage_chain_is_the_fused_harvest(monkeypatch):
    """The smoke test's per-stage programs, chained, compute what the fused
    f32 Harvest program computes (so a stage's reading on the card is a
    reading of the production semantics)."""
    import jax.numpy as jnp
    import numpy as np

    from worldtpu.analysis import harvest as H
    cs = _smoke(monkeypatch)
    x, geo, progs, outs = _t16_stages(cs)
    n_out = outs["contour"].shape[1]
    fused = H.harvest_device_full(jnp.asarray(x[0]), jnp.float32(0.0),
                                  geo=geo, n_out=n_out, chunk=32)
    assert [n for n, _, _ in progs][-1] == "contour"
    np.testing.assert_array_equal(outs["contour"][0], np.asarray(fused))
    assert cs.stage_difference("contour", outs["contour"],
                               outs["contour"]) == 0.0


def test_smoke_tf32_bank_reference_separates_precisions(monkeypatch):
    """The CPU's TF32 reference of the card's filter bank is off the f32
    bank by TF32 rounding: far above the smoke test's card-vs-reference
    limit (5e-6, so a card bank in full f32 would fail it) and below the
    bf16 level (~1e-3)."""
    import jax.numpy as jnp

    from worldtpu.analysis import harvest as H
    cs = _smoke(monkeypatch)
    _, geo, _, outs = _t16_stages(cs)
    gk = geo.with_grid(H._grid_for(jnp.float32))
    tf = cs._bank_tf32_reference(outs["decimate"], gk, jax.devices("cpu")[0])
    assert tf.shape == outs["filter_bank"].shape
    d = cs.stage_difference("filter_bank", tf, outs["filter_bank"])
    assert 5e-6 < d < 1e-3, d
