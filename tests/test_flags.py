"""Flag registry: validation + supported-combination sweep.

The WORLDTPU_* knobs bind at import time (worldtpu.flags docstring), so
the combination sweep spawns one subprocess per combo and asserts the
Harvest F0 result is bitwise-or-near equal to the default-knob run —
every surviving flag value stays exercised against the default.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from worldtpu.flags import FlagError, Flags

REPO = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,value", [
    ("WORLDTPU_CONV", "fft"),
    ("WORLDTPU_CONV_PRECISION", "bf16"),
    ("WORLDTPU_GRID_MS", "0"),
])
def test_flag_validation_rejects(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    with pytest.raises(FlagError):
        Flags.from_env()


def test_flag_defaults_parse(monkeypatch):
    for k in list(os.environ):
        if k.startswith("WORLDTPU_"):
            monkeypatch.delenv(k)
    f = Flags.from_env()
    assert f.conv == "matmul" and f.grid_ms == 1


def test_flag_accepts_supported(monkeypatch):
    monkeypatch.setenv("WORLDTPU_CONV", "conv")
    monkeypatch.setenv("WORLDTPU_GRID_MS", "2")
    f = Flags.from_env()
    assert f.conv == "conv" and f.grid_ms == 2


# ---------------------------------------------------------------------------
# combination sweep (subprocess per combo; CPU jnp paths)
# ---------------------------------------------------------------------------

_CHILD = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
from worldtpu.analysis.harvest import HarvestKernel

fs = 16000
rng = np.random.RandomState(0)
n = int(fs * 0.5)
t = np.arange(n) / fs
f0 = 170.0 * 2 ** ((20 / 1200) * np.sin(2 * np.pi * 4.0 * t))
ph = 2 * np.pi * np.cumsum(f0) / fs
x = sum(np.sin(k * ph) / k for k in range(1, 9))
x = (0.7 * x / np.max(np.abs(x)) + 0.002 * rng.randn(n)).astype(np.float32)
hk = HarvestKernel(fs, n)
f0_out, _ = hk.compute(jnp.asarray(x), dtype=jnp.float32)
print("RESULT" + json.dumps(list(map(float, np.asarray(f0_out)))))
"""

_COMBOS = [
    {},                                        # defaults
    {"WORLDTPU_CONV": "conv"},
    {"WORLDTPU_CONV_PRECISION": "highest"},
]


def _run_child(extra_env):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in list(env):
        if k.startswith("WORLDTPU_"):
            env.pop(k)
    env.update(extra_env)
    r = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                       capture_output=True, text=True, timeout=600,
                       cwd=str(REPO))
    assert r.returncode == 0, (extra_env, r.stderr[-2000:])
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("RESULT")][-1]
    return np.asarray(json.loads(line[len("RESULT"):]))


@pytest.mark.slow
def test_flag_matrix_sweep_parity():
    """Every supported knob combo must produce the same F0 contour as the
    defaults on CPU (the knobs select implementation structure, not
    semantics; near-equality allows f32 reassociation)."""
    ref = _run_child({})
    assert np.isfinite(ref).all() and (ref > 0).sum() > 20
    for combo in _COMBOS[1:]:
        got = _run_child(combo)
        both = (ref > 0) & (got > 0)
        assert both.mean() > 0.99, combo
        np.testing.assert_allclose(got[both], ref[both], rtol=5e-3,
                                   err_msg=str(combo))


@pytest.mark.slow
def test_flag_error_fails_import():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               WORLDTPU_CONV="nonsense")
    r = subprocess.run(
        [sys.executable, "-c", "import worldtpu.flags"], env=env,
        capture_output=True, text=True, timeout=300, cwd=str(REPO))
    assert r.returncode != 0
    assert "FlagError" in r.stderr or "WORLDTPU_CONV" in r.stderr
