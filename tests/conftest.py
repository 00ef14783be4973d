"""Test config: run on a virtual 8-device CPU mesh with float64 enabled.

Unit/parity tests compare against float64 C++ fixtures, so they run on CPU
with x64; multi-device sharding tests use the 8 virtual host devices.
Tests marked ``gpu`` take the ``gpu`` fixture and skip here; they run on
the card from ``chip_smoke.py`` phase (b).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pathlib  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


class Fixture:
    """Lazy loader for one reference dump (t16 / t48 / t22)."""

    def __init__(self, name):
        from worldtpu.io import params, wav
        self.name = name
        self.x, self.fs, self.nbit = wav.wavread(FIXTURES / f"{name}.wav")
        self.f0, self.tpos, self.frame_period = params.read_f0(
            FIXTURES / f"{name}.f0.gz")
        self.spec, meta = params.read_spectral_envelope(
            FIXTURES / f"{name}.spec.gz")
        self.ap, _ = params.read_aperiodicity(FIXTURES / f"{name}.ap.gz")
        self.fft_size = meta["fft_size"]
        import gzip
        self.syn = np.frombuffer(
            gzip.open(FIXTURES / f"{name}.syn.f64.gz").read(), "<f8")
        self.syn2 = np.frombuffer(
            gzip.open(FIXTURES / f"{name}.syn2.f64.gz").read(), "<f8")
        raw = gzip.open(FIXTURES / f"{name}.codec.gz").read()
        n_ap = int(np.frombuffer(raw[:4], "<i4")[0])
        ndim_se = int(np.frombuffer(raw[4:8], "<i4")[0])
        F = len(self.f0)
        nbin = self.fft_size // 2 + 1
        o = 8
        def take(rows, cols):
            nonlocal o
            m = np.frombuffer(raw[o:o + 8 * rows * cols], "<f8").reshape(rows, cols)
            o += 8 * rows * cols
            return m.copy()
        self.coded_ap = take(F, n_ap)
        self.decoded_ap = take(F, nbin)
        self.coded_spec = take(F, ndim_se)
        self.decoded_spec = take(F, nbin)
        self.n_ap = n_ap
        self.ndim_se = ndim_se


_cache = {}


def load_fixture(name):
    if name not in _cache:
        _cache[name] = Fixture(name)
    return _cache[name]


@pytest.fixture()
def gpu():
    """Skips a ``gpu``-marked test unless JAX runs on a GPU (decided when
    the test runs, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: runs on the card in "
                    "`python chip_smoke.py` phase (b)")


@pytest.fixture()
def fix():
    return load_fixture("t16")


@pytest.fixture()
def fix48():
    return load_fixture("t48")


@pytest.fixture()
def fix22():
    return load_fixture("t22")
