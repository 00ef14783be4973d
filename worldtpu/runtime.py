"""Process set-up shared by the entry points (``cli.main``, ``bench.py``,
``chip_smoke.py``): the persistent compile cache and a description of the
device a run used."""

from __future__ import annotations

import os
import pathlib
import subprocess

import jax

#: the environment variable JAX reads its persistent compile cache path from
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"

#: the checkout this package was imported from
CHECKOUT = pathlib.Path(__file__).resolve().parents[1]


def setup_compile_cache():
    """Keep compiled programs across processes.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is set here.  Otherwise the cache goes to ``<checkout>/.jax_cache``
    — a fixed path, since the path is part of what a later run must find.
    Returns the directory in use."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_info():
    """The device a run used, as JAX reports it."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power_limit():
    """``nvidia-smi --query-gpu=name,power.limit`` lines (a child process
    that does not import JAX), or None where nvidia-smi is unavailable."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0:
        return None
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
