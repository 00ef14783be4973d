"""Matmul-DFT: batched small real FFTs as dense matmuls.

For the n <= 4096 batched transforms in CheapTrick/D4C/Synthesis
(reference hot-loop economics, /root/reference/src/cheaptrick.cpp:64-88,
d4c.cpp:143-169, synthesis.cpp:100-116) an explicit [B, n] @ [n, K]
cos/sin basis product can beat a backend FFT that handles many tiny
transforms poorly, despite the n^2 vs n*log(n) FLOP penalty.  Whether it
does on a GPU (against cuFFT) is not measured; D4C's coarse bands use it
(analysis/d4c.py).

Routing is opt-in PER CALL via `mode` ("mm"); the module default is the
jnp.fft path.  Bases are f32 and cached per transform size; precision is
HIGHEST (exact f32 — the transforms feed power spectra, cepstra, and
audio, where low-precision input rounding is audible).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# module-level and mutable for tests that toggle the route around a call
MODE = "fft"
PRECISION = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=16)
def _rfft_basis(n):
    """([n, K] cos, [n, K] sin) with K = n//2 + 1 (numpy at trace time)."""
    k = np.arange(n // 2 + 1)
    j = np.arange(n)
    ang = 2.0 * np.pi / n * np.outer(j, k)
    # numpy, NOT device_put: these builders run at trace time, where a
    # device_put stages a traced op (a cached tracer then leaks into later
    # traces); np constants embed into each executable instead
    return (np.cos(ang).astype(np.float32),
            np.sin(ang).astype(np.float32))


@functools.lru_cache(maxsize=16)
def _irfft_basis(n):
    """([K, n] cos, [K, n] sin) weighted for the inverse: x = Re @ C - Im @ S
    with the 1/n and doubled-interior-bin factors folded in."""
    K = n // 2 + 1
    k = np.arange(K)
    j = np.arange(n)
    w = np.full(K, 2.0 / n)
    w[0] = 1.0 / n
    if n % 2 == 0:
        w[-1] = 1.0 / n
    ang = 2.0 * np.pi / n * np.outer(k, j)
    return ((w[:, None] * np.cos(ang)).astype(np.float32),
            (w[:, None] * np.sin(ang)).astype(np.float32))


def rfft(x, n=None, mode=None, precision=None):
    """jnp.fft.rfft(x, n, axis=-1) drop-in (f32 path; returns complex64
    when mode="mm")."""
    mode = MODE if mode is None else mode
    if mode != "mm" or x.dtype == jnp.float64:
        return jnp.fft.rfft(x, n=n, axis=-1)
    precision = PRECISION if precision is None else precision
    if n is None:
        n = x.shape[-1]
    L = x.shape[-1]
    if L > n:
        x = x[..., :n]
        L = n
    # zero-padding the input to n contributes nothing to the sum, so the
    # basis is sliced to the true input width instead (exact, and the
    # engines' windows are typically 2-4x shorter than their fft size —
    # that slice IS the matmul-DFT's edge over the n*log(n) FFT)
    C, S = _rfft_basis(n)
    xf = x.reshape(-1, L).astype(jnp.float32)
    re = jnp.dot(xf, C[:L], precision=precision)
    im = -jnp.dot(xf, S[:L], precision=precision)
    out = jax.lax.complex(re, im)
    return out.reshape(x.shape[:-1] + (n // 2 + 1,))


def irfft(X, n=None, mode=None, precision=None):
    """jnp.fft.irfft(X, n, axis=-1) drop-in (f32 path)."""
    mode = MODE if mode is None else mode
    if mode != "mm" or X.dtype in (jnp.complex128, jnp.float64):
        return jnp.fft.irfft(X, n=n, axis=-1)
    precision = PRECISION if precision is None else precision
    K_in = X.shape[-1]
    if n is None:
        n = 2 * (K_in - 1)
    K = n // 2 + 1
    if K_in > K:
        X = X[..., :K]
        K_in = K
    # zero bins contribute nothing: slice the basis to the given bins
    C, S = _irfft_basis(n)
    Xf = X.reshape(-1, K_in)
    out = (jnp.dot(jnp.real(Xf).astype(jnp.float32), C[:K_in],
                   precision=precision)
           - jnp.dot(jnp.imag(Xf).astype(jnp.float32), S[:K_in],
                     precision=precision))
    return out.reshape(X.shape[:-1] + (n,))


def rfft_real(x, n=None, mode=None, precision=None):
    """Real part of rfft only (one cos matmul) — exact when the caller's
    input is even-symmetric (mirrored log spectra: the transform is real),
    and a cheap substitute for rfft(...).real otherwise."""
    mode = MODE if mode is None else mode
    if mode != "mm" or x.dtype == jnp.float64:
        return jnp.fft.rfft(x, n=n, axis=-1).real
    precision = PRECISION if precision is None else precision
    if n is None:
        n = x.shape[-1]
    L = x.shape[-1]
    if L > n:
        x = x[..., :n]
        L = n
    C, _ = _rfft_basis(n)
    xf = x.reshape(-1, L).astype(jnp.float32)
    return jnp.dot(xf, C[:L], precision=precision).reshape(
        x.shape[:-1] + (n // 2 + 1,))
