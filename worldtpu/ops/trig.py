"""Affine-argument trigonometry with O(sqrt(W)) transcendental count.

The analysis windows (Hanning/Blackman in CheapTrick and D4C, reference
src/cheaptrick.cpp:107-117 and src/d4c.cpp:277-297) all evaluate
``cos(alpha_f * i + beta_f)`` over a [frames, W] index grid, W ~ 2000
transcendentals per frame.  Writing
i = Q*q + r splits the angle into a per-frame column seed and a per-frame
row seed:

    cos(a*(Qq + r) + b) = cos(aQq + b)cos(ar) - sin(aQq + b)sin(ar)

so a [F, ceil(W/Q)] seed pair and a [F, Q] offset pair (~2*sqrt(W)
transcendentals per frame with Q ~ sqrt(W) ~ 128) replace the [F, W]
evaluation; the combine is 3 broadcast FMAs on the VPU.  Accuracy: each
output is one product-sum of two exactly-rounded cos/sin values — error
<= ~2 ulp plus the seeds' own argument-reduction error, i.e. f32
round-off.  The f64 parity paths never call this (they keep literal
``jnp.cos`` so golden tests stay bitwise).
"""

from __future__ import annotations

import jax.numpy as jnp


def cos_affine(alpha, beta, W, *, Q=128, second=False):
    """cos(alpha[..., None] * arange(W) + beta[..., None]) for f32 paths.

    Args:
        alpha: [...] per-row angle step.
        beta: [...] per-row angle offset.
        W: static number of columns.
        Q: static column split (default one vreg lane span).
        second: also return cos of the DOUBLED angle (Blackman's 2nd
            harmonic) from the same seeds via cos(2x) = 2cos(x)^2 - 1.

    Returns:
        [..., W] cos values (pair of them if ``second``).
    """
    alpha = jnp.asarray(alpha)
    beta = jnp.asarray(beta)
    dt = jnp.result_type(alpha, beta)
    nq = -(-W // Q)
    q = jnp.arange(nq, dtype=dt) * Q
    r = jnp.arange(Q, dtype=dt)
    a = alpha[..., None]
    big = a * q + beta[..., None]                     # [..., nq]
    cb, sb = jnp.cos(big), jnp.sin(big)
    small = a * r                                     # [..., Q]
    cs, ss = jnp.cos(small), jnp.sin(small)
    out = (cb[..., :, None] * cs[..., None, :]
           - sb[..., :, None] * ss[..., None, :])
    out = out.reshape(*out.shape[:-2], nq * Q)[..., :W]
    if not second:
        return out
    return out, 2.0 * out * out - 1.0
