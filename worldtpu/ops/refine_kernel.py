"""Pallas (Triton) GPU kernel: adaptive-width F0 refinement (Harvest
stage D).

Computes the same harmonic-bin spectra as the dense production refine
(`worldtpu.analysis.harvest._refine_chunk`, reference
refineF0Candidates/getRefinedF0, /root/reference/src/harvest.cpp:844-982)
with work that adapts to the data.  The dense form evaluates every one of
the ``refine_cap(S)`` slots of every frame over the worst-case window
Wmax = 2*hwmax+1 (553 samples at fs=22.05k, f0_floor=40), but after the
shared dedup pre-pass (`harvest.dedup_candidates`) a frame has only a
handful of active candidates, and a typical candidate's true window
2*1.5*fs_a/f0+1 spans a fraction of Wmax.  Here one program refines one
frame: it loops over ceil(n_active / PAIRS) groups of candidates, and for
each group over the 128-sample blocks up to that group's widest window.
Both trip counts are dynamic.

Per block, a [PAIRS, 128] tile evaluates the Blackman window at the
sample and its two neighbours (the centred difference), multiplies the
block's own waveform segment, and reduces against the group's harmonic
twiddles.  The twiddles use the dense path's split m = 128*j + r: the
inner [PAIRS, 128] cos/sin tables (phases reduced exactly in int32) are
built once per group, the outer per-block factors are [PAIRS] vectors.
All arithmetic is f32 FMAs; no tensor cores.

The kernel takes candidates COMPACTED to the front of each row (the
output of `harvest.dedup_candidates`); the per-pair integer geometry and
the instantaneous-frequency finishing math are the dense path's own
(`harvest.refine_pair_params`, `harvest.refine_finish`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from worldtpu import constants as C

#: candidate pairs per group (rows of a block tile)
PAIRS = 8
#: samples per block (columns of a block tile)
BLOCK = 128
#: the 24 spectral sums per pair: (Sm_re, Sm_im, Sd_re, Sd_im) x 6 harmonics
_NSUM = 24


def _refine_kernel(nact_ref, q0_ref, shift_ref, hw_ref, wlt_ref, gbin_ref,
                   y_ref, tab_ref, out_ref, *, hwmax, fs_a, n_fft, pad_lo,
                   use_cos_table):
    from worldtpu.analysis.harvest import _main_window_values

    f32 = jnp.float32
    f = pl.program_id(0)
    nact = nact_ref[f]
    q0 = q0_ref[f]                        # y index of segment sample m = 0
    shift = shift_ref[f]                  # q0 - pos * fs_a (samples)
    lane = jax.lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)
    two_pi = 2.0 * C.PI
    w_n = two_pi / n_fft

    def group(g, carry):
        base = g * PAIRS
        hw = hw_ref[f, pl.ds(base, PAIRS)]               # [P] (-1: inactive)
        wlt = wlt_ref[f, pl.ds(base, PAIRS)]
        gbin = [gbin_ref[f, h, pl.ds(base, PAIRS)] for h in range(6)]
        # inner twiddles over r = m mod 128, built once per group
        ci, si = [], []
        for h in range(6):
            a = w_n * ((gbin[h][:, None] * lane[None, :]) % n_fft).astype(f32)
            ci.append(jnp.cos(a))
            si.append(jnp.sin(a))
        hwg = jnp.max(hw)
        jlo = (hwmax - hwg) // BLOCK
        nblk = jnp.where(hwg >= 0, (hwmax + hwg) // BLOCK - jlo + 1, 0)

        def window(m, d):
            # main window at segment sample m + d, masked to each pair's
            # own support |m + d - hwmax| <= hw (dense: in_w)
            tmp = ((m + d).astype(f32) + shift) / fs_a         # [128]
            t2 = two_pi * tmp[None, :] / wlt[:, None]          # [P, 128]
            v = _main_window_values(t2, use_cos_table, f32,
                                    lookup=lambda i: tab_ref[i])
            inw = jnp.abs(m + d - hwmax)[None, :] <= hw[:, None]
            return jnp.where(inw, v, 0.0), inw

        def block(j, accs):
            m = BLOCK * j + lane
            ys = y_ref[pl.ds(q0 + pad_lo + BLOCK * j, BLOCK)]  # [128]
            mw, inw = window(m, 0)
            wp, _ = window(m, 1)
            wm, _ = window(m, -1)
            dw = jnp.where(inw, -(wp - wm) / 2.0, 0.0)
            main = ys[None, :] * mw
            diff = ys[None, :] * dw
            out = []
            for h in range(6):
                ao = w_n * ((gbin[h] * (BLOCK * j)) % n_fft).astype(f32)
                co, so = jnp.cos(ao), jnp.sin(ao)             # [P]
                am = jnp.sum(main * ci[h], axis=1)
                bm = jnp.sum(main * si[h], axis=1)
                ad = jnp.sum(diff * ci[h], axis=1)
                bd = jnp.sum(diff * si[h], axis=1)
                a = accs[4 * h:4 * h + 4]
                out += [a[0] + (am * co - bm * so),
                        a[1] - (am * so + bm * co),
                        a[2] + (ad * co - bd * so),
                        a[3] - (ad * so + bd * co)]
            return tuple(out)

        accs = jax.lax.fori_loop(
            jlo, jlo + nblk, block,
            tuple(jnp.zeros((PAIRS,), f32) for _ in range(_NSUM)))
        for k in range(_NSUM):
            out_ref[f, k, pl.ds(base, PAIRS)] = accs[k]
        return carry

    jax.lax.fori_loop(0, (nact + PAIRS - 1) // PAIRS, group, jnp.int32(0))


@functools.partial(jax.jit, static_argnames=("geo", "interpret"))
def refine_stage_triton(y, cand, tpos, *, geo, interpret=False):
    """Stage D on a GPU: same contract and semantics as
    ``harvest.refine_stage`` for candidates compacted to the front of
    each row (``harvest.dedup_candidates``); values agree with it to f32
    summation order.  ``interpret=True`` runs the kernel in the Pallas
    interpreter (CPU tests)."""
    from worldtpu.analysis import harvest as H

    dt = y.dtype
    F, S = cand.shape
    cap = H.refine_cap(S)
    capp = -(-cap // PAIRS) * PAIRS
    fs_a = float(geo.actual_fs)
    hwmax = geo.max_half_window

    f0 = jnp.pad(cand[:, :cap], ((0, 0), (0, capp - cap)))
    nact = jnp.minimum(jnp.sum(cand > 0.0, axis=1), cap).astype(jnp.int32)
    valid = jnp.arange(capp)[None, :] < nact[:, None]
    f0s = jnp.where(valid, f0, H.REFINE_DUMMY_F0)
    hw, wlt, fft_p, n_harm, idx_h, gbin = H.refine_pair_params(f0s, geo)
    hw = jnp.where(valid, hw, -1)

    origin = H._matlab_round(tpos * fs_a + 0.001)             # [F]
    q0 = (origin - 1 - hwmax).astype(jnp.int32)
    # frame-relative sample times, as the dense path computes them
    shift = q0.astype(jnp.float32) - tpos.astype(jnp.float32) * fs_a
    # edge-replicated pad == the dense path's clip(q, 0, L-1) gather; the
    # tail covers the last block of the widest window
    pad_lo = hwmax + 1
    n_blk = -(-(2 * hwmax + 1) // BLOCK)
    ypad = jnp.pad(y.astype(jnp.float32), (pad_lo, BLOCK * (n_blk + 1)),
                   mode="edge")

    kern = functools.partial(_refine_kernel, hwmax=hwmax, fs_a=fs_a,
                             n_fft=geo.refine_fft, pad_lo=pad_lo,
                             use_cos_table=geo.use_cos_table)
    sums = pl.pallas_call(
        kern,
        grid=(F,),
        out_shape=jax.ShapeDtypeStruct((F, _NSUM, capp), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="worldtpu_refine",
    )(nact, q0, shift, hw, wlt.astype(jnp.float32),
      jnp.swapaxes(gbin, 1, 2).astype(jnp.int32), ypad,
      jnp.asarray(H._cos_table_np(), jnp.float32))
    # groups past a frame's last active one are never written
    sums = jnp.where(valid[:, None, :], sums, 0.0).astype(dt)
    sums = jnp.swapaxes(sums.reshape(F, 6, 4, capp), 1, 3)    # [F, capp, 4, 6]
    refined, score = H.refine_finish(
        sums[:, :, 0], sums[:, :, 1], sums[:, :, 2], sums[:, :, 3],
        f0s, valid, fft_p, n_harm, idx_h, geo)
    pad = ((0, 0), (0, S - cap))
    return (jnp.pad(refined[:, :cap], pad), jnp.pad(score[:, :cap], pad))
