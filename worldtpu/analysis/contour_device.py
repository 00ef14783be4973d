"""Harvest F0-contour fixing and smoothing ON DEVICE (jnp, float32).

Mirrors the host implementation in `worldtpu.analysis.contour` (itself a
faithful port of fixF0Contour + smoothF0Contour,
/root/reference/src/harvest.cpp:254-703) as one jittable program, so the
production Harvest pipeline is wav -> F0 entirely on device: the
device->host transfer shrinks from the full [F, S] candidate/score slab to
the final frame-period F0 vector, and the contour stage joins the fused
single-dispatch program (no host round trip, shards under the mesh).

Sequential structure is preserved exactly where the reference is
sequential — the extend walk's running reference F0 (:371-403), the
un-reset mean_f0 accumulator (:446-452), the merge loop's evolving
boundary (:502-536) — as lax.scans whose carried state is the loop
variables; everything per-frame or per-section is vectorized.  Sections
live in a static [S_max] layout with S_max = (F+1)//7 + 1 (a voiced
section needs >= 6 frames + a gap after fixStep2).

The float64 host path in `contour` remains the parity oracle; tests
compare this module against it on fixture dumps and synthetic contours.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _runs(v):
    """Voiced-run bookkeeping from a boundary mask [F] (endpoints already
    forced False).  Returns (st_mask, ed_mask, rank) where rank[i] is the
    run index of frame i (valid where v)."""
    vprev = jnp.concatenate([jnp.zeros((1,), bool), v[:-1]])
    vnext = jnp.concatenate([v[1:], jnp.zeros((1,), bool)])
    st_mask = v & ~vprev
    ed_mask = v & ~vnext
    rank = jnp.cumsum(st_mask) - 1
    return st_mask, ed_mask, rank


def _positions(mask, s_max, fill):
    """Compact the indices where mask holds into a static [s_max] slot
    array; empty slots get `fill`.  Sort-based: O(F log F) regardless of
    s_max (a [F, s_max] one-hot is quadratic in F for run bookkeeping)."""
    F = mask.shape[0]
    pos = jnp.sort(jnp.where(mask, jnp.arange(F), F))[:s_max]
    have = jnp.arange(s_max) < jnp.sum(mask)
    return jnp.where(have, pos, fill)


def _vmask(f0):
    v = f0 > 0.0
    return v.at[0].set(False).at[-1].set(False)


def search_f0_base(candidates, scores):
    """Best-scoring candidate per frame (reference :254-272)."""
    best = jnp.argmax(scores, axis=1)
    rows = jnp.arange(candidates.shape[0])
    f0 = candidates[rows, best]
    return jnp.where(scores[rows, best] > 0.0, f0, 0.0)


def fix_step1(f0_base, allowed_range=0.008):
    """Rapid F0 changes -> 0 (reference :277-291)."""
    f0 = f0_base
    F = f0.shape[0]
    out = jnp.zeros_like(f0)
    ref = f0[1:-1] * 2 - f0[:-2]
    cur = f0[2:]
    prev = f0[1:-1]
    bad = (jnp.abs((cur - ref) / ref) > allowed_range) \
        & (jnp.abs(cur - prev) / prev > allowed_range)
    vals = jnp.where(cur == 0.0, 0.0, jnp.where(bad, 0.0, cur))
    return out.at[2:].set(vals) if F >= 3 else out


def fix_step2(f0_step1, voice_range_minimum=6):
    """Remove too-short voiced sections (reference :319-334).

    Per-frame run spans via running max/min of start/end positions — no
    section axis at all."""
    v = _vmask(f0_step1)
    st_mask, ed_mask, _ = _runs(v)
    F = f0_step1.shape[0]
    idx = jnp.arange(F)
    st_of = jax.lax.cummax(jnp.where(st_mask, idx, -1))
    ed_of = -jax.lax.cummax(jnp.where(ed_mask, -idx, -F)[::-1])[::-1]
    # reference keeps sections with ed - st >= voice_range_minimum (:62)
    short = (ed_of - st_of) < voice_range_minimum
    return jnp.where(v & short, 0.0, f0_step1)


def _select_best(ref_f0, cand_rows, allowed_range):
    """Batched selectBestF0 (:347-365): nearest candidate within
    allowed_range of each ref; ties keep the LAST equal-error candidate.

    Args: ref_f0 [K], cand_rows [K, S].  Returns picked values [K]."""
    err = jnp.abs(ref_f0[:, None] - cand_rows) / ref_f0[:, None]
    m = jnp.min(err, axis=1)
    S = cand_rows.shape[1]
    idx = S - 1 - jnp.argmax((err == m[:, None])[:, ::-1], axis=1)
    best = jnp.take_along_axis(cand_rows, idx[:, None], axis=1)[:, 0]
    return jnp.where(m <= allowed_range, best, 0.0)


_EXTEND_CHUNK = 64


def _extend_both(ch, ss, st, ed, n_sec, candidates, scores,
                 allowed_range, s_max, grid_ms=1):
    """Parallel extendF0 (:371-403): both directions at once, compact
    section chunks, early-exit walk.

    The reference walks each voiced section outward frame by frame
    (sequential: the running reference F0 updates as values are accepted,
    and the walk stops after 4 consecutive misses).  The round-2 device
    form scanned a fixed 101 steps over all s_max=(F+1)//7+1 section
    slots, gathering [s_max, S] candidate rows per step — but real
    contours have ~10 sections and walks stop within ~10-30 steps, so
    >90% of that work was masked-off padding.  Here:

      - an outer while_loop visits only ceil(n_sec / 64) section chunks
        (data-dependent trip count: vmapped batches run the batch max);
      - each chunk walks BOTH directions together (rows = fwd ++ bwd;
        the reference extends ed-ward before st-ward, but the walks only
        read the base channels inside their own section, so they commute);
      - the inner while_loop exits as soon as every walk has stopped
        (4 consecutive misses, :399-400) or passed its 100-frame limit;
      - walked values land in the chunk's [64, F+1] row slab via one-hot
        column writes (each step visits a fresh column), merged back with
        dynamic_update_slice.

    Returns (ch, ss with extensions written, st2, ed2 shifted origins)."""
    F = candidates.shape[0]
    # the 100-frame growth limit and 4-consecutive-miss stop are TIME
    # semantics on the 1 ms reference grid; a coarser grid scales both
    ext_lim = max(1, round(100 / grid_ms))
    miss_lim = max(1, round(4 / grid_ms))
    CK = _EXTEND_CHUNK
    s_pad = -(-s_max // CK) * CK
    ch = jnp.pad(ch, ((0, s_pad - s_max), (0, 0)))
    ss = jnp.pad(ss, ((0, s_pad - s_max), (0, 0)))
    st = jnp.pad(st, (0, s_pad - s_max), constant_values=F - 2)
    ed = jnp.pad(ed, (0, s_pad - s_max), constant_values=1)
    st2 = st
    ed2 = ed
    colw = jnp.arange(F + 1)[None, :]                       # [1, F+1]
    rk = jnp.arange(CK)
    S = candidates.shape[1]
    # candidates and scores ride ONE gather / slab row
    packed = jnp.concatenate([candidates, scores], axis=1)  # [F, 2S]

    def chunk_cond(c):
        return c[0] * CK < n_sec

    def chunk_body(carry):
        c, ch, ss, st2, ed2 = carry
        base = c * CK
        ch_s = jax.lax.dynamic_slice(ch, (base, jnp.int32(0)), (CK, F + 1))
        ss_s = jax.lax.dynamic_slice(ss, (base, jnp.int32(0)), (CK, F + 1))
        ed_c = jax.lax.dynamic_slice(ed, (base,), (CK,))
        st_c = jax.lax.dynamic_slice(st, (base,), (CK,))
        live = (base + rk) < n_sec
        # fwd rows 0..CK-1 walk ed -> ed+lim; bwd rows CK.. walk st -> st-lim
        origin = jnp.concatenate([ed_c, st_c])
        shift = jnp.concatenate([jnp.full((CK,), 1, jnp.int32),
                                 jnp.full((CK,), -1, jnp.int32)])
        limit = jnp.concatenate([jnp.minimum(F - 2, ed_c + ext_lim),
                                 jnp.maximum(1, st_c - ext_lim)])
        distance = jnp.abs(limit - origin)
        live2 = jnp.concatenate([live, live])
        tmp0 = jnp.concatenate([ch_s, ch_s])[
            jnp.arange(2 * CK), jnp.clip(origin, 0, F - 1)]

        # Up to ext_lim+1 genuinely-sequential steps (the running reference
        # F0 updates as values are accepted).  Under vmap the while_loop
        # runs the BATCH-max trip count, and each iteration has a fixed
        # cost (on a GPU a device->host read of the predicate) — so each
        # iteration performs U exact sub-steps and the early-exit check
        # runs every U steps.
        U = 4

        def walk_cond(w):
            i, tmp, cnt, so, stopped, ch_s, ss_s = w
            done = stopped | (i > distance) | ~live2
            return (i < ext_lim + 1) & ~jnp.all(done)

        def walk_step(i, tmp, cnt, so, stopped, ch_s, ss_s):
            j = origin + shift * (i + 1)
            on = live2 & (i <= distance) & ~stopped & (i < ext_lim + 1)
            jc = jnp.clip(j, 0, F - 1)
            rows = packed[jc]                               # [2CK, 2S]
            cand_rows = rows[:, :S]
            val = _select_best(jnp.where(tmp > 0, tmp, 1.0), cand_rows,
                               allowed_range)
            val = jnp.where(on, val, 0.0)
            m = cand_rows == val[:, None]
            sc = jnp.max(jnp.where(m, rows[:, S:], -jnp.inf), axis=1)
            sc = jnp.where(jnp.any(m, axis=1), sc, 0.0)
            zero = val == 0.0
            cnt = jnp.where(on, jnp.where(zero, cnt + 1, 0), cnt)
            tmp = jnp.where(on & ~zero, val, tmp)
            so = jnp.where(on & ~zero, j, so)
            stopped = stopped | (on & (cnt == miss_lim))
            # one-hot column write per direction (fresh column each step)
            hit_f = (colw == jc[:CK, None]) & on[:CK, None]
            hit_b = (colw == jc[CK:, None]) & on[CK:, None]
            ch_s = jnp.where(hit_f, val[:CK, None], ch_s)
            ch_s = jnp.where(hit_b, val[CK:, None], ch_s)
            ss_s = jnp.where(hit_f, sc[:CK, None], ss_s)
            ss_s = jnp.where(hit_b, sc[CK:, None], ss_s)
            return tmp, cnt, so, stopped, ch_s, ss_s

        def walk_body(w):
            i, tmp, cnt, so, stopped, ch_s, ss_s = w
            for u in range(U):
                tmp, cnt, so, stopped, ch_s, ss_s = walk_step(
                    i + u, tmp, cnt, so, stopped, ch_s, ss_s)
            return (i + U, tmp, cnt, so, stopped, ch_s, ss_s)

        init = (jnp.int32(0), tmp0,
                jnp.zeros((2 * CK,), jnp.int32), origin,
                jnp.zeros((2 * CK,), bool), ch_s, ss_s)
        _, _, _, so, _, ch_s, ss_s = jax.lax.while_loop(
            walk_cond, walk_body, init)
        ch = jax.lax.dynamic_update_slice(ch, ch_s, (base, jnp.int32(0)))
        ss = jax.lax.dynamic_update_slice(ss, ss_s, (base, jnp.int32(0)))
        ed2 = jax.lax.dynamic_update_slice(ed2, so[:CK], (base,))
        st2 = jax.lax.dynamic_update_slice(st2, so[CK:], (base,))
        return (c + 1, ch, ss, st2, ed2)

    _, ch, ss, st2, ed2 = jax.lax.while_loop(
        chunk_cond, chunk_body, (jnp.int32(0), ch, ss, st2, ed2))
    return (ch[:s_max], ss[:s_max], st2[:s_max], ed2[:s_max])


def fix_step3(f0_step2, candidates, scores, allowed_range=0.18, grid_ms=1):
    """Extend voiced sections by contour continuity, then merge
    (reference :560-585 + extend/merge :427-536)."""
    F = f0_step2.shape[0]
    s_max = (F + 1) // 7 + 1
    v = _vmask(f0_step2)
    st_mask, ed_mask, rank = _runs(v)
    n_sec = jnp.sum(st_mask)
    st = _positions(st_mask, s_max, F - 2)
    ed = _positions(ed_mask, s_max, 1)
    rows = jnp.arange(s_max)

    # base channels [s_max, F+1] (extra dump column) + searchScore shadows:
    # ss of a zero value is the frame's max score over zero candidates, ss
    # of a run value is that value's own match score — both one [F, S] pass
    sid = jnp.where(v, rank, s_max)
    in_own = sid[None, :] == rows[:, None]
    ch = jnp.where(in_own, f0_step2[None, :], 0.0)
    ch = jnp.concatenate([ch, jnp.zeros((s_max, 1), f0_step2.dtype)], 1)

    def _ss_of(vals):
        m = candidates == vals[:, None]
        s = jnp.max(jnp.where(m, scores, -jnp.inf), axis=1)
        return jnp.where(jnp.any(m, axis=1), s, 0.0)

    ss_zero = _ss_of(jnp.zeros_like(f0_step2))
    ss_run = _ss_of(f0_step2)
    ss = jnp.where(in_own, ss_run[None, :], ss_zero[None, :])
    ss = jnp.concatenate([ss, jnp.zeros((s_max, 1), f0_step2.dtype)], 1)

    # ---- extend (:427-458) ----
    ch, ss, st2, ed2 = _extend_both(ch, ss, st, ed, n_sec, candidates,
                                    scores, allowed_range, s_max, grid_ms)

    # ---- extendSub: mean-based section filter (:440-458) ----
    # NOTE: mean_f0 accumulates WITHOUT reset between sections
    # (harvest.cpp:446-452), replicated including inf on empty sections
    csum = jnp.cumsum(jnp.pad(ch[:, :F], ((0, 0), (1, 0))), axis=1)
    ssum = (csum[rows, jnp.clip(ed2, 0, F)]
            - csum[rows, jnp.clip(st2, 0, F)])      # sum over [st2, ed2)
    length = (ed2 - st2).astype(f0_step2.dtype)

    def mean_step(m, x):
        s, n = x
        m2 = (m + s) / n
        return m2, m2
    _, means = jax.lax.scan(mean_step, jnp.asarray(0.0, f0_step2.dtype),
                            (ssum, length))
    keep = (2200.0 / grid_ms / means < length) & (rows < n_sec)
    n_ch = jnp.sum(keep)

    # survivors to the front, preserving order (reference swapArray)
    krank = jnp.where(keep, jnp.cumsum(keep) - 1, s_max - 1)
    sel = jnp.sum(jnp.where(
        krank[:, None] == rows[None, :], rows[:, None], 0), axis=0)
    sel = jnp.where(rows < n_ch, sel, 0)
    st3 = st2[sel]
    ed3 = ed2[sel]
    ch3 = ch[sel, :F]
    ss3 = ss[sel, :F]

    # ---- merge (:502-536) ----
    order = jnp.argsort(jnp.where(rows < n_ch, st3, F + rows))
    fidx = jnp.arange(F)

    def merge_cond(carry):
        return carry[0] < n_ch

    def merge_body(carry):
        i, merged, mss, b0, b1 = carry
        k = order[i]
        i1, i2 = st3[k], ed3[k]
        in_sec = (fidx >= i1) & (fidx <= i2)
        new_section = i1 - b1 > 0
        covered = (b0 <= i1) & (b1 >= i2)
        # scored merge (:475-497)
        r = (fidx >= i1) & (fidx <= b1)
        s1 = jnp.sum(jnp.where(r, mss, 0.0))
        s2 = jnp.sum(jnp.where(r, ss3[k], 0.0))
        take_hi = (fidx >= b1) & (fidx <= i2)                # score1 wins
        take_all = in_sec                                    # score2 wins
        take = jnp.where(s1 > s2, take_hi, take_all)
        upd = jnp.where(new_section, in_sec, jnp.where(covered, False, take))
        merged = jnp.where(upd, ch3[k], merged)
        mss = jnp.where(upd, ss3[k], mss)
        b0 = jnp.where(new_section, i1, b0)
        b1 = jnp.where(new_section | ~covered, i2, b1)
        return (i + 1, merged, mss, b0, b1)

    _, merged, _, _, _ = jax.lax.while_loop(
        merge_cond, merge_body,
        (jnp.int32(1), ch3[0], ss3[0], st3[0], ed3[0]))

    out = jnp.where(n_ch == 0, ch[0, :F], merged)
    return jnp.where(n_sec == 0, f0_step2, out)


def fix_step4(f0_step3, threshold=9):
    """Fill short unvoiced gaps linearly (reference :590-614)."""
    F = f0_step3.shape[0]
    v = _vmask(f0_step3)
    st_mask, ed_mask, _ = _runs(v)
    s_max = (F + 1) // 2 + 1
    st = _positions(st_mask, s_max, F + 10)
    ed = _positions(ed_mask, s_max, -10)
    n_sec = jnp.sum(st_mask)
    fidx = jnp.arange(F)
    # gap g lies between ed[g] and st[g+1]
    gprev = jnp.cumsum(ed_mask) - 1                  # [F]
    g = jnp.clip(gprev, 0, s_max - 2)
    ed_g = jnp.take(ed, g)
    st_g1 = jnp.take(st, jnp.clip(g + 1, 0, s_max - 1))
    in_gap = (~v) & (gprev >= 0) & (gprev <= n_sec - 2) \
        & (fidx > ed_g) & (fidx < st_g1)
    distance = st_g1 - ed_g - 1
    tmp0 = jnp.take(f0_step3, jnp.clip(ed_g, 0, F - 1)) + 1.0
    tmp1 = jnp.take(f0_step3, jnp.clip(st_g1, 0, F - 1)) - 1.0
    coeff = (tmp1 - tmp0) / (distance + 1.0).astype(f0_step3.dtype)
    fill = tmp0 + coeff * (fidx - ed_g).astype(f0_step3.dtype)
    return jnp.where(in_gap & (distance < threshold), fill, f0_step3)


_SMOOTH_B = (0.0078202080334971724, 0.015640416066994345)
_SMOOTH_A = (1.7347257688092754, -0.76600660094326412)
_LAG = 300


@functools.lru_cache(maxsize=None)
def _biquad_tables(L):
    """Blocked-matmul tables for the smoothing biquad (state (w0, w1)):
    w_t = x + a0 w0 + a1 w1, y = b0 w_t + b1 w0 + b0 w1."""
    a0, a1 = _SMOOTH_A
    b0, b1 = _SMOOTH_B
    A = np.array([[a0, a1], [1.0, 0.0]])
    e0 = np.array([1.0, 0.0])
    # impulse response of the state w.r.t inputs within a block
    # s_i = sum_{j<=i} A^{i-j} e0 x_j ; y_i = c . s_i_pre? — here y_i
    # depends on the PRE-update state (w0, w1) and x_i:
    # y_i = b0*(x_i + a0 w0 + a1 w1) + b1 w0 + b0 w1
    #     = (b0 a0 + b1, b0 a1 + b0) . s_{i-1} + b0 x_i
    c = np.array([b0 * a0 + b1, b0 * a1 + b0])
    P = np.zeros((L + 1, 2, 2))
    P[0] = np.eye(2)
    for i in range(L):
        P[i + 1] = A @ P[i]
    # y_i = c . s_{i-1} + b0 x_i, s_{i-1} = A^i s_{-1} + sum_{j<i} A^{i-1-j} e0 x_j
    G = np.stack([c @ P[i] for i in range(L)])              # [L, 2]
    H = np.zeros((L, L))
    for i in range(L):
        H[i, i] = b0
        for j in range(i):
            H[i, j] = c @ P[i - 1 - j] @ e0
    W = np.stack([P[L - 1 - j] @ e0 for j in range(L)])     # [L, 2]
    AL = P[L]
    return G, H.T, W, AL


def _biquad_batch(x):
    """One forward pass of the smoothing biquad over [B, T] rows, output
    written REVERSED like the reference (filteringF0 harvest.cpp:649-656)."""
    B, T = x.shape
    dt = x.dtype
    L = 128
    nb = -(-T // L)
    G, HT, W, AL = (jnp.asarray(t, dt) for t in _biquad_tables(L))
    xb = jnp.pad(x, ((0, 0), (0, nb * L - T))).reshape(B, nb, L)
    c = jnp.einsum("bnl,ls->bns", xb, W,
                   precision=jax.lax.Precision.HIGHEST)     # [B, nb, 2]

    def adv(s, ci):
        s2 = jnp.einsum("st,bt->bs", AL, s,
                        precision=jax.lax.Precision.HIGHEST) + ci
        return s2, s
    _, s0 = jax.lax.scan(adv, jnp.zeros((B, 2), dt),
                         jnp.swapaxes(c, 0, 1))             # [nb, B, 2]
    s0 = jnp.swapaxes(s0, 0, 1)                             # [B, nb, 2]
    y = jnp.einsum("bns,ls->bnl", s0, G,
                   precision=jax.lax.Precision.HIGHEST) \
        + jnp.einsum("bnj,jl->bnl", xb, HT,
                     precision=jax.lax.Precision.HIGHEST)
    return y.reshape(B, nb * L)[:, :T][:, ::-1]


def smooth_f0_contour(f0, s_max=None):
    """Per-section zero-lag Butterworth smoothing (reference :670-703).

    Sections are processed in 32-row chunks under a while_loop with a
    data-dependent trip count (real contours have ~10 sections, the static
    s_max=(F+1)//7+1 slot layout ~430 — the padded rows were >90% of the
    smoothing matmuls; same compact-chunk pattern as _extend_both)."""
    F = f0.shape[0]
    n = F + 2 * _LAG
    if s_max is None:
        s_max = (F + 1) // 7 + 1
    padded = jnp.pad(f0, (_LAG, _LAG))
    v = _vmask(padded)
    st_mask, ed_mask, rank = _runs(v)
    n_sec = jnp.sum(st_mask)
    CK = 32
    s_pad = -(-s_max // CK) * CK
    st = jnp.pad(_positions(st_mask, s_max, n - 1), (0, s_pad - s_max),
                 constant_values=n - 1)
    ed = jnp.pad(_positions(ed_mask, s_max, 0), (0, s_pad - s_max))
    rk = jnp.arange(CK)
    jidx = jnp.arange(n)
    sid = jnp.where(v, rank, -1)                            # [n]

    def chunk_cond(c):
        return c[0] * CK < n_sec

    def chunk_body(carry):
        c, out = carry
        base = c * CK
        st_c = jax.lax.dynamic_slice(st, (base,), (CK,))
        ed_c = jax.lax.dynamic_slice(ed, (base,), (CK,))
        live = (base + rk) < n_sec
        # edge-held per-section signals x[clip(j, st, ed)], gather-free:
        # the held regions are per-section constants, the middle is the
        # shared padded signal (no [CK, n] clipped gather)
        edge_lo = padded[jnp.clip(st_c, 0, n - 1)]
        edge_hi = padded[jnp.clip(ed_c, 0, n - 1)]
        chs = jnp.where(jidx[None, :] < st_c[:, None], edge_lo[:, None],
                        jnp.where(jidx[None, :] > ed_c[:, None],
                                  edge_hi[:, None], padded[None, :]))
        chs = jnp.where(live[:, None], chs, 0.0)
        sm = _biquad_batch(_biquad_batch(chs))
        hit = sid[None, :] == (base + rk)[:, None]          # [CK, n]
        out = out + jnp.sum(jnp.where(hit, sm, 0.0), axis=0)
        return (c + 1, out)

    _, out = jax.lax.while_loop(
        chunk_cond, chunk_body,
        (jnp.int32(0), jnp.zeros((n,), f0.dtype)))
    return jnp.where(v[_LAG:_LAG + F], out[_LAG:_LAG + F], 0.0)


def fix_and_smooth(candidates, scores, n_out, frame_period_ms, grid_ms=1):
    """Full device contour chain: candidates/scores [F, S] -> F0 at the
    output frame grid [n_out] (reference fixF0Contour + smoothF0Contour +
    the internal-grid -> frame_period subsampling,
    harvest.cpp:183-208,619-634).

    grid_ms is the candidates' internal grid period; the TIME-semantic
    fix constants scale with it (per-step change gates by grid_ms,
    frame-count windows by 1/grid_ms) so the chain behaves consistently
    on a coarser grid.  grid_ms=1 is exactly the reference chain."""
    F = candidates.shape[0]
    k = grid_ms
    c1 = search_f0_base(candidates, scores)
    c2 = fix_step1(c1, 0.008 * k)
    c1 = fix_step2(c2, max(1, round(6 / k)))
    c2 = fix_step3(c1, candidates, scores, 0.18 * k, grid_ms=k)
    best = fix_step4(c2, max(1, round(9 / k)))
    f0_grid = smooth_f0_contour(best)
    tpos = jnp.arange(n_out, dtype=candidates.dtype) \
        * (frame_period_ms / 1000.0)
    x = tpos * (1000.0 / grid_ms)
    pick = jnp.minimum(F - 1, jnp.where(
        x > 0, jnp.floor(x + 0.5), jnp.ceil(x - 0.5)).astype(jnp.int32))
    return f0_grid[pick]
