#!/usr/bin/env python
"""Batch-occupancy curve: config-5 pipeline throughput at B=8/16/32/64.

One jitted batch_wav_to_wav per B (fresh geometry, same 3 s utterances
tiled), amortized walls (`reps` dispatches share one block_until_ready).
Prints one JSON line per B:
    {"B": n, "wall_ms_per_batch": w, "rtf": audio_seconds/wall}

Usage: python tools/bscale.py [reps] [Bs...]
"""

import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp

from bench import synth_utterance
from worldtpu.analysis.harvest import HarvestKernel
from worldtpu.analysis.cheaptrick import CheapTrickKernel
from worldtpu.synthesis import synthesis as S
from worldtpu.parallel import batch as B


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    bs = [int(a) for a in sys.argv[2:]] or [8, 16, 32, 64]
    fs = 22050
    pitch_scale, dur_scale = 1.2, 1.25
    xs1 = [np.pad(synth_utterance(fs, 3.0, 160.0 + 15 * i, i),
                  (0, 4096 * ((3 * fs + 4095) // 4096) - 3 * fs))
           for i in range(8)]
    T = len(xs1[0])
    ck = CheapTrickKernel(fs)
    hk = HarvestKernel(fs, T, f0_floor=40.0)
    f0_once = np.stack([f for f, _ in hk.compute_batch(
        jnp.asarray(np.stack(xs1)))]).astype(np.float32)
    out_len = int((f0_once.shape[1] - 1) * 0.005 * dur_scale * fs) + 1
    mp = S.estimate_max_pulses(f0_once, fs, ck.fft_size, out_len,
                               pitch_scale=pitch_scale)
    mp = -(-mp // 128) * 128

    for n in bs:
        xs = np.stack([xs1[i % 8] for i in range(n)]).astype(np.float32)
        x_dev = jax.device_put(jnp.asarray(xs))
        noise = S.make_noise(jax.random.PRNGKey(0), n * mp, ck.fft_size,
                             jnp.float32).reshape(n, mp, -1)
        jax.block_until_ready((x_dev, noise))

        def run(xd):
            y, f0 = B.batch_wav_to_wav(
                xd, noise, geo=hk.geo, fs=fs, fft_size=ck.fft_size,
                max_half_window=ck.max_half_window,
                frame_period_s=0.005 * dur_scale, out_length=out_len,
                max_pulses=mp, mesh=None, pitch_scale=pitch_scale)
            return y

        try:
            y = run(x_dev)
            jax.block_until_ready(y)
            xds = [x_dev if i == 0
                   else x_dev * (1.0 + np.float32(i) * 1e-7)
                   for i in range(reps)]
            jax.block_until_ready(xds)
            best = np.inf
            for _ in range(2):
                t0 = time.time()
                outs = [run(xd) for xd in xds]
                jax.block_until_ready(outs)
                best = min(best, (time.time() - t0) / reps)
            print(json.dumps({
                "B": n, "wall_ms_per_batch": round(best * 1e3, 1),
                "rtf": round(n * 3.0 / best, 1),
                "rtf_per_utt_ms": round(best * 1e3 / n, 2)}), flush=True)
        except Exception as e:  # noqa: BLE001
            print(json.dumps({"B": n, "error": repr(e)[:200]}), flush=True)


if __name__ == "__main__":
    main()
