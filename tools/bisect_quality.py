#!/usr/bin/env python
"""Bisect the f32 F0 quality margin against the C++ reference.

Runs the production f32 Harvest on the bench's config-1 vowel under each
combination of the quality-relevant choices — the band-filter form
(CONV_MODE) and the shared refine dedup tolerance (REFINE_DEDUP_TOL, 0 =
off) — and prints F0 RMSE and VUV agreement against the C++ dump for
each.  One process: each combination patches the module settings and
clears JAX's caches before it compiles, so one card serves every combo.

Usage: python tools/bisect_quality.py
"""

import json
import pathlib
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

COMBOS = [
    ("default", {}),
    ("conv=conv", {"CONV_MODE": "conv"}),
    ("dedup=0", {"REFINE_DEDUP_TOL": 0.0}),
    ("conv=conv,dedup=0", {"CONV_MODE": "conv", "REFINE_DEDUP_TOL": 0.0}),
    # stronger dedup (it helps C++ fidelity up to a point — probe how far)
    ("dedup=0.008", {"REFINE_DEDUP_TOL": 0.008}),
    ("dedup=0.012", {"REFINE_DEDUP_TOL": 0.012}),
    ("dedup=0.02", {"REFINE_DEDUP_TOL": 0.02}),
]


def run_one(x, fs, ref, settings):
    import jax
    import jax.numpy as jnp
    from worldtpu.analysis import harvest as H

    saved = {k: getattr(H, k) for k in settings}
    try:
        for k, v in settings.items():
            setattr(H, k, v)
        jax.clear_caches()
        hk = H.HarvestKernel(fs, len(x), f0_floor=40.0)
        f0, _ = hk.compute(jnp.asarray(x, jnp.float32), dtype=jnp.float32)
    finally:
        for k, v in saved.items():
            setattr(H, k, v)
        jax.clear_caches()
    f0 = np.asarray(f0)
    n = min(len(f0), len(ref))
    f0, r = f0[:n], ref[:n]
    both = (f0 > 0) & (r > 0)
    rmse = float(np.sqrt(np.mean((f0[both] - r[both]) ** 2))) \
        if both.any() else 0.0
    return {"f0_rmse_hz": round(rmse, 6),
            "vuv_agreement": round(float(np.mean((f0 > 0) == (r > 0))), 6),
            "n_disagree": int(np.sum((f0 > 0) != (r > 0)))}


def main():
    from bench import build_reference, synth_utterance
    from worldtpu.io import params as params_io
    from worldtpu.io import wav as wav_io

    work = pathlib.Path(tempfile.mkdtemp(prefix="worldtpu_bisect_"))
    fs = 16000
    x = synth_utterance(fs, 3.0, 160.0, 0)
    wav_path = work / "u16.wav"
    wav_io.wavwrite(wav_path, x.astype(np.float64), fs)

    _, dump_bin = build_reference()
    if dump_bin is None:
        sys.exit("bisect_quality: cannot build the C++ reference dumper "
                 "(needs /root/reference and g++); no reference to "
                 "bisect against")
    subprocess.run([str(dump_bin), str(wav_path), str(work / "q"), "5.0"],
                   check=True, capture_output=True, timeout=600,
                   cwd=str(work))
    f0_ref, _, _ = params_io.read_f0(work / "q.f0")
    ref = np.asarray(f0_ref)
    for name, settings in COMBOS:
        print(f"{name:24s} {json.dumps(run_one(x, fs, ref, settings))}",
              flush=True)


if __name__ == "__main__":
    main()
