#!/usr/bin/env python
"""End-to-end A/B of the f32 refine implementations on a GPU.

Compiles bench config 5's wav->wav program (batch_wav_to_wav, B = 8
speech-shaped 22.05 kHz utterances, pitch x1.2, duration x1.25) twice in
one process — once with the Triton refine kernel, once with the dense
refine_stage (both after the shared dedup pre-pass) — then times them in
alternation (A B B A ...) with block_until_ready, and checks that both
give the same F0.  Prints one JSON line with both walls and the card.

Usage: python tools/refine_ab.py [rounds]
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    import chip_smoke as CS
    from worldtpu import runtime
    from worldtpu.analysis import harvest as H

    if jax.default_backend() != "gpu":
        sys.exit(f"refine_ab: no GPU (backend {jax.default_backend()!r})")
    runtime.setup_compile_cache()
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    x = CS.config5_batch()
    B, T = x.shape
    choose = H.refine_backend
    compiled, outs = {}, {}
    for kind in ("triton", "dense"):
        H.refine_backend = (lambda platform=None, k=kind:
                            "dense" if platform == "cpu" else k)
        jax.clear_caches()
        f, noise, _, _ = CS.wav_to_wav_program(T, B, CS.FS5,
                                               pitch=CS.PITCH5, dur=CS.DUR5)
        args = (jnp.asarray(x), noise)
        t0 = time.time()
        compiled[kind] = f.lower(*args).compile()
        t_c = time.time() - t0
        outs[kind] = jax.block_until_ready(compiled[kind](*args))
        print(f"{kind}: compile {t_c:.2f} s", flush=True)
    H.refine_backend = choose

    walls = {"triton": [], "dense": []}
    order = ["triton", "dense", "dense", "triton"]
    for _ in range(rounds):
        for kind in order:
            t0 = time.time()
            jax.block_until_ready(compiled[kind](*args))
            walls[kind].append(time.time() - t0)
    f0a, f0b = (np.asarray(outs[k][1], np.float64) for k in walls)
    both = (f0a > 0) & (f0b > 0)
    smi = runtime.gpu_name_and_power_limit()
    print(json.dumps({
        "batch": [B, T], "rounds": rounds, "order": order,
        "wall_ms": {k: {"min": min(v) * 1e3, "median":
                        float(np.median(v)) * 1e3} for k, v in walls.items()},
        "f0_rmse_triton_vs_dense_hz": float(np.sqrt(np.mean(
            (f0a[both] - f0b[both]) ** 2))) if both.any() else 0.0,
        "f0_vuv_agree": float(np.mean((f0a > 0) == (f0b > 0))),
        "device": runtime.device_info(), "nvidia_smi": smi}))


if __name__ == "__main__":
    main()
