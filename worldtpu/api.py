"""Public facades mirroring the reference classes.

Reference signatures: Harvest/CheapTrick/D4C/Synthesis in
/root/reference/include/{harvest,cheaptrick,d4c,synthesis}.hpp — option
structs with the same names and defaults, ctor(fs, option) pre-computing
geometry, compute() doing the work.  JAX being functional, compute() returns
outputs instead of filling caller buffers; the sizing helpers (getSamples,
getFFTSizeForCheapTrick) keep the exact reference formulas so configs are
portable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from worldtpu import constants as C
from worldtpu.analysis import cheaptrick as _ct
from worldtpu.analysis import d4c as _d4c
from worldtpu.analysis import harvest as _harvest
from worldtpu.ops.fftutil import fft_size_for_cheaptrick, f0_floor_for_cheaptrick
from worldtpu.synthesis import synthesis as _syn


@dataclasses.dataclass
class HarvestOption:
    """Reference HarvestOption (/root/reference/src/harvest.cpp:52-56)."""
    f0_floor: float = C.FLOOR_F0
    f0_ceil: float = C.CEIL_F0
    frame_period: float = 5.0
    target_fs: float = 8000.0
    channels_in_octave: float = 40.0
    use_cos_table: bool = False


@dataclasses.dataclass
class CheapTrickOption:
    """Reference CheapTrickOption (/root/reference/src/cheaptrick.cpp:22-24)."""
    q1: float = -0.15
    f0_floor: float = C.FLOOR_F0
    fft_size: int = 0  # 0 = auto from f0_floor


@dataclasses.dataclass
class D4COption:
    """Reference D4COption (/root/reference/src/d4c.cpp:31-33)."""
    threshold: float = C.THRESHOLD


class Harvest:
    """F0 estimation (reference /root/reference/include/harvest.hpp:31-45)."""

    def __init__(self, fs: int, option: Optional[HarvestOption] = None):
        self.fs = fs
        self.option = option or HarvestOption()
        self._kernels = {}

    def get_samples(self, fs: int, x_length: int,
                    frame_period: Optional[float] = None) -> int:
        fp = frame_period if frame_period is not None else self.option.frame_period
        return int(1000.0 * x_length / fs / fp) + 1

    def _kernel(self, x_length: int) -> _harvest.HarvestKernel:
        if x_length not in self._kernels:
            o = self.option
            self._kernels[x_length] = _harvest.HarvestKernel(
                self.fs, x_length, f0_floor=o.f0_floor, f0_ceil=o.f0_ceil,
                frame_period=o.frame_period, target_fs=o.target_fs,
                channels_in_octave=o.channels_in_octave,
                use_cos_table=o.use_cos_table)
        return self._kernels[x_length]

    def compute(self, x, dtype=jnp.float64):
        """Returns (temporal_positions [F], f0 [F]) as numpy arrays."""
        x = np.asarray(x)
        f0, tpos = self._kernel(len(x)).compute(x, dtype=dtype)
        return tpos, f0


class CheapTrick:
    """Spectral envelope (reference include/cheaptrick.hpp:23-38)."""

    def __init__(self, fs: int, option: Optional[CheapTrickOption] = None):
        self.fs = fs
        self.option = option or CheapTrickOption()
        fft = self.option.fft_size or fft_size_for_cheaptrick(
            fs, self.option.f0_floor)
        self._kernel = _ct.CheapTrickKernel(
            fs, fft_size=fft, f0_floor=self.option.f0_floor,
            q1=self.option.q1)
        self.fft_size = fft
        self.f0_floor = f0_floor_for_cheaptrick(fs, fft)

    @staticmethod
    def get_fft_size_for_cheaptrick(fs: int, f0_floor: float = C.FLOOR_F0) -> int:
        return fft_size_for_cheaptrick(fs, f0_floor)

    @staticmethod
    def get_f0_floor_for_cheaptrick(fs: int, fft_size: int) -> float:
        return f0_floor_for_cheaptrick(fs, fft_size)

    def compute(self, x, temporal_positions, f0, dtype=jnp.float64):
        """Returns spectrogram [F, fft_size//2+1] (power)."""
        return self._kernel(
            jnp.asarray(x, dtype), jnp.asarray(f0, dtype),
            jnp.asarray(temporal_positions, dtype))


class D4C:
    """Band aperiodicity (reference include/d4c.hpp:23-36)."""

    def __init__(self, fs: int, option: Optional[D4COption] = None):
        self.fs = fs
        self.option = option or D4COption()

    def compute(self, x, temporal_positions, f0, fft_size, dtype=jnp.float64):
        """Returns aperiodicity [F, fft_size//2+1]."""
        return _d4c.d4c_frames(
            jnp.asarray(x, dtype), jnp.asarray(f0, dtype),
            jnp.asarray(temporal_positions, dtype),
            fs=self.fs, fft_size_out=fft_size,
            threshold=self.option.threshold)


class Synthesis:
    """Waveform synthesis (reference include/synthesis.hpp:16-51)."""

    def __init__(self, fs: int, fft_size: int, frame_period: float,
                 f0_ceil: float = C.CEIL_F0):
        self.fs = fs
        self.fft_size = fft_size
        self.frame_period = frame_period      # milliseconds, like the ctor
        self.f0_ceil = f0_ceil

    def compute(self, f0, spectrogram, aperiodicity, out_length,
                key=None, noise=None, dtype=jnp.float64, max_pulses=None):
        """Returns y [out_length].

        Noise: pass a jax PRNG key (default key 0) or an explicit
        [max_pulses, fft_size] noise matrix (e.g. the xorshift parity
        stream)."""
        fp_s = self.frame_period / 1000.0
        caller_noise = noise is not None
        if max_pulses is None:
            max_pulses = _syn.estimate_max_pulses(
                f0, self.fs, self.fft_size, out_length)
        hard = _syn.default_max_pulses(out_length, self.fs,
                                       f0_ceil=max(self.f0_ceil,
                                                   float(np.max(f0))))
        if key is None:
            key = jax.random.PRNGKey(0)
        while True:
            if not caller_noise:
                noise = _syn.make_noise(key, max_pulses, self.fft_size, dtype)
            y, overflowed = _syn.synthesis_frames(
                jnp.asarray(f0, dtype), jnp.asarray(spectrogram, dtype),
                jnp.asarray(aperiodicity, dtype), jnp.asarray(noise, dtype),
                fs=self.fs, fft_size=self.fft_size, frame_period_s=fp_s,
                out_length=out_length, max_pulses=max_pulses,
                return_overflow=True)
            if not bool(overflowed):
                return y
            if max_pulses >= hard or caller_noise:
                # caller pinned the noise matrix (parity runs) — dropping
                # tail pulses is the only shape-preserving option; surface it
                raise OverflowError(
                    f"pulse count exceeds max_pulses={max_pulses} "
                    f"(hard bound {hard}); pass a larger max_pulses")
            max_pulses = min(hard, max_pulses * 2)


class World:
    """Fused pipeline facade: the reference demo's whole workflow
    (/root/reference/test/test.cpp:288-384 — Harvest -> CheapTrick -> D4C
    [-> Synthesis]) as ONE compiled program per input geometry.

    The per-class facades above mirror the reference's four separate
    compute() calls; each call pays a dispatch + download round trip,
    which matters for a single short utterance.  `World.analyze` and
    `World.copy_synthesis` run the same math as one jitted program with
    F0 never visiting the host (production float32 path).
    """

    def __init__(self, fs: int, *, frame_period: float = 5.0,
                 f0_floor: float = C.FLOOR_F0, f0_ceil: float = C.CEIL_F0):
        self.fs = fs
        self.frame_period = frame_period
        self.f0_floor = f0_floor
        self.f0_ceil = f0_ceil
        # CheapTrick keeps its own default floor geometry regardless of the
        # Harvest search floor — exactly like the reference demo, where
        # HarvestOption.f0_floor=40 coexists with default CheapTrickOption
        # (/root/reference/test/test.cpp:96-99,139-143)
        self._cheaptrick = CheapTrick(fs)
        self.fft_size = self._cheaptrick.fft_size
        self._harvest = Harvest(fs, HarvestOption(
            f0_floor=f0_floor, f0_ceil=f0_ceil, frame_period=frame_period))

    def analyze(self, x, pitch_scale: float = 1.0, dtype=jnp.float32):
        """wav -> (temporal_positions, f0, spectrogram, aperiodicity),
        one device dispatch."""
        from worldtpu.parallel import batch as _B
        x = np.asarray(x, np.float32 if dtype == jnp.float32 else np.float64)
        hk = self._harvest._kernel(len(x))
        ck = self._cheaptrick._kernel
        f0, spec, ap = _B.batch_analyze(
            jnp.asarray(x, dtype)[None], geo=hk.geo, fs=self.fs,
            fft_size=self.fft_size, max_half_window=ck.max_half_window,
            pitch_scale=pitch_scale)
        F = f0.shape[1]
        tpos = np.arange(F) * (self.frame_period / 1000.0)
        return tpos, np.asarray(f0[0]), np.asarray(spec[0]), \
            np.asarray(ap[0])

    def copy_synthesis(self, x, *, pitch_scale: float = 1.0,
                       duration_scale: float = 1.0, key=None,
                       dtype=jnp.float32):
        """wav -> wav (analysis + resynthesis with optional pitch/duration
        modification), one device dispatch; returns (y, f0)."""
        from worldtpu.parallel import batch as _B
        x = np.asarray(x, np.float32 if dtype == jnp.float32 else np.float64)
        hk = self._harvest._kernel(len(x))
        ck = self._cheaptrick._kernel
        F = hk.get_samples()
        fp_s = self.frame_period / 1000.0 * duration_scale
        out_length = int((F - 1) * fp_s * self.fs) + 1
        # Static capacity bound + overflow-checked regrow: ordinary speech
        # runs with the small (~500 Hz-rate) slab; a sustained-high-F0
        # pathology flags and reruns with a doubled bound up to the
        # reference's worst case (src/synthesis.cpp:87-88).
        mp = _syn.capacity_max_pulses(out_length, self.fs)
        hard = _syn.default_max_pulses(out_length, self.fs,
                                       f0_ceil=self.f0_ceil * pitch_scale)
        if key is None:
            key = jax.random.PRNGKey(0)
        while True:
            noise = _syn.make_noise(key, mp, self.fft_size, dtype)[None]
            y, f0, ovf = _B.batch_wav_to_wav(
                jnp.asarray(x, dtype)[None], noise, geo=hk.geo, fs=self.fs,
                fft_size=self.fft_size, max_half_window=ck.max_half_window,
                frame_period_s=fp_s, out_length=out_length, max_pulses=mp,
                mesh=None, pitch_scale=pitch_scale, return_overflow=True)
            if not bool(ovf[0]):
                return np.asarray(y[0]), np.asarray(f0[0])
            if mp >= hard:
                # mirrors Synthesis.compute: even the hard bound can be
                # exceeded by the extrapolated end knot of the coarse F0
                # (synthesis.py:67) — never return silently-truncated audio
                raise OverflowError(
                    f"pulse count exceeds max_pulses={mp} (hard bound "
                    f"{hard}); pass a larger pitch-scaled capacity")
            mp = min(hard, mp * 2)
