"""Central registry for the WORLDTPU_* runtime tuning knobs.

Every knob the production path reads lives here: one place to see the
supported values and the default.

Binding is at IMPORT time, deliberately: the knobs select compiled-program
structure (matmul forms and precision, the candidate grid), and the jitted
entry points cache on their static arguments only — a knob that changed
under a warm jit cache would silently return stale programs.  Processes
must set the environment before importing worldtpu.

Reference analog: the option structs of
/root/reference/include/{harvest,cheaptrick,d4c}.hpp hold the *algorithm*
parameters (mirrored by worldtpu.api dataclasses); these flags are the
*implementation* selectors the C++ build fixes at compile time instead
(OpenMP thread counts, -mavx, the FFT backend).
"""

from __future__ import annotations

import dataclasses
import os

import jax


class FlagError(ValueError):
    """A WORLDTPU_* environment variable has an unsupported value."""


def _choice(name, default, allowed):
    v = os.environ.get(name, default)
    if v not in allowed:
        raise FlagError(f"{name}={v!r}: allowed values {sorted(allowed)}")
    return v


def _int_min(name, default, lo):
    raw = os.environ.get(name, str(default))
    try:
        v = int(raw)
    except ValueError:
        raise FlagError(f"{name}={raw!r}: not an integer") from None
    if v < lo:
        raise FlagError(f"{name}={v}: must be >= {lo}")
    return v


_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


@dataclasses.dataclass(frozen=True)
class Flags:
    """Parsed + validated WORLDTPU_* knobs (see module docstring)."""

    #: WORLDTPU_CONV: band-filter implementation, "matmul" (blocked-
    #: Toeplitz matmul form) or "conv" (conv_general_dilated).  Both give
    #: the same F0 up to f32 rounding; which is faster on the GPU is not
    #: measured yet.
    conv: str = "matmul"

    #: WORLDTPU_CONV_PRECISION: precision of the band-filter matmul.
    #: "default" lets the backend use its fast f32 matmul (TF32 on a
    #: Hopper GPU); "highest" is full f32.  Not quality-neutral at voicing
    #: knife edges, so a change is gated on the bench's quality block.
    conv_precision: object = _PRECISIONS["default"]

    #: WORLDTPU_GRID_MS: internal candidate/refine grid period (ms) for
    #: the f32 path.  2 halves per-frame cost but costs voicing-boundary
    #: resolution (vuv 0.97 on onset-heavy fixtures) — documented fast
    #: mode, never the default.
    grid_ms: int = 1

    @staticmethod
    def from_env() -> "Flags":
        return Flags(
            conv=_choice("WORLDTPU_CONV", "matmul", {"conv", "matmul"}),
            conv_precision=_PRECISIONS[_choice(
                "WORLDTPU_CONV_PRECISION", "default", set(_PRECISIONS))],
            grid_ms=_int_min("WORLDTPU_GRID_MS", 1, 1),
        )


#: The process-wide knob values (import-time bound; see module docstring).
FLAGS = Flags.from_env()
