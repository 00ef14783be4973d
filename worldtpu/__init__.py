"""worldtpu — a JAX (XLA + a Pallas/Triton GPU kernel) rebuild of the
WORLD vocoder.

Re-designed from the capabilities of yukara-ikemiya/world-class (C++/OpenMP):
the per-frame OpenMP loops of the reference become batched tensor programs
over frames/bands/pulses on one device, and shard_map sharding over
utterance batches and the frame axis across devices.

Public API mirrors the reference classes (see api.py):
    Harvest, CheapTrick, D4C, Synthesis + codec functions.
"""

__version__ = "0.1.0"

_API_NAMES = (
    "HarvestOption", "CheapTrickOption", "D4COption",
    "Harvest", "CheapTrick", "D4C", "Synthesis", "World",
)


def __getattr__(name):
    if name in _API_NAMES:
        from worldtpu import api
        return getattr(api, name)
    raise AttributeError(f"module 'worldtpu' has no attribute {name!r}")
