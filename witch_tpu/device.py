"""The one device decision of the pipeline.

On a GPU every device stage runs on the card: the Forward pre-score of
the whole query x HMM grid (ops/pallas_forward.py) and the reporting
gate's per-envelope null2 (hmm/gate_device.py). A device error there
fails the run. Everywhere else the native host engine runs those stages
(native/domaindef_kernel.cpp), exactly as it does in the CPU tests.
"""

from __future__ import annotations

import jax


def on_gpu() -> bool:
    """True when JAX's default backend is a GPU."""
    return jax.default_backend() == "gpu"
