"""mptrac_tpu — Lagrangian particle dispersion framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of MPTRAC
(Massive-Parallel Trajectory Calculations): kinematic/diabatic advection
of millions of air parcels through time-interpolated reanalysis wind
fields, stochastic turbulence and convection, chemistry, deposition and
gridded output — designed for GPU device meshes via jax.sharding
rather than the reference's OpenMP/OpenACC/MPI stack.

Positions and times are tracked in float64 (the reference computes in
double over float32 met fields); x64 mode is enabled at import unless
``MPTRAC_NO_X64`` is set.
"""

import os

import jax

if not os.environ.get("MPTRAC_NO_X64"):
    jax.config.update("jax_enable_x64", True)

from mptrac_tpu import constants  # noqa: E402
from mptrac_tpu.config import Ctl, read_ctl  # noqa: E402
from mptrac_tpu.types import Atm, Cache, Clim, Met, stack_met  # noqa: E402
from mptrac_tpu.timeutil import time2jsec, jsec2time  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Atm", "Cache", "Clim", "Ctl", "Met", "constants", "jsec2time",
    "read_ctl", "stack_met", "time2jsec",
]
