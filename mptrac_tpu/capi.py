"""Python side of the C binding (bindings/mptrac_c.c).

The C shim embeds the interpreter and calls these module-level
functions with plain scalars/strings; simulation state lives in a
handle registry here.  This is the analog of the reference
Fortran wrapper (/root/reference/src/mptrac_fortran.f90:123-807),
which exposes the 14 ``mptrac_*`` library calls to foreign code.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, Optional

_handles: Dict[int, object] = {}
_ids = itertools.count(1)


def create(dirname: str, ctl_file: str, atm_file: str,
           args: Optional[list] = None) -> int:
    """mptrac_read_ctl + read_atm + mptrac_init; returns a handle."""
    import os

    from mptrac_tpu import read_ctl
    from mptrac_tpu.io import atm_io
    from mptrac_tpu.sim import Simulation

    ctl = read_ctl(os.path.join(dirname, ctl_file), list(args or ()))
    atm = atm_io.read_atm(os.path.join(dirname, atm_file), ctl)
    sim = Simulation(ctl, atm, dirname=dirname)
    h = next(_ids)
    _handles[h] = {"sim": sim, "times": sim.times(), "first": True,
                   "t": float("nan")}
    return h


def t_start(h: int) -> float:
    return float(_handles[h]["sim"].ctl.t_start)


def t_stop(h: int) -> float:
    return float(_handles[h]["sim"].ctl.t_stop)


def time(h: int) -> float:
    return _handles[h]["t"]


def step(h: int, write_output: bool = True) -> int:
    """Advance one model timestep (mptrac_get_met +
    mptrac_run_timestep + mptrac_write_output).  Returns 1 while
    stepping, 0 when the time loop is exhausted."""
    st = _handles[h]
    t = next(st["times"], None)
    if t is None:
        st["sim"].close()
        return 0
    st["sim"].advance(t, write_output, first=st["first"])
    st["first"] = False
    st["t"] = float(t)
    return 1


def run(h: int, write_output: bool = True) -> int:
    """Run the remaining time loop to completion."""
    while step(h, write_output):
        pass
    return 0


def n_parcels(h: int) -> int:
    return int(_handles[h]["sim"].atm.np)


def get_positions(h: int, lon_addr: int, lat_addr: int, p_addr: int,
                  cap: int) -> int:
    """Copy parcel positions into caller-owned buffers (addresses of
    double[cap]); the mptrac_update_host analog.  Returns the parcel
    count written."""
    import ctypes

    import numpy as np

    sim = _handles[h]["sim"]
    n = min(int(sim.atm.np), cap)
    for addr, arr in ((lon_addr, sim.atm.lon), (lat_addr, sim.atm.lat),
                      (p_addr, sim.atm.p)):
        buf = (ctypes.c_double * n).from_address(addr)
        np.frombuffer(buf, np.float64)[:] = np.asarray(
            arr[:n], np.float64)
    return n


def write_atm(h: int, path: str) -> int:
    """mptrac_write_atm analog: dump current particle state."""
    from mptrac_tpu.io import atm_io

    sim = _handles[h]["sim"]
    atm_io.write_atm(path, sim.ctl, sim.atm, _handles[h]["t"])
    return 0


def destroy(h: int) -> int:
    st = _handles.pop(h, None)
    if st is not None:
        st["sim"].close()
    return 0
