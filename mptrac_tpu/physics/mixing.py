"""Interparcel mixing (reference module_mixing / module_mixing_help,
/root/reference/src/mptrac.c:5161-5335): bin parcels into a mixing
grid, average each quantity per box, and relax every parcel toward its
box mean.  The reference's atomic adds become XLA ``segment_sum``
scatter-adds (on a GPU these are atomic too, so the summation order,
and with it the last bits of a box mean, can vary between runs)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mptrac_tpu.config import Ctl
from mptrac_tpu.ops import thermo
from mptrac_tpu.physics.diffusion import tropo_weight
from mptrac_tpu.types import Atm, Clim

#: quantities subject to mixing (reference c:5209-5218)
MIX_QUANTITIES = (
    "m", "vmr", "Ch2o", "Co3", "Cco", "Coh", "Ch", "Cho2", "Ch2o2",
    "Co1d", "Co3p", "Cccl4", "Cccl3f", "Cccl2f2", "Cn2o", "Csf6",
    "aoa", "Arn222", "Apb210", "Abe7", "Acs137", "Ai131", "Axe133")


def grid_indices(ctl: Ctl, atm: Atm, t, prefix: str = "mixing"):
    """Per-parcel grid box indices; -1 marks parcels outside the grid
    or outside the time window (reference c:5193-5203)."""
    z0 = getattr(ctl, f"{prefix}_z0")
    z1 = getattr(ctl, f"{prefix}_z1")
    nz = getattr(ctl, f"{prefix}_nz")
    lon0 = getattr(ctl, f"{prefix}_lon0")
    lon1 = getattr(ctl, f"{prefix}_lon1")
    nx = getattr(ctl, f"{prefix}_nx")
    lat0 = getattr(ctl, f"{prefix}_lat0")
    lat1 = getattr(ctl, f"{prefix}_lat1")
    ny = getattr(ctl, f"{prefix}_ny")

    dz = (z1 - z0) / nz
    dlon = (lon1 - lon0) / nx
    dlat = (lat1 - lat0) / ny
    # C int cast truncates toward zero; negatives are rejected anyway
    ix = jnp.trunc((atm.lon - lon0) / dlon).astype(jnp.int32)
    iy = jnp.trunc((atm.lat - lat0) / dlat).astype(jnp.int32)
    iz = jnp.trunc((thermo.altitude(atm.p) - z0) / dz).astype(jnp.int32)
    t0 = t - 0.5 * ctl.dt_mod
    t1 = t + 0.5 * ctl.dt_mod
    ok = (atm.mask & (atm.time >= t0) & (atm.time <= t1)
          & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
          & (iz >= 0) & (iz < nz))
    return ix, iy, iz, ok


def module_mixing(ctl: Ctl, clim: Clim, atm: Atm, t) -> Atm:
    ix, iy, iz, ok = grid_indices(ctl, atm, t, "mixing")
    nx, ny, nz = ctl.mixing_nx, ctl.mixing_ny, ctl.mixing_nz
    ngrid = nx * ny * nz
    use_ens = ctl.nens > 0
    nens = ctl.nens if use_ens else 1

    idx = (ix * ny + iy) * nz + iz
    if use_ens:
        ens = atm.q["ens"].astype(jnp.int32)
        idx = idx + ens * ngrid
    idx = jnp.where(ok, idx, ngrid * nens)  # overflow bucket

    count = jax.ops.segment_sum(
        jnp.where(ok, 1, 0), idx, num_segments=ngrid * nens + 1)

    mixparam_needed = ctl.mixing_trop < 1 or ctl.mixing_strat < 1
    if mixparam_needed:
        w = tropo_weight(ctl, clim, atm.time, atm.lat, atm.p)
        mixparam = w * ctl.mixing_trop + (1.0 - w) * ctl.mixing_strat
    else:
        mixparam = 1.0

    q = dict(atm.q)
    for name in MIX_QUANTITIES:
        if name not in q:
            continue
        total = jax.ops.segment_sum(
            jnp.where(ok, q[name], 0.0), idx,
            num_segments=ngrid * nens + 1)
        cmean = total / jnp.maximum(count, 1)
        delta = (cmean[idx] - q[name]) * mixparam
        q[name] = jnp.where(ok, q[name] + delta, q[name])
    return atm.replace(q=q)
