"""Particle sorting for memory locality (reference module_sort,
/root/reference/src/mptrac.c:5699-5811): periodically argsort all
particle arrays by met grid-box index so nearby parcels gather from
nearby met columns.  Replaces GSL/Thrust sort with XLA's argsort; every
per-parcel column is then permuted by one gather."""

from __future__ import annotations

import jax.numpy as jnp

from mptrac_tpu.ops import interp
from mptrac_tpu.types import Atm, Cache, Met


def sort_key(met: Met, atm: Atm) -> jnp.ndarray:
    """Met grid-box index per parcel, Z-MAJOR: (iz*nx + ix)*ny + iy.

    The reference sorts x-major (c:5770-5776); this rebuild sorts
    LEVEL-major instead: parcels on one pressure level drift rigidly
    (vertical cell-crossing between sorts is ~0), so vertical wind
    shear does not tear sorted groups apart.  Uses the same locator as
    the interpolation so the key matches the cells it gathers."""
    lons = met.lon[0] if met.lon.ndim == 2 else met.lon
    lats = met.lat[0] if met.lat.ndim == 2 else met.lat
    loc = interp.locate_3d(met, atm.lon, atm.lat, atm.p)
    nx, ny = lons.shape[0], lats.shape[0]
    key = (loc.iz * nx + loc.ix) * ny + loc.iy
    # keep padding at the end
    return jnp.where(atm.mask, key, jnp.iinfo(jnp.int32).max)


def module_sort(met: Met, atm: Atm, cache: Cache):
    """Stable argsort by grid cell; permutes atm and the per-particle
    cache arrays consistently.  Every column keeps its dtype: parcel
    time stays float64 in float32 compute mode."""
    perm = jnp.argsort(sort_key(met, atm), stable=True)

    def take(x):
        return jnp.take(x, perm, axis=0)

    # (atm.mask is the prefix arange < np; masked parcels sort to the
    # end, so the permuted state keeps a consistent prefix mask)
    iso_per_parcel = cache.iso_var.shape[0] == atm.lon.shape[0]
    atm2 = atm.replace(
        time=take(atm.time), p=take(atm.p), lon=take(atm.lon),
        lat=take(atm.lat), q={k: take(v) for k, v in atm.q.items()})
    cache2 = cache.replace(
        uvwp=jnp.take(cache.uvwp, perm, axis=1), dt=take(cache.dt),
        iso_var=(take(cache.iso_var) if iso_per_parcel
                 else cache.iso_var))
    return atm2, cache2
