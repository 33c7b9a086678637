"""Advection: Euler / midpoint / RK4 integration of the wind field
(reference module_advect, /root/reference/src/mptrac.c:3598-3789).

The per-parcel scalar RK loop of the reference becomes a short Python
loop over RK nodes (static, ctl.advect in {1,2,4}), each node a batched
interpolation over all parcels — XLA sees a fixed unrolled graph of
gathers and fused arithmetic.
"""

from __future__ import annotations

import jax.numpy as jnp

from mptrac_tpu.config import Ctl
from mptrac_tpu.ops import interp
from mptrac_tpu.ops.thermo import dx2coord, dy2coord
from mptrac_tpu.types import Atm, Cache, Met


def module_advect(ctl: Ctl, cache: Cache, met01: Met, atm: Atm,
                  pack=None) -> Atm:
    """Advance parcel positions by one model step (reference
    module_advect, c:3598)."""
    if ctl.advect_vert_coord in (0, 2):
        return _advect_plev(ctl, cache, met01, atm, pack)
    return _advect_zeta(ctl, cache, met01, atm)


def _rk_weight(ctl: Ctl, i: int) -> float:
    if ctl.advect == 2:
        return 0.0 if i == 0 else 1.0
    if ctl.advect == 4:
        return 1.0 / 6.0 if i in (0, 3) else 2.0 / 6.0
    return 1.0


def _advect_plev(ctl: Ctl, cache: Cache, met01: Met, atm: Atm,
                 pack=None) -> Atm:
    """Kinematic advection with omega on pressure levels
    (advect_vert_coord 0) or on model levels (2).

    When a packed wind table is supplied (ops.fast_interp), the
    per-node interpolation uses one wide-row gather in float32 instead
    of 48 scalar gathers in float64."""
    cart = met01.coord_type != 0
    dt = cache.dt
    active = (dt != 0.0) & atm.mask

    um = vm = wm = 0.0
    u = v = w = None
    for i in range(ctl.advect):
        if i == 0:
            dts = 0.0
            x = (atm.lon, atm.lat, atm.p)
        else:
            dts = (1.0 if i == 3 else 0.5) * dt
            x = (atm.lon + dx2coord(dts * u, atm.lat, cart),
                 atm.lat + dy2coord(dts * v, cart),
                 atm.p + dts * w)
        tm = atm.time + dts
        if ctl.advect_vert_coord == 0 and pack is not None:
            from mptrac_tpu.ops.fast_interp import (interp_uvw_packed,
                                                    interp_uvw_packed64)
            loc = interp.locate_3d(met01, x[0], x[1], x[2])
            if pack.shape[-1] == 64:
                u, v, w = interp_uvw_packed64(met01, pack, tm, loc)
            else:
                u, v, w = interp_uvw_packed(met01, pack, tm, loc)
        elif ctl.advect_vert_coord == 0:
            loc = interp.locate_3d(met01, x[0], x[1], x[2])
            u = interp.interp_time_3d(met01, "u", tm, loc)
            v = interp.interp_time_3d(met01, "v", tm, loc)
            w = interp.interp_time_3d(met01, "w", tm, loc)
        else:
            u = interp.interp_4d_zeta(met01, "pl", "ul", tm, x[2], x[0], x[1])
            v = interp.interp_4d_zeta(met01, "pl", "vl", tm, x[2], x[0], x[1])
            w = interp.interp_4d_zeta(met01, "pl", "wl", tm, x[2], x[0], x[1])
        k = _rk_weight(ctl, i)
        um = um + k * u
        vm = vm + k * v
        wm = wm + k * w
        lat_node = x[1]

    # Reference uses the last RK node's latitude for the final zonal
    # conversion under the midpoint scheme (c:3674).
    lat_for_dx = lat_node if ctl.advect == 2 else atm.lat
    new_time = atm.time + dt
    new_lon = atm.lon + dx2coord(dt * um, lat_for_dx, cart)
    new_lat = atm.lat + dy2coord(dt * vm, cart)
    new_p = atm.p + dt * wm
    return atm.replace(
        time=jnp.where(active, new_time, atm.time),
        lon=jnp.where(active, new_lon, atm.lon),
        lat=jnp.where(active, new_lat, atm.lat),
        p=jnp.where(active, new_p, atm.p))


def _advect_zeta(ctl: Ctl, cache: Cache, met01: Met, atm: Atm) -> Atm:
    """Diabatic advection in the zeta (1) or eta (3) vertical
    coordinate (reference c:3684-3764): the vertical state is carried
    in the corresponding quantity; pressure is re-diagnosed after the
    step."""
    cart = met01.coord_type != 0
    qnt = "zeta" if ctl.advect_vert_coord == 1 else "eta"
    dt = cache.dt
    active = (dt != 0.0) & atm.mask

    # Convert current pressure to the vertical coordinate
    zeta0 = interp.interp_4d_zeta(met01, "pl", "zetal", atm.time, atm.p,
                                  atm.lon, atm.lat)

    um = vm = wdm = 0.0
    u = v = wdot = None
    for i in range(ctl.advect):
        if i == 0:
            dts = 0.0
            x = (atm.lon, atm.lat, zeta0)
        else:
            dts = (1.0 if i == 3 else 0.5) * dt
            x = (atm.lon + dx2coord(dts * u, atm.lat, cart),
                 atm.lat + dy2coord(dts * v, cart),
                 zeta0 + dts * wdot)
        tm = atm.time + dts
        u = interp.interp_4d_zeta(met01, "zetal", "ul", tm, x[2], x[0], x[1])
        v = interp.interp_4d_zeta(met01, "zetal", "vl", tm, x[2], x[0], x[1])
        wdot = interp.interp_4d_zeta(met01, "zetal", "zeta_dotl", tm, x[2],
                                     x[0], x[1])
        k = _rk_weight(ctl, i)
        um = um + k * u
        vm = vm + k * v
        wdm = wdm + k * wdot
        lat_node = x[1]

    lat_for_dx = lat_node if ctl.advect == 2 else atm.lat
    new_time = atm.time + dt
    new_lon = atm.lon + dx2coord(dt * um, lat_for_dx, cart)
    new_lat = atm.lat + dy2coord(dt * vm, cart)
    new_zeta = zeta0 + dt * wdm
    new_p = interp.interp_4d_zeta(met01, "zetal", "pl", new_time, new_zeta,
                                  new_lon, new_lat)
    q = dict(atm.q)
    if qnt in q:
        q[qnt] = jnp.where(active, new_zeta, zeta0)
    return atm.replace(
        time=jnp.where(active, new_time, atm.time),
        lon=jnp.where(active, new_lon, atm.lon),
        lat=jnp.where(active, new_lat, atm.lat),
        p=jnp.where(active, new_p, atm.p),
        q=q)


def module_advect_init(ctl: Ctl, met01: Met, atm: Atm) -> Atm:
    """Initialize pressure consistent with the zeta coordinate
    (reference module_advect_init, c:3766)."""
    if ctl.advect_vert_coord != 1 or "zeta" not in atm.q:
        return atm
    p = interp.interp_4d_zeta(met01, "zetal", "pl", atm.time,
                              atm.q["zeta"], atm.lon, atm.lat)
    return atm.replace(p=jnp.where(atm.mask, p, atm.p))
