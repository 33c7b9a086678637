"""Stochastic turbulent and mesoscale diffusion.

Reference: module_diff_turb (/root/reference/src/mptrac.c:4580-4730),
module_diff_meso (c:4258-4335), pbl_weight (c:8034), tropo_weight
(c:12424).  Random numbers are drawn from the Squares counter RNG in
exactly the reference's per-module order (3*np normals + counter
advance), so runs are cross-checkable bit-for-bit against the
reference.
"""

from __future__ import annotations

import jax.numpy as jnp

from mptrac_tpu.climatology import clim_tropo
from mptrac_tpu.config import Ctl
from mptrac_tpu.constants import H0
from mptrac_tpu.ops import interp
from mptrac_tpu.ops.rng import module_rng3
from mptrac_tpu.ops.thermo import dx2coord, dy2coord, dz2dp
from mptrac_tpu.types import Atm, Cache, Clim, Met


def pbl_weight(ctl: Ctl, p, pbl, ps):
    """PBL blending weight (reference pbl_weight, c:8034)."""
    p1 = pbl - ctl.turb_pbl_trans * (ps - pbl)
    p0 = pbl
    w = (p - p1) / jnp.where(p0 != p1, p0 - p1, 1.0)
    return jnp.where(p > p0, 1.0, jnp.where(p < p1, 0.0, w))


def tropo_weight(ctl: Ctl, clim: Clim, time, lat, p, pt=None):
    """Troposphere blending weight around the climatological tropopause
    (reference tropo_weight, c:12424).  Pass ``pt`` to reuse an
    already-computed tropopause pressure (clim_tropo only depends on
    time and latitude, not on the probed pressure)."""
    if pt is None:
        lat_ref = lat if ctl.met_coord_type == 0 else ctl.met_utm_ref_lat
        pt = clim_tropo(clim, time, lat_ref)
    p1 = pt * 0.866877899
    p0 = pt / 0.866877899
    w = (p - p1) / (p0 - p1)
    return jnp.where(p > p0, 1.0, jnp.where(p < p1, 0.0, w))


def module_diff_turb(ctl: Ctl, cache: Cache, clim: Clim, met01: Met,
                     atm: Atm, sfc=None):
    """Langevin random-walk diffusion with well-mixed vertical drift
    correction (reference c:4580-4730)."""
    n = atm.npmax
    rs, ctr = module_rng3(ctl.rng_type, cache.rng_ctr, n,
                          dtype=atm.lon.dtype)
    cache = cache.replace(rng_ctr=ctr)

    dt = cache.dt
    active = (dt != 0.0) & atm.mask

    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    if sfc is not None:
        from mptrac_tpu.ops.fast_interp import interp_sfc_packed
        v2 = interp_sfc_packed(met01, sfc, ("pbl", "ps"), atm.time,
                               loc)
        pbl, ps = v2["pbl"], v2["ps"]
    else:
        pbl = interp.interp_time_2d(met01, "pbl", atm.time, loc)
        ps = interp.interp_time_2d(met01, "ps", atm.time, loc)
    if ctl.turb_pbl_scheme > 0:
        active = active & ~(atm.p >= pbl)
    p_grid = met01.p[0] if met01.p.ndim == 2 else met01.p
    ptop = p_grid[-1]

    lat_ref = (atm.lat if ctl.met_coord_type == 0
               else jnp.full_like(atm.lat, ctl.met_utm_ref_lat))
    pt_clim = clim_tropo(clim, atm.time, lat_ref)

    def kz_at(p):
        wpbl = pbl_weight(ctl, p, pbl, ps)
        wtrop = tropo_weight(ctl, clim, atm.time, atm.lat, p,
                             pt=pt_clim) * (1.0 - wpbl)
        wstrat = 1.0 - wpbl - wtrop
        return (wpbl * ctl.turb_dz_pbl + wtrop * ctl.turb_dz_trop
                + wstrat * ctl.turb_dz_strat), wpbl, wtrop, wstrat

    kz, wpbl, wtrop, wstrat = kz_at(atm.p)
    kx = (wpbl * ctl.turb_dx_pbl + wtrop * ctl.turb_dx_trop
          + wstrat * ctl.turb_dx_strat)
    dt_abs = jnp.abs(dt)

    # Horizontal displacement
    cart = met01.coord_type != 0
    sigma_h = jnp.sqrt(2.0 * jnp.maximum(kx, 0.0) * dt_abs)
    do_h = active & (kx > 0)
    lon = jnp.where(do_h, atm.lon + dx2coord(rs[0] * sigma_h, atm.lat,
                                             cart), atm.lon)
    lat = jnp.where(do_h, atm.lat + dy2coord(rs[1] * sigma_h, cart),
                    atm.lat)

    # Vertical displacement with drift correction (c:4643-4726)
    sigma_z = jnp.sqrt(2.0 * jnp.maximum(kz, 0.0) * dt_abs) * 1e-3
    eps_km = 0.01
    p_up = jnp.clip(atm.p + dz2dp(eps_km, atm.p), ptop, ps)
    p_dn = jnp.clip(atm.p + dz2dp(-eps_km, atm.p), ptop, ps)
    kz_up, _, _, _ = kz_at(p_up)
    kz_dn, _, _, _ = kz_at(p_dn)
    dkz_dz = (kz_up - kz_dn) / (2.0 * eps_km * 1e3)
    w_drift = dkz_dz + kz * (-1.0 / (1e3 * H0))
    dz_tot = rs[2] * sigma_z + w_drift * dt_abs * 1e-3
    ptrial = atm.p + dz2dp(dz_tot, atm.p)
    for _ in range(10):
        ptrial = jnp.where(ptrial > ps, ps * ps / ptrial, ptrial)
        ptrial = jnp.where(ptrial < ptop, ptop * ptop / ptrial, ptrial)
    ptrial = jnp.clip(ptrial, ptop, ps)
    do_v = active & (kz > 0)
    p_new = jnp.where(do_v, ptrial, atm.p)

    return atm.replace(lon=lon, lat=lat, p=p_new), cache


def module_diff_meso(ctl: Ctl, cache: Cache, met01: Met, atm: Atm,
                     pack=None):
    """Mesoscale wind fluctuations: AR(1) colored noise scaled to the
    local subgrid wind variance (reference c:4258-4335).

    The 16-point variance (2x2x2 cells x 2 snapshots) is accumulated in
    float32 in the reference's summation order for cross-checking.
    """
    n = atm.npmax
    rs, ctr = module_rng3(ctl.rng_type, cache.rng_ctr, n,
                          dtype=atm.lon.dtype)
    cache = cache.replace(rng_ctr=ctr)

    dt = cache.dt
    active = (dt != 0.0) & atm.mask

    u3 = met01.fields3d["u"]
    v3 = met01.fields3d["v"]
    w3 = met01.fields3d["w"]
    nx, ny, npl = u3.shape[-3:]

    lons = met01.lon[0] if met01.lon.ndim == 2 else met01.lon
    lats = met01.lat[0] if met01.lat.ndim == 2 else met01.lat
    ps = met01.p[0] if met01.p.ndim == 2 else met01.p
    ix = interp.locate_reg(lons, atm.lon)
    iy = interp.locate_irr(lats, atm.lat)
    iz = interp.locate_irr(ps, atm.p)

    if pack is not None and pack.shape[-1] == 64:
        # The 64-wide corner row already holds all 8 corners x 2
        # snapshots: the whole 16-point stencil is ONE gather offset
        # per parcel (see build_advect_pack64).  Chunked so the
        # gathered rows stay bounded at 100M parcels.
        from mptrac_tpu.ops.fast_interp import map_chunks
        base = (ix * ny + iy) * npl + iz

        def sig_core(base):
            rows = jnp.take(pack, base, axis=0)      # [C, 64] f32
            sigs = []
            for comp in range(3):
                mean = jnp.zeros(base.shape[0], jnp.float32)
                msq = jnp.zeros(base.shape[0], jnp.float32)
                for c in range(8):
                    for lane in (c * 6 + comp, c * 6 + 3 + comp):
                        val = rows[:, lane]
                        mean = mean + val
                        msq = msq + val * val
                var = (msq / jnp.float32(16.0)
                       - (mean / jnp.float32(16.0)) ** 2)
                sigs.append(jnp.where(var > 0, jnp.sqrt(var),
                                      0.0).astype(jnp.float32))
            return jnp.stack(sigs, axis=-1)          # [C, 3]

        sig = map_chunks(sig_core, (base,))
        usig, vsig, wsig = sig[:, 0], sig[:, 1], sig[:, 2]
    elif pack is not None:
        # One wide-row gather serves all three components and both
        # snapshots; the sequential corner/snapshot accumulation order
        # matches the reference's f32 summation (c:4280-4304).
        base = (ix * ny + iy) * npl + iz
        oy, ox = npl, ny * npl
        corners = jnp.stack([
            base, base + 1, base + oy, base + oy + 1,
            base + ox, base + ox + 1, base + ox + oy,
            base + ox + oy + 1], axis=-1)
        rows = jnp.take(pack, corners, axis=0)       # [np, 8, 8] f32

        def sig_from(c0, c1):
            mean = jnp.zeros(n, jnp.float32)
            msq = jnp.zeros(n, jnp.float32)
            for c in range(8):
                for comp in (c0, c1):
                    val = rows[:, c, comp]
                    mean = mean + val
                    msq = msq + val * val
            var = (msq / jnp.float32(16.0)
                   - (mean / jnp.float32(16.0)) ** 2)
            return jnp.where(var > 0, jnp.sqrt(var),
                             0.0).astype(jnp.float32)

        usig = sig_from(0, 3)
        vsig = sig_from(1, 4)
        wsig = sig_from(2, 5)
    else:
        def sig(field):
            flat = field.reshape(2, nx * ny * npl)
            mean = jnp.zeros(n, jnp.float32)
            msq = jnp.zeros(n, jnp.float32)
            for di in (0, 1):
                for dj in (0, 1):
                    for dk in (0, 1):
                        idx = (((ix + di) * ny + (iy + dj)) * npl
                               + (iz + dk))
                        for t in (0, 1):
                            val = jnp.take(flat[t], idx)
                            mean = mean + val
                            msq = msq + val * val
            var = (msq / jnp.float32(16.0)
                   - (mean / jnp.float32(16.0)) ** 2)
            return jnp.where(var > 0, jnp.sqrt(var),
                             0.0).astype(jnp.float32)

        usig = sig(u3)
        vsig = sig(v3)
        wsig = sig(w3)

    r = 1.0 - 2.0 * jnp.abs(dt) / ctl.dt_met
    r2 = jnp.sqrt(1.0 - r * r)

    cart = met01.coord_type != 0
    uvwp = cache.uvwp
    lon, lat, p = atm.lon, atm.lat, atm.p
    if ctl.turb_mesox > 0:
        u_new = (r * uvwp[0] + r2 * rs[0] * ctl.turb_mesox
                 * usig).astype(jnp.float32)
        v_new = (r * uvwp[1] + r2 * rs[1] * ctl.turb_mesox
                 * vsig).astype(jnp.float32)
        u_new = jnp.where(active, u_new, uvwp[0])
        v_new = jnp.where(active, v_new, uvwp[1])
        lon = jnp.where(active,
                        lon + dx2coord(u_new.astype(lon.dtype) * dt,
                                       atm.lat, cart), lon)
        lat = jnp.where(active,
                        lat + dy2coord(v_new.astype(lat.dtype) * dt, cart),
                        lat)
    else:
        u_new, v_new = uvwp[0], uvwp[1]
    if ctl.turb_mesoz > 0:
        w_new = (r * uvwp[2] + r2 * rs[2] * ctl.turb_mesoz
                 * wsig).astype(jnp.float32)
        w_new = jnp.where(active, w_new, uvwp[2])
        p = jnp.where(active, p + w_new.astype(p.dtype) * dt, p)
    else:
        w_new = uvwp[2]

    cache = cache.replace(uvwp=jnp.stack([u_new, v_new, w_new]))
    return atm.replace(lon=lon, lat=lat, p=p), cache
