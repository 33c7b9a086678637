"""Climatological data: built-in tropopause table, zonal means,
photolysis rates, time series.

Reference: clim_tropo/clim_tropo_init (/root/reference/src/mptrac.c:213-396),
clim_zm c:407, clim_ts c:396, clim_oh c:89, clim_photo c:156,
mptrac_read_clim c:6406, read_clim_photo c:8250, read_clim_zm c:8423,
read_clim_ts c:8369.

The zonal-mean NCEP/NCAR tropopause climatology ships as a data asset
(mptrac_tpu/data/clim_tropo.npz, extracted from the reference table).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mptrac_tpu.config import Ctl
from mptrac_tpu.ops.interp import locate_irr, locate_reg
from mptrac_tpu.types import Clim, ClimTs, ClimZm

_DATA = os.path.join(os.path.dirname(__file__), "data")

_YEAR_S = 365.25 * 86400.0


def load_clim_tropo():
    d = np.load(os.path.join(_DATA, "clim_tropo.npz"))
    return d["time"], d["lat"], d["tropo"]


def read_clim(ctl: Ctl) -> Clim:
    """Load climatological data per control parameters (reference
    mptrac_read_clim, c:6406).  Photolysis/zonal-mean/time-series files
    are loaded only when the corresponding modules are enabled."""
    t, lat, tropo = load_clim_tropo()
    zm = {}
    ts = {}
    photo = {}
    photo_p = photo_sza = photo_o3c = jnp.zeros(1)

    if ctl.tracer_chem or ctl.kpp_chem:
        ph = read_clim_photo(ctl.clim_photo)
        if ph is not None:
            photo_p, photo_sza, photo_o3c, photo = ph
    if ctl.oh_chem_reaction != 0:
        z = read_clim_zm(ctl.clim_oh_filename, "OH")
        if z is not None:
            zm["oh"] = _oh_diurnal_correction(z)
    if ctl.h2o2_chem_reaction != 0:
        z = read_clim_zm(ctl.clim_h2o2_filename, "H2O2")
        if z is not None:
            zm["h2o2"] = z
    if ctl.tracer_chem:
        z = read_clim_zm(ctl.clim_o1d_filename, "O1D")
        if z is not None:
            zm["o1d"] = z
    psc = read_clim_zm(ctl.clim_hno3_filename, "HNO3")
    if psc is not None and any(q in ctl.qnt_name
                               for q in ("tnat", "tsts", "hno3")):
        zm["hno3"] = psc
    for key, fname in (("ccl4", ctl.clim_ccl4_timeseries),
                       ("ccl3f", ctl.clim_ccl3f_timeseries),
                       ("ccl2f2", ctl.clim_ccl2f2_timeseries),
                       ("n2o", ctl.clim_n2o_timeseries),
                       ("sf6", ctl.clim_sf6_timeseries)):
        if fname and fname != "-" and os.path.exists(fname):
            ts[key] = read_clim_ts(fname)

    return Clim(
        tropo_time=jnp.asarray(t), tropo_lat=jnp.asarray(lat),
        tropo=jnp.asarray(tropo),
        photo_p=jnp.asarray(photo_p), photo_sza=jnp.asarray(photo_sza),
        photo_o3c=jnp.asarray(photo_o3c),
        photo={k: jnp.asarray(v) for k, v in photo.items()},
        zm=zm, ts=ts)


def read_clim_photo(filename: str):
    """Photolysis rate table (reference read_clim_photo, c:8250)."""
    from scipy.io import netcdf_file
    if not os.path.exists(filename):
        return None
    nc = netcdf_file(filename, mmap=False)
    try:
        v = nc.variables
        p = np.array(v["press"][:], np.float64)
        sza = np.array(v["sza"][:], np.float64)
        o3c = np.array(v["total_o3col"][:], np.float64)
        rates = {}
        for name, var in (("ccl4", "J_CCl4"), ("ccl3f", "J_CFC-11"),
                          ("ccl2f2", "J_CFC-12"), ("n2o", "J_N2O"),
                          ("o2", "J_O2"), ("o3_1", "J_O3b"),
                          ("o3_2", "J_O3a"), ("h2o2", "J_H2O2"),
                          ("h2o", "J_H2O")):
            if var in v:
                rates[name] = np.array(v[var][:], np.float64)
        return p, sza, o3c, rates
    finally:
        nc.close()


#: fixed monthly-mean time grid [s since year start]
#: (reference read_clim_zm, c:8455-8467 — same midpoints as the
#: tropopause table)
ZM_TIME = np.array([
    1209600.00, 3888000.00, 6393600.00, 9072000.00, 11664000.00,
    14342400.00, 16934400.00, 19612800.00, 22291200.00, 24883200.00,
    27561600.00, 30153600.00])


def read_clim_zm(filename: str, varname: str) -> Optional[ClimZm]:
    """Zonal-mean monthly climatology (reference read_clim_zm, c:8423):
    fixed monthly time grid, descending pressure, ascending latitude;
    negative values (data gaps) filled from the nearest valid level."""
    from mptrac_tpu.io.hdf5 import open_netcdf_any
    if not filename or filename == "-" or not os.path.exists(filename):
        return None
    v, nc = open_netcdf_any(filename)
    try:
        lat = np.array(v["lat"][:], np.float64)
        p = np.array(v["press"][:], np.float64)
        if p[0] < p[1]:
            raise ValueError("Pressure data are not descending!")
        if lat[0] > lat[1]:
            raise ValueError("Latitude data are not ascending!")
        vmr = np.array(v[varname][:], np.float64)     # [ntime, np, nlat]
        # Fill data gaps per (time, lat) column from valid levels
        bad = vmr < 0
        if bad.any():
            npl = p.size
            first_valid = np.argmax(~bad, axis=1)           # [nt, nlat]
            filled = np.take_along_axis(
                vmr, first_valid[:, None, :], axis=1)
            vmr = np.where(bad, np.broadcast_to(filled, vmr.shape), vmr)
        vmr = vmr.transpose(0, 2, 1)                  # -> [ntime, nlat, np]
        return ClimZm(time=jnp.asarray(ZM_TIME), lat=jnp.asarray(lat),
                      p=jnp.asarray(p), vmr=jnp.asarray(vmr))
    finally:
        if hasattr(nc, "close"):
            nc.close()


def read_clim_ts(filename: str) -> ClimTs:
    """Time series of yearly mean vmr from an ASCII file
    (reference read_clim_ts, c:8369): rows of ``year vmr``."""
    from mptrac_tpu.timeutil import time2jsec
    times, vmrs = [], []
    with open(filename) as f:
        for line in f:
            toks = line.split()
            if len(toks) >= 2:
                try:
                    year = float(toks[0])
                    vmr = float(toks[1])
                except ValueError:
                    continue
                jsec = (year - 2000.0) * _YEAR_S
                times.append(jsec)
                vmrs.append(vmr)
    return ClimTs(time=jnp.asarray(times), vmr=jnp.asarray(vmrs))


def _oh_diurnal_correction(z: ClimZm) -> ClimZm:
    """Placeholder: the reference normalizes OH by the diurnal SZA
    correction factor (clim_oh_diurnal_correction, c:124-156); applied
    in the OH chemistry module instead here."""
    return z


# --- Lookup functions (jit-compatible) ---

def clim_tropo(clim: Clim, t, lat):
    """Climatological tropopause pressure [hPa] (reference clim_tropo,
    c:213)."""
    from mptrac_tpu.ops.interp import take_small
    sec = t - jnp.floor(t / _YEAR_S) * _YEAR_S
    sec = jnp.where(sec < 0, sec + _YEAR_S, sec)
    shape = jnp.broadcast_shapes(jnp.shape(sec), jnp.shape(lat))
    lat = jnp.broadcast_to(jnp.asarray(lat), shape)
    sec = jnp.broadcast_to(jnp.asarray(sec), shape)

    def core(sec, lat):
        isec = locate_irr(clim.tropo_time, sec)
        ilat = locate_reg(clim.tropo_lat, lat)
        la0 = take_small(clim.tropo_lat, ilat)
        la1 = take_small(clim.tropo_lat, ilat + 1)
        wlat = (lat - la0) / (la1 - la0)
        # Gather-free corner lookups.  Separable one-hot selection:
        # the month axis rides a [C, 12] @ [12, 73] matmul, the lat
        # axis a fused masked reduce over the resulting row.  The
        # matmul is exact (one nonzero per row) only at full f32
        # precision: HIGHEST keeps a GPU from running it in TF32.
        # Chunked: the [C, 73] intermediates would be tens of GB at
        # 100M parcels.
        nt, nl = clim.tropo.shape
        jt = jnp.arange(nt, dtype=jnp.int32)
        jl = jnp.arange(nl, dtype=jnp.int32)
        tdt = clim.tropo.dtype
        oh_t0 = (isec[..., None] == jt).astype(tdt)     # [C, nt]
        oh_t1 = (isec[..., None] == jt - 1).astype(tdt)
        r0 = jnp.matmul(oh_t0, clim.tropo,
                        precision=jax.lax.Precision.HIGHEST)  # [C, nl]
        r1 = jnp.matmul(oh_t1, clim.tropo,
                        precision=jax.lax.Precision.HIGHEST)
        ml0 = ilat[..., None] == jl                     # [C, nl]
        ml1 = ilat[..., None] == jl - 1
        p00 = jnp.sum(jnp.where(ml0, r0, 0), axis=-1)
        p01 = jnp.sum(jnp.where(ml1, r0, 0), axis=-1)
        p10 = jnp.sum(jnp.where(ml0, r1, 0), axis=-1)
        p11 = jnp.sum(jnp.where(ml1, r1, 0), axis=-1)
        p0 = p00 + wlat * (p01 - p00)
        p1 = p10 + wlat * (p11 - p10)
        t0 = take_small(clim.tropo_time, isec)
        t1 = take_small(clim.tropo_time, isec + 1)
        return p0 + (p1 - p0) / (t1 - t0) * (sec - t0)

    if lat.ndim == 1:
        from mptrac_tpu.ops.fast_interp import map_chunks
        out = map_chunks(core, (sec, lat))
    else:
        out = core(sec, lat)
    # fp32 mode: follow the caller's latitude dtype (f64 is a no-op)
    return out.astype(lat.dtype)


def clim_tropo_np(clim, t, lat):
    """Host-side scalar/vector version for met preprocessing."""
    import numpy as np
    tt, la, tr = load_clim_tropo()
    sec = t - np.floor(t / _YEAR_S) * _YEAR_S
    if sec < 0:
        sec += _YEAR_S
    isec = np.clip(np.searchsorted(tt, sec, side="right") - 1, 0, 10)
    ilat = np.clip(((lat - la[0]) / (la[1] - la[0])).astype(int)
                   if np.ndim(lat) else int((lat - la[0]) / (la[1] - la[0])),
                   0, 71)
    wlat = (lat - la[ilat]) / (la[ilat + 1] - la[ilat])
    p0 = tr[isec, ilat] * (1 - wlat) + tr[isec, ilat + 1] * wlat
    p1 = tr[isec + 1, ilat] * (1 - wlat) + tr[isec + 1, ilat + 1] * wlat
    w = (sec - tt[isec]) / (tt[isec + 1] - tt[isec])
    return p0 * (1 - w) + p1 * w


def clim_zm(zm: ClimZm, t, lat, p):
    """Zonal-mean climatology lookup (reference clim_zm, c:414-464):
    lat/p are clamped to the table range; the seasonal time axis is NOT
    clamped — the reference linearly extrapolates beyond the monthly
    midpoints."""
    sec = t - jnp.floor(t / _YEAR_S) * _YEAR_S
    sec = jnp.where(sec < 0, sec + _YEAR_S, sec)
    lat_c = jnp.clip(lat, zm.lat[0], zm.lat[-1])
    p_c = jnp.clip(p, jnp.minimum(zm.p[0], zm.p[-1]),
                   jnp.maximum(zm.p[0], zm.p[-1]))
    isec = locate_irr(zm.time, sec)
    ilat = locate_reg(zm.lat, lat_c)
    ip = locate_irr(zm.p, p_c)

    def lin(x0, y0, x1, y1, x):
        return y0 + (y1 - y0) / (x1 - x0) * (x - x0)

    aux = []
    for ds in (0, 1):
        for dl in (0, 1):
            aux.append(lin(zm.p[ip], zm.vmr[isec + ds, ilat + dl, ip],
                           zm.p[ip + 1], zm.vmr[isec + ds, ilat + dl, ip + 1],
                           p_c))
    a00 = lin(zm.lat[ilat], aux[0], zm.lat[ilat + 1], aux[1], lat_c)
    a10 = lin(zm.lat[ilat], aux[2], zm.lat[ilat + 1], aux[3], lat_c)
    out = lin(zm.time[isec], a00, zm.time[isec + 1], a10, sec)
    return jnp.maximum(out, 0.0).astype(jnp.asarray(lat).dtype)


def clim_ts(ts: ClimTs, t):
    """Interpolate a climatological time series (reference clim_ts,
    c:396): clamped linear interpolation in time."""
    tc = jnp.clip(t, ts.time[0], ts.time[-1])
    i = locate_irr(ts.time, tc)
    return (ts.vmr[i] + (ts.vmr[i + 1] - ts.vmr[i])
            / (ts.time[i + 1] - ts.time[i]) * (tc - ts.time[i]))
