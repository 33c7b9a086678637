"""Meteo sampling to particle attributes (reference module_meteo,
/root/reference/src/mptrac.c:5054-5161): interpolates met and derived
quantities onto each parcel for every registered quantity.

Runs for ALL parcels regardless of dt (PARTICLE_LOOP check_dt=0)."""

from __future__ import annotations

import jax.numpy as jnp

from mptrac_tpu import climatology as cl
from mptrac_tpu.config import Ctl
from mptrac_tpu.constants import H0
from mptrac_tpu.ops import interp, thermo
from mptrac_tpu.types import Atm, Cache, Clim, Met

#: quantity name -> stacked 2-D met field (straight samplings)
_Q2D = {"ps": "ps", "ts": "ts", "zs": "zs", "us": "us", "vs": "vs",
        "ess": "ess", "nss": "nss", "shf": "shf", "lsm": "lsm",
        "sst": "sst", "pbl": "pbl", "pt": "pt", "tt": "tt", "zt": "zt",
        "h2ot": "h2ot", "pct": "pct", "pcb": "pcb", "cl": "cl",
        "plcl": "plcl", "plfc": "plfc", "pel": "pel", "cape": "cape",
        "cin": "cin", "o3c": "o3c"}

#: quantity name -> stacked 3-D met field
_Q3D = {"zg": "z", "t": "t", "u": "u", "v": "v", "w": "w", "pv": "pv",
        "h2o": "h2o", "o3": "o3", "lwc": "lwc", "rwc": "rwc",
        "iwc": "iwc", "swc": "swc", "cc": "cc"}


def module_meteo(ctl: Ctl, cache: Cache, clim: Clim, met01: Met,
                 atm: Atm, pack=None) -> Atm:
    """``pack`` optionally supplies the packed gather tables
    (ops.fast_interp.MetPack) for temperature and surface fields."""
    names = set(ctl.qnt_name)
    if not names:
        return atm
    q = dict(atm.q)

    from mptrac_tpu.ops.fast_interp import (MetPack, SFC_FIELDS,
                                            interp_sfc_packed,
                                            interp_t_packed64)
    if pack is not None and not isinstance(pack, MetPack):
        pack = MetPack(w64=pack, sfc=None)
    w64 = (pack.w64 if pack is not None
           and pack.w64 is not None and pack.w64.shape[-1] == 64
           else None)
    sfc = pack.sfc if pack is not None else None

    # The locate is shared by every interpolation below; skip it
    # entirely when the quantity list leaves nothing to gather.
    _loc = [None]

    def loc():
        if _loc[0] is None:
            _loc[0] = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
        return _loc[0]

    deriv3 = {"rho", "vh", "vz", "psat", "psice", "pw", "sh", "rh",
              "rhice", "theta", "tvirt", "lapse", "tdew", "tice",
              "tnat", "tsts", "zeta_d"}

    vals3 = {}
    for qname, fname in _Q3D.items():
        if qname in names or (qname in ("t", "u", "v", "w", "h2o")
                              and names & deriv3):
            if fname == "t" and w64 is not None:
                vals3[fname] = interp_t_packed64(met01, w64, atm.time,
                                                 loc())
            else:
                vals3[fname] = interp.interp_time_3d(met01, fname,
                                                     atm.time, loc())
    sfc_names = [f for q2, f in _Q2D.items()
                 if q2 in names and f in SFC_FIELDS]
    if sfc is not None and sfc_names:
        sfc_vals = interp_sfc_packed(met01, sfc, sfc_names, atm.time,
                                     loc())
    else:
        sfc_vals = {}
    for qname, fname in _Q2D.items():
        if qname in names:
            if fname in sfc_vals:
                q[qname] = sfc_vals[fname]
            else:
                q[qname] = interp.interp_time_2d(met01, fname,
                                                 atm.time, loc())
    for qname, fname in _Q3D.items():
        if qname in names:
            q[qname] = vals3[fname]

    t = vals3.get("t")
    h2o = vals3.get("h2o")
    u = vals3.get("u")
    v = vals3.get("v")
    w = vals3.get("w")
    p = atm.p

    if "p" in names:
        q["p"] = p
    if "rho" in names:
        q["rho"] = thermo.rho(p, t)
    if "vh" in names:
        q["vh"] = jnp.sqrt(u * u + v * v)
    if "vz" in names:
        q["vz"] = -1e3 * H0 / p * w
    if "psat" in names:
        q["psat"] = thermo.psat(t)
    if "psice" in names:
        q["psice"] = thermo.psice(t)
    if "pw" in names:
        q["pw"] = thermo.pw(p, h2o)
    if "sh" in names:
        q["sh"] = thermo.sh(h2o)
    if "rh" in names:
        q["rh"] = thermo.rh(p, t, h2o)
    if "rhice" in names:
        q["rhice"] = thermo.rhice(p, t, h2o)
    if "theta" in names:
        q["theta"] = thermo.theta(p, t)
    if "tvirt" in names:
        q["tvirt"] = thermo.tvirt(t, h2o)
    if "lapse" in names:
        q["lapse"] = _lapse_rate(t, h2o)
    if "zeta_d" in names:
        ps_v = q.get("ps")
        if ps_v is None:
            ps_v = (sfc_vals["ps"] if "ps" in sfc_vals
                    else interp.interp_time_2d(met01, "ps", atm.time,
                                               loc()))
        q["zeta_d"] = thermo.zeta(ps_v, p, t)
    if "tdew" in names:
        q["tdew"] = thermo.tdew(p, h2o)
    if "tice" in names:
        q["tice"] = thermo.tice(p, h2o)

    lat_ref = (atm.lat if ctl.met_coord_type == 0
               else jnp.full_like(atm.lat, ctl.met_utm_ref_lat))
    if "hno3" in names and "hno3" in clim.zm:
        q["hno3"] = cl.clim_zm(clim.zm["hno3"], atm.time, lat_ref, p)
    if "oh" in names and "oh" in clim.zm:
        from mptrac_tpu.physics.chem import clim_oh
        q["oh"] = clim_oh(ctl, clim, atm.time, atm.lon, atm.lat, p)
    if "h2o2" in names and "h2o2" in clim.zm:
        q["h2o2"] = cl.clim_zm(clim.zm["h2o2"], atm.time, lat_ref, p)
    if "ho2" in names and "ho2" in clim.zm:
        q["ho2"] = cl.clim_zm(clim.zm["ho2"], atm.time, lat_ref, p)
    if "o1d" in names and "o1d" in clim.zm:
        q["o1d"] = cl.clim_zm(clim.zm["o1d"], atm.time, lat_ref, p)
    if "tnat" in names and "hno3" in clim.zm:
        q["tnat"] = thermo.nat_temperature(
            p, h2o, cl.clim_zm(clim.zm["hno3"], atm.time, atm.lat, p))
    if "tsts" in names:
        q["tsts"] = 0.5 * (q["tice"] + q["tnat"])

    return atm.replace(q=q)


def _lapse_rate(t, h2o):
    """Moist adiabatic lapse rate [K/km] (reference lapse_rate,
    c:12332)."""
    from mptrac_tpu.constants import CPD, EPS, G0, LV, RA
    a = RA * t * t
    r = thermo.sh(h2o) / (1.0 - thermo.sh(h2o))
    return 1e3 * G0 * (a + LV * r * t) / (CPD * a + LV * LV * r * EPS)
