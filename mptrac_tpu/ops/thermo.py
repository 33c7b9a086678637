"""Thermodynamic and coordinate helper functions.

Vectorized jnp equivalents of the MPTRAC reference macros
(/root/reference/src/mptrac.h:600-2100).  All functions are pure,
shape-polymorphic, and dtype-preserving, so they trace cleanly under
``jax.jit``/``vmap`` and fuse into surrounding element-wise work.

Units follow the reference: pressure [hPa], altitude [km],
temperature [K], mixing ratios [ppv].
"""

import jax.numpy as jnp

from mptrac_tpu.constants import (
    EPS, G0, H0, MA, P0, RA, RE, RI, T0, DEG2RAD_F, RAD2DEG_F,
)


# --- Coordinates (reference mptrac.h:609-780) ---

def deg2dx(dlon, lat):
    """Longitude difference [deg] -> east-west distance [km] (h:609)."""
    return RE * deg2rad(dlon) * jnp.cos(deg2rad(lat))


def deg2dy(dlat):
    """Latitude difference [deg] -> north-south distance [km] (h:630)."""
    return RE * deg2rad(dlat)


def deg2rad(deg):
    return deg * DEG2RAD_F


def rad2deg(rad):
    return rad * RAD2DEG_F


def dp2dz(dp, p):
    """Pressure difference [hPa] -> height difference [km] (h:672)."""
    return -dp * H0 / p


def dz2dp(dz, p):
    """Height difference [km] -> pressure difference [hPa] (h:731)."""
    return -dz * p / H0


def dx2deg(dx, lat):
    """East-west distance [km] -> longitude difference [deg] (h:694).

    Returns 0 within 0.001 deg of the poles to avoid the singularity,
    matching the reference guard.
    """
    near_pole = (lat < -89.999) | (lat > 89.999)
    denom = jnp.pi * RE * jnp.cos(deg2rad(jnp.where(near_pole, 0.0, lat)))
    return jnp.where(near_pole, 0.0, dx * 180.0 / denom)


def dy2deg(dy):
    """North-south distance [km] -> latitude difference [deg] (h:712)."""
    return dy * 180.0 / (jnp.pi * RE)


def dx2coord(dx_m, lat, cartesian: bool):
    """Distance [m] -> zonal coordinate displacement (h:756).

    Degrees longitude for lat/lon grids, meters for Cartesian/UTM grids.
    ``cartesian`` is static (resolved at trace time).
    """
    if cartesian:
        return dx_m
    return dx2deg(dx_m / 1000.0, lat)


def dy2coord(dy_m, cartesian: bool):
    """Distance [m] -> meridional coordinate displacement (h:779)."""
    if cartesian:
        return dy_m
    return dy2deg(dy_m / 1000.0)


def fmod(x, y):
    """C-style truncation fmod: x - trunc(x/y)*y (h:911)."""
    return x - jnp.trunc(x / y) * y


def lin(x0, y0, x1, y1, x):
    """Linear interpolation through (x0,y0),(x1,y1) (h:1141)."""
    return y0 + (y1 - y0) / (x1 - x0) * (x - x0)


def nn(x0, y0, x1, y1, x):
    """Nearest-neighbour of the two points (h:1517)."""
    return jnp.where(jnp.abs(x - x0) <= jnp.abs(x - x1), y0, y1)


# --- Vertical coordinate (reference mptrac.h:1574, 2033) ---

def pressure(z):
    """Altitude [km] -> pressure [hPa], barometric (h:1574)."""
    return P0 * jnp.exp(-jnp.asarray(z, dtype=jnp.result_type(z, 1.0)) / H0)


def altitude(p):
    """Pressure [hPa] -> altitude [km], barometric (h:2033)."""
    return H0 * jnp.log(P0 / p)


# --- Moist thermodynamics (reference mptrac.h:1598-1989) ---

def psat(t):
    """Saturation pressure over water [hPa], WMO 2018 (h:1598)."""
    return 6.112 * jnp.exp(17.62 * (t - T0) / (243.12 + t - T0))


def psice(t):
    """Saturation pressure over ice [hPa], WMO 2018 (h:1622)."""
    return 6.112 * jnp.exp(22.46 * (t - T0) / (272.62 + t - T0))


def pw(p, h2o):
    """Partial water vapor pressure [hPa] (h:1649)."""
    h = jnp.maximum(h2o, 0.1e-6)
    return p * h / (1.0 + (1.0 - EPS) * h)


def rh(p, t, h2o):
    """Relative humidity over water [%] (h:1696)."""
    return pw(p, h2o) / psat(t) * 100.0


def rhice(p, t, h2o):
    """Relative humidity over ice [%] (h:1726)."""
    return pw(p, h2o) / psice(t) * 100.0


def rho(p, t):
    """Air density [kg/m^3] (h:1751)."""
    return 100.0 * p / (RA * t)


def sh(h2o):
    """Volume mixing ratio [ppv] -> specific humidity [kg/kg] (h:1814)."""
    return EPS * jnp.maximum(h2o, 0.1e-6)


def tdew(p, h2o):
    """Dew point temperature [K] (h:1865)."""
    lg = jnp.log(pw(p, h2o) / 6.112)
    return T0 + 243.12 * lg / (17.62 - lg)


def tice(p, h2o):
    """Frost point temperature [K] (h:1890)."""
    lg = jnp.log(pw(p, h2o) / 6.112)
    return T0 + 272.62 * lg / (22.46 - lg)


def theta(p, t):
    """Potential temperature [K] (h:1914)."""
    return t * (1000.0 / p) ** 0.286


def zeta(ps, p, t):
    """Hybrid zeta coordinate [K] (h:2083): potential temperature
    tapered by a sine ramp below sigma = 0.3."""
    sig = p / ps
    ramp = jnp.where(sig <= 0.3, 1.0,
                     jnp.sin(jnp.pi / 2.0 * (1.0 - sig) / (1.0 - 0.3)))
    return ramp * theta(p, t)


def tvirt(t, h2o):
    """Virtual temperature [K] (h:1989)."""
    return t * (1.0 + (1.0 - EPS) * jnp.maximum(h2o, 0.1e-6))


def theta_virt(p, t, h2o):
    """Virtual potential temperature [K] (h:1943)."""
    return tvirt(theta(p, t), jnp.maximum(h2o, 0.1e-6))


def lapse(p1, t1, p2, t2):
    """Temperature lapse rate between two levels [K/km] (h:1122)."""
    return (1e3 * G0 / RA * (t2 - t1) / (t2 + t1)
            * (p2 + p1) / (p2 - p1))


def zdiff(lnp0, t0, h2o0, lnp1, t1, h2o1):
    """Hypsometric geopotential height difference [km] (h:2064)."""
    return (RI / MA / G0 * 0.5 * (tvirt(t0, h2o0) + tvirt(t1, h2o1))
            * (lnp0 - lnp1))


def molec_dens(p, t):
    """Molecular density of air [molec/cm^3] (reference mptrac.h MOLEC_DENS)."""
    return 7.243e21 * p / t


def nat_temperature(p, h2o, hno3):
    """NAT existence temperature [K] (reference mptrac.c:8010-8032).

    Hanson & Mauersberger (1988) equilibrium for nitric acid trihydrate.
    p [hPa], h2o/hno3 [ppv].
    """
    h2o_help = jnp.maximum(h2o, 0.1e-6)
    p_hno3 = hno3 * p / 1.333224
    p_h2o = h2o_help * p / 1.333224
    a = 0.009179 - 0.00088 * jnp.log10(p_h2o)
    b = (38.9855 - jnp.log10(p_hno3) - 2.7836 * jnp.log10(p_h2o)) / a
    c = -11397.0 / a
    disc = jnp.sqrt(b * b - 4.0 * c)
    x1 = (-b + disc) / 2.0
    x2 = (-b - disc) / 2.0
    return jnp.where(x2 > 0, x2, x1)


def sedi_velocity(p, t, rp, rhop):
    """Stokes sedimentation velocity with slip correction [m/s].

    Mirrors the behaviour of the reference ``sedi`` (mptrac.c:12182-12215):
    p [hPa], t [K], particle radius rp [microns], density rhop [kg/m^3].
    """
    # Particle radius/density in SI units
    rp_m = rp * 1e-6
    # Density of air [kg/m^3]
    rho_air = rho(p, t)
    # Dynamic viscosity of air [kg/(m s)] (Sutherland)
    eta = 1.8325e-5 * (416.16 / (t + 120.0)) * (t / 296.16) ** 1.5
    # Thermal velocity of molecules [m/s]
    v = jnp.sqrt(8.0 * jnp.asarray(1.3806504e-23) * t
                 / (jnp.pi * 4.8096e-26))
    # Mean free path [m]
    lam = 2.0 * eta / (rho_air * v)
    # Knudsen number
    kn = lam / rp_m
    # Cunningham slip-flow correction
    gamma = 1.0 + kn * (1.249 + 0.42 * jnp.exp(-0.87 / kn))
    # Stokes terminal velocity
    return 2.0 * rp_m * rp_m * (rhop - rho_air) * G0 / (9.0 * eta) * gamma
