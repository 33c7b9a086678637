"""4-D meteo interpolation core — the hot inner loop.

Vectorized rebuild of the reference interpolation stack
(/root/reference/src/mptrac.c): ``locate_reg`` c:3559, ``locate_irr``
c:3495, ``intpol_check_lon_lat`` c:2755, ``intpol_check_cartesian``
c:2783, ``intpol_met_space_3d`` c:2985, ``intpol_met_space_2d`` c:3048,
``intpol_met_time_3d`` c:3112, ``intpol_met_time_2d`` c:3141,
``intpol_met_4d_zeta`` c:2808.

Instead of a per-parcel scalar loop with cached indices (the reference
``ci``/``cw`` arrays), every function operates on whole parcel batches:
one ``Locator`` holds the per-parcel cell indices and weights, computed
once and reused across fields, exactly mirroring the reference
``INTPOL_INIT`` / ``init=0`` reuse pattern.

Weight convention matches the reference: ``w`` is the weight of the
*lower* index, ``val = w * (a[lo] - a[hi]) + a[hi]``.

Fields are float32; interpolation arithmetic is performed in the
position dtype (float64 by default), as in the reference (double math
over float fields).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

from mptrac_tpu.ops.thermo import fmod
from mptrac_tpu.types import Met


def locate_reg(xx: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Cell index on a regular axis (reference locate_reg, c:3559).

    Truncates (x - xx[0]) / dx toward zero and clips to [0, n-2];
    identical to the reference for all inputs after clipping.
    """
    n = xx.shape[0]
    i = jnp.floor((x - xx[0]) / (xx[1] - xx[0])).astype(jnp.int32)
    return jnp.clip(i, 0, n - 2)


def locate_irr(xx: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Cell index on an irregular (ascending or descending) axis
    (reference locate_irr, c:3495).  Returns ilo in [0, n-2] with
    xx[ilo] <= x < xx[ilo+1] for ascending axes (mirrored for
    descending), clamped at the ends.

    Implemented as a broadcast compare-and-count instead of
    ``jnp.searchsorted``, which lowers to a ``while`` loop: the
    compare-sum fuses into one elementwise pass over the short axis
    (met vertical/lat axes are <=1444 entries).
    """
    n = xx.shape[0]
    asc = xx[1] > xx[0]
    xq = x[..., None]
    # Ascending: (# of xx <= x) - 1 == searchsorted(xx, x, 'right') - 1.
    # Descending: (# of xx > x) - 1 == searchsorted(-xx, -x, 'left') - 1.
    cnt_le = jnp.sum(xx <= xq, axis=-1).astype(jnp.int32)
    cnt_gt = jnp.sum(xx > xq, axis=-1).astype(jnp.int32)
    i = jnp.where(asc, cnt_le, cnt_gt) - 1
    return jnp.clip(i, 0, n - 2).astype(jnp.int32)


def take_small(xx: jnp.ndarray, i: jnp.ndarray) -> jnp.ndarray:
    """Gather-free lookup ``xx[i]`` for a short axis table: a masked
    one-hot reduce over the short axis, which fuses into the
    surrounding elementwise pass instead of issuing one gather per
    parcel."""
    n = xx.shape[0]
    j = jnp.arange(n, dtype=jnp.int32)
    return jnp.sum(jnp.where(i[..., None] == j, xx, 0), axis=-1)


def check_lon_lat(lons, lats, lon, lat):
    """Wrap longitude into the grid span and clamp latitude
    (reference intpol_check_lon_lat, c:2755)."""
    lon2 = fmod(lon, 360.0)
    lon2 = jnp.where(lon2 < lons[0], lon2 + 360.0, lon2)
    lon2 = jnp.where(lon2 > lons[-1], lon2 - 360.0, lon2)
    lo = jnp.minimum(lats[0], lats[-1])
    hi = jnp.maximum(lats[0], lats[-1])
    lat2 = jnp.clip(lat, lo, hi)
    return lon2, lat2


def check_cartesian(lons, lats, lon, lat):
    """Clamp Cartesian coordinates into the grid box
    (reference intpol_check_cartesian, c:2783)."""
    xlo = jnp.minimum(lons[0], lons[-1])
    xhi = jnp.maximum(lons[0], lons[-1])
    ylo = jnp.minimum(lats[0], lats[-1])
    yhi = jnp.maximum(lats[0], lats[-1])
    return jnp.clip(lon, xlo, xhi), jnp.clip(lat, ylo, yhi)


@dataclass
class Locator:
    """Per-parcel interpolation state (reference ci/cw arrays,
    mptrac.h:964 INTPOL_INIT).  All members are [np]-shaped."""
    ix: jnp.ndarray
    iy: jnp.ndarray
    iz: jnp.ndarray
    wx: jnp.ndarray   # weight of the lower lon index
    wy: jnp.ndarray   # weight of the lower lat index
    wz: jnp.ndarray   # weight of the lower level index


jax.tree_util.register_dataclass(
    Locator, data_fields=["ix", "iy", "iz", "wx", "wy", "wz"],
    meta_fields=[])


def locate_3d(met: Met, lon, lat, p) -> Locator:
    """Compute cell indices + weights for 3-D pressure-level
    interpolation (reference intpol_met_space_3d init branch, c:2995).

    ``met`` may be a single snapshot or a stacked [2,...] pair; the
    grid axes of the first snapshot are used (grids must match, as the
    reference asserts in mptrac_get_met, c:6288).
    """
    lons, lats, ps = _grid_axes(met)
    if met.coord_type == 0:
        lon2, lat2 = check_lon_lat(lons, lats, lon, lat)
    else:
        lon2, lat2 = check_cartesian(lons, lats, lon, lat)
    iz = locate_irr(ps, p)
    ix = locate_reg(lons, lon2)
    iy = locate_irr(lats, lat2)
    p0, p1 = take_small(ps, iz), take_small(ps, iz + 1)
    x0, x1 = _axis_vals(lons, ix, getattr(met, "reg_lon", False))
    y0, y1 = _axis_vals(lats, iy, getattr(met, "reg_lat", False))
    wz = (p1 - p) / (p1 - p0)
    wx = (x1 - lon2) / (x1 - x0)
    wy = (y1 - lat2) / (y1 - y0)
    return Locator(ix=ix, iy=iy, iz=iz, wx=wx, wy=wy, wz=wz)


def _axis_vals(xx, i, regular: bool):
    """(xx[i], xx[i+1]) — arithmetic when the axis is statically known
    to be exactly arithmetic (bit-identical to the lookup), else a
    gather-free masked reduce."""
    if regular:
        d = xx[1] - xx[0]
        v0 = xx[0] + i * d
        return v0, v0 + d
    return take_small(xx, i), take_small(xx, i + 1)


def _grid_axes(met: Met):
    """Grid axes of a snapshot or a stacked pair."""
    if met.lon.ndim == 2:  # stacked pair
        return met.lon[0], met.lat[0], met.p[0]
    return met.lon, met.lat, met.p


def _gather3(field: jnp.ndarray, ix, iy, iz) -> jnp.ndarray:
    """Gather field[ix, iy, iz] for per-parcel index vectors.

    ``field`` has shape [..., nx, ny, npl]; leading axes broadcast
    (e.g. the stacked time axis).  Flattened single-gather form: XLA
    lowers this to one gather op per call.
    """
    nx, ny, npl = field.shape[-3:]
    flat = field.reshape(field.shape[:-3] + (nx * ny * npl,))
    idx = (ix * ny + iy) * npl + iz
    return jnp.take(flat, idx, axis=-1)


def interp_3d(field: jnp.ndarray, loc: Locator, dtype=None) -> jnp.ndarray:
    """Trilinear interpolation of one 3-D field at the located cells
    (reference intpol_met_space_3d, c:3025-3046).

    ``field``: [..., nx, ny, npl] float32 (leading axes broadcast).
    Returns [..., np] in ``dtype`` (defaults to the weight dtype).
    """
    dtype = dtype or loc.wz.dtype
    ix, iy, iz = loc.ix, loc.iy, loc.iz
    wz, wy, wx = loc.wz, loc.wy, loc.wx

    def g(dx, dy, dz):
        return _gather3(field, ix + dx, iy + dy, iz + dz).astype(dtype)

    # Vertical...
    aux00 = wz * (g(0, 0, 0) - g(0, 0, 1)) + g(0, 0, 1)
    aux01 = wz * (g(0, 1, 0) - g(0, 1, 1)) + g(0, 1, 1)
    aux10 = wz * (g(1, 0, 0) - g(1, 0, 1)) + g(1, 0, 1)
    aux11 = wz * (g(1, 1, 0) - g(1, 1, 1)) + g(1, 1, 1)
    # Horizontal...
    aux0 = wy * (aux00 - aux01) + aux01
    aux1 = wy * (aux10 - aux11) + aux11
    return wx * (aux0 - aux1) + aux1


def interp_2d(field: jnp.ndarray, loc: Locator, dtype=None) -> jnp.ndarray:
    """Bilinear interpolation of a 2-D surface field with the
    reference's nearest-neighbour fallback for non-finite corners
    (intpol_met_space_2d, c:3084-3110).

    ``field``: [..., nx, ny].
    """
    dtype = dtype or loc.wy.dtype
    ix, iy = loc.ix, loc.iy
    wy, wx = loc.wy, loc.wx
    nx, ny = field.shape[-2:]
    flat = field.reshape(field.shape[:-2] + (nx * ny,))

    def g(dx, dy):
        return jnp.take(flat, (ix + dx) * ny + (iy + dy),
                        axis=-1).astype(dtype)

    a00, a01, a10, a11 = g(0, 0), g(0, 1), g(1, 0), g(1, 1)
    ok = (jnp.isfinite(a00) & jnp.isfinite(a01)
          & jnp.isfinite(a10) & jnp.isfinite(a11))
    aux0 = wy * (a00 - a01) + a01
    aux1 = wy * (a10 - a11) + a11
    bilin = wx * (aux0 - aux1) + aux1
    # Nearest-neighbour fallback
    nn = jnp.where(
        wy < 0.5,
        jnp.where(wx < 0.5, a11, a01),
        jnp.where(wx < 0.5, a10, a00))
    return jnp.where(ok, bilin, nn)


def time_weight(met01: Met, ts) -> jnp.ndarray:
    """wt = (t1 - ts) / (t1 - t0): weight of snapshot 0
    (reference intpol_met_time_3d, c:3130).

    The difference is taken in the time dtype (float64 — jsec values
    need it) and the ratio is cast to the grid-axis dtype so that fp32
    mode stays float32 downstream."""
    t0, t1 = met01.time[0], met01.time[1]
    return ((t1 - ts) / (t1 - t0)).astype(met01.lon.dtype)


def interp_time_3d(met01: Met, name: str, ts, loc: Locator,
                   dtype=None) -> jnp.ndarray:
    """Time + space interpolation of a stacked 3-D field
    (reference intpol_met_time_3d, c:3112)."""
    var01 = interp_3d(met01.fields3d[name], loc, dtype)
    wt = time_weight(met01, ts)
    return wt * (var01[0] - var01[1]) + var01[1]


def interp_time_2d(met01: Met, name: str, ts, loc: Locator,
                   dtype=None) -> jnp.ndarray:
    """Time + space interpolation of a stacked 2-D surface field with
    non-finite fallback (reference intpol_met_time_2d, c:3141)."""
    var01 = interp_2d(met01.fields2d[name], loc, dtype)
    wt = time_weight(met01, ts)
    v0, v1 = var01[0], var01[1]
    both = jnp.isfinite(v0) & jnp.isfinite(v1)
    return jnp.where(both, wt * (v0 - v1) + v1,
                     jnp.where(wt < 0.5, v1, v0))


# ---------------------------------------------------------------------------
# Model-level (zeta/eta) interpolation: intpol_met_4d_zeta (c:2808)
# ---------------------------------------------------------------------------

def interp_4d_zeta(met01: Met, heights_name: str, array_name: str, ts,
                   height, lon, lat, dtype=jnp.float64) -> jnp.ndarray:
    """4-D interpolation in a column-dependent vertical coordinate
    (reference intpol_met_4d_zeta, c:2808).

    ``heights_name`` selects the 3-D coordinate field (e.g. "zetal" or
    "pl"); ``array_name`` the field to interpolate.  The vertical cell
    is found by scanning the time/space-interpolated height profile of
    the enclosing column, reproducing the reference's bottom-up search.
    """
    heights = met01.fields3d[heights_name]  # [2, nx, ny, npl]
    array = met01.fields3d[array_name]
    lons, lats, _ = _grid_axes(met01)
    npl = met01.npl_ml if met01.npl_ml > 0 else heights.shape[-1]

    if met01.coord_type == 0:
        lon2, lat2 = check_lon_lat(lons, lats, lon, lat)
    else:
        lon2, lat2 = check_cartesian(lons, lats, lon, lat)
    ix = locate_reg(lons, lon2)
    iy = locate_irr(lats, lat2)
    wt1 = ((ts - met01.time[0])
           / (met01.time[1] - met01.time[0]))  # weight of snapshot 1
    x0, x1 = _axis_vals(lons, ix, getattr(met01, "reg_lon", False))
    y0, y1 = _axis_vals(lats, iy, getattr(met01, "reg_lat", False))
    wx1 = (lon2 - x0) / (x1 - x0)
    wy1 = (lat2 - y0) / (y1 - y0)

    # Time+horizontal interpolation of the full height profile of the
    # enclosing column (all four corners), then vertical search on the
    # interpolated profile.  Equivalent to the reference's bottom-up
    # walk (c:2900-2960) for monotone profiles, which
    # read_met_monotonize guarantees (c:10949).
    nx, ny, npl_f = heights.shape[-3:]
    hflat = heights.reshape(2, nx * ny, npl_f).astype(dtype)
    aflat = array.reshape(2, nx * ny, npl_f).astype(dtype)

    def corner(flat, dx, dy):
        prof = jnp.take(flat, (ix + dx) * ny + (iy + dy), axis=1)  # [2,np,npl]
        return wt1[..., None] * (prof[1] - prof[0]) + prof[0]      # [np,npl]

    h00 = corner(hflat, 0, 0)
    h01 = corner(hflat, 0, 1)
    h10 = corner(hflat, 1, 0)
    h11 = corner(hflat, 1, 1)
    h0 = wy1[..., None] * (h01 - h00) + h00
    h1 = wy1[..., None] * (h11 - h10) + h10
    hcol = wx1[..., None] * (h1 - h0) + h0       # [np_parcel, npl] profile

    hcol = hcol[..., :npl]
    iz = jax.vmap(locate_irr)(hcol, height)
    h_bot = jnp.take_along_axis(hcol, iz[..., None], axis=-1)[..., 0]
    h_top = jnp.take_along_axis(hcol, iz[..., None] + 1, axis=-1)[..., 0]
    wzeta = (height - h_bot) / (h_top - h_bot)

    a00 = corner(aflat, 0, 0)
    a01 = corner(aflat, 0, 1)
    a10 = corner(aflat, 1, 0)
    a11 = corner(aflat, 1, 1)
    a0 = wy1[..., None] * (a01 - a00) + a00
    a1 = wy1[..., None] * (a11 - a10) + a10
    acol = wx1[..., None] * (a1 - a0) + a0
    a_bot = jnp.take_along_axis(acol, iz[..., None], axis=-1)[..., 0]
    a_top = jnp.take_along_axis(acol, iz[..., None] + 1, axis=-1)[..., 0]
    return wzeta * (a_top - a_bot) + a_bot
