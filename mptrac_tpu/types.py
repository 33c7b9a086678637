"""Core state containers (pytrees).

JAX rebuild of the MPTRAC data model (reference
/root/reference/src/mptrac.h:2284-3832).  Differences from the
reference, by design:

* All containers are JAX pytrees of ``jnp`` arrays with **static
  shapes** — particle capacity ``npmax`` replaces the dynamic
  ``atm->np`` (the reference grows/shrinks np during domain
  decomposition, c:2265); a validity mask plus an ``np`` scalar carry
  the live count instead.
* ``Met`` holds one meteo snapshot; the stepper takes a ``MetPair``
  whose fields are stacked ``[2, ...]`` arrays (met0, met1) so that
  time interpolation is one fused lerp instead of pointer swapping
  (reference c:6232-6284).
* Struct-of-arrays layout is kept (``atm_t``, h:3341): it is exactly
  the layout vmap/XLA want.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls, data_fields, meta_fields=()):
    jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields))
    return cls


@dataclass
class Atm:
    """Particle state, struct-of-arrays (reference atm_t, mptrac.h:3341).

    time [s since 2000-01-01], p [hPa], lon/lat [deg] (or x/y [m] on
    Cartesian grids), q: dict of per-quantity arrays [npmax].
    ``np`` is the number of live particles (traced scalar); indices
    >= np are padding.
    """
    time: jnp.ndarray
    p: jnp.ndarray
    lon: jnp.ndarray
    lat: jnp.ndarray
    q: Dict[str, jnp.ndarray]
    np: jnp.ndarray  # int32 scalar

    @property
    def npmax(self) -> int:
        return self.time.shape[-1]

    @property
    def mask(self) -> jnp.ndarray:
        """Validity mask over the particle capacity axis."""
        return jnp.arange(self.npmax) < self.np

    @staticmethod
    def zeros(npmax: int, qnt_names=(), dtype=jnp.float64) -> "Atm":
        return Atm(
            time=jnp.zeros(npmax, dtype),
            p=jnp.zeros(npmax, dtype),
            lon=jnp.zeros(npmax, dtype),
            lat=jnp.zeros(npmax, dtype),
            q={n: jnp.zeros(npmax, dtype) for n in qnt_names},
            np=jnp.asarray(0, jnp.int32),
        )

    def replace(self, **kw) -> "Atm":
        return dataclasses.replace(self, **kw)


_register(Atm, ["time", "p", "lon", "lat", "q", "np"])


@dataclass
class Cache:
    """Per-particle scratch persisting across steps (reference cache_t,
    mptrac.h:3396): AR(1) mesoscale wind perturbations ``uvwp`` [3, npmax]
    (float32 like the reference), per-particle timestep ``dt`` [npmax],
    and the global Squares RNG counter (reference rng_ctr, mptrac.c:35).
    """
    uvwp: jnp.ndarray          # [3, npmax] float32
    dt: jnp.ndarray            # [npmax]
    rng_ctr: jnp.ndarray       # uint64 scalar
    iso_var: jnp.ndarray       # [npmax] isosurface variable (module_isosurf)
    iso_ps: jnp.ndarray        # balloon pressure track [nmax]
    iso_ts: jnp.ndarray        # balloon time track [nmax]
    iso_n: jnp.ndarray         # int32 scalar

    @staticmethod
    def zeros(npmax: int, dtype=jnp.float64, iso_nmax: int = 1,
              iso_npmax: int = None) -> "Cache":
        """``iso_npmax`` sizes the per-particle isosurface variable;
        pass 1 when ISOSURF is off (saves 400 MB at 100M parcels)."""
        return Cache(
            uvwp=jnp.zeros((3, npmax), jnp.float32),
            dt=jnp.zeros(npmax, dtype),
            rng_ctr=jnp.asarray(0, jnp.uint64),
            iso_var=jnp.zeros(npmax if iso_npmax is None
                              else iso_npmax, dtype),
            iso_ps=jnp.zeros(iso_nmax, dtype),
            iso_ts=jnp.zeros(iso_nmax, dtype),
            iso_n=jnp.asarray(0, jnp.int32),
        )

    def replace(self, **kw) -> "Cache":
        return dataclasses.replace(self, **kw)


_register(Cache, ["uvwp", "dt", "rng_ctr", "iso_var", "iso_ps", "iso_ts",
                  "iso_n"])

# ---------------------------------------------------------------------
# Cache field categories — the SINGLE source of truth for every
# sharding-spec / placement tree over Cache (parallel.dd, parallel.mesh,
# multihost users).  A new data field MUST be added to exactly one
# category; the import-time assertion below fails loudly otherwise, so
# a spec site can never silently drop a field again (that regression
# broke all DD paths in round 4).
# ---------------------------------------------------------------------
#: [npmax] per-particle arrays (sharded over the particle axis)
CACHE_PARTICLE_FIELDS = ("dt", "iso_var")
#: [k, npmax] per-particle arrays with a leading non-particle axis
CACHE_PARTICLE2D_FIELDS = ("uvwp",)
#: per-device scalars (one value per device under DD shard_map)
CACHE_DEVICE_SCALAR_FIELDS = ("rng_ctr",)
#: small replicated global tables / scalars
CACHE_GLOBAL_FIELDS = ("iso_ps", "iso_ts", "iso_n")

_CACHE_ALL = (set(CACHE_PARTICLE_FIELDS) | set(CACHE_PARTICLE2D_FIELDS)
              | set(CACHE_DEVICE_SCALAR_FIELDS) | set(CACHE_GLOBAL_FIELDS))
assert _CACHE_ALL == {f.name for f in dataclasses.fields(Cache)}, (
    "Cache field categories out of sync with the dataclass: "
    f"{_CACHE_ALL ^ {f.name for f in dataclasses.fields(Cache)}}")


def cache_field_tree(particle, particle2d, device_scalar, glob) -> "Cache":
    """Build a Cache-shaped tree with one value per field *category*
    (see the category constants above).  Used to derive every
    sharding-spec / placement tree for Cache from one place."""
    kw = {}
    for k in CACHE_PARTICLE_FIELDS:
        kw[k] = particle
    for k in CACHE_PARTICLE2D_FIELDS:
        kw[k] = particle2d
    for k in CACHE_DEVICE_SCALAR_FIELDS:
        kw[k] = device_scalar
    for k in CACHE_GLOBAL_FIELDS:
        kw[k] = glob
    return Cache(**kw)


#: 3-D fields of a meteo snapshot on pressure levels
#: (reference met_t, mptrac.h:3595-3765)
MET_3D_FIELDS = ("z", "t", "u", "v", "w", "pv", "h2o", "o3",
                 "lwc", "rwc", "iwc", "swc", "cc")
#: 3-D fields on model levels (CLaMS / diabatic transport)
MET_3D_ML_FIELDS = ("pl", "ul", "vl", "wl", "zetal", "zeta_dotl")
#: 2-D surface fields
MET_2D_FIELDS = ("ps", "ts", "zs", "us", "vs", "ess", "nss", "shf",
                 "lsm", "sst", "pbl", "pt", "tt", "zt", "h2ot",
                 "pct", "pcb", "cl", "plcl", "plfc", "pel", "cape",
                 "cin", "o3c")


@dataclass
class Met:
    """One gridded meteo snapshot (reference met_t, mptrac.h:3595).

    Axis layout follows the reference: 3-D fields are [nx, ny, npl]
    (lon, lat, level) float32; 2-D fields [nx, ny].  ``lon`` is a
    regular axis (locate_reg); ``lat`` and ``p`` may be irregular.
    ``coord_type`` 0 = lat/lon, 1 = Cartesian (static).
    """
    time: jnp.ndarray                 # scalar [s]
    lon: jnp.ndarray                  # [nx]
    lat: jnp.ndarray                  # [ny]
    p: jnp.ndarray                    # [npl] pressure levels [hPa]
    hybrid: jnp.ndarray               # [npl] hybrid coordinate
    fields2d: Dict[str, jnp.ndarray]  # each [nx, ny]
    fields3d: Dict[str, jnp.ndarray]  # each [nx, ny, npl]
    coord_type: int = 0               # static
    npl_ml: int = 0                   # static: number of model levels
    #: static: axis is EXACTLY arithmetic (xx[i] == xx[0] + i*dx,
    #: verified bitwise host-side) — enables gather-free index/weight
    #: arithmetic in the interpolation core with identical results
    reg_lon: bool = False
    reg_lat: bool = False
    #: static: lon axis carries a duplicated wraparound column
    #: (read_met_periodic, reference c:11390) — the cyclic period is
    #: nx-1 columns, which index-space consumers (slab kernel unwrap)
    #: must use
    lon_periodic: bool = False

    @property
    def nx(self) -> int:
        return self.lon.shape[0]

    @property
    def ny(self) -> int:
        return self.lat.shape[0]

    @property
    def npl(self) -> int:
        return self.p.shape[0]

    def f2(self, name: str) -> jnp.ndarray:
        return self.fields2d[name]

    def f3(self, name: str) -> jnp.ndarray:
        return self.fields3d[name]

    def replace(self, **kw) -> "Met":
        return dataclasses.replace(self, **kw)


_register(Met, ["time", "lon", "lat", "p", "hybrid", "fields2d", "fields3d"],
          ["coord_type", "npl_ml", "reg_lon", "reg_lat",
           "lon_periodic"])


def _axis_is_arithmetic(xx) -> bool:
    import numpy as np
    xx = np.asarray(xx)
    if xx.ndim != 1 or xx.size < 2:
        return False
    d = xx[1] - xx[0]
    return bool(np.all(xx == xx[0] + np.arange(xx.size) * d))


def detect_regular_axes(met: "Met") -> "Met":
    """Set the static reg_lon/reg_lat flags by exact host-side
    verification (call outside jit, once per met read)."""
    return met.replace(reg_lon=_axis_is_arithmetic(met.lon),
                       reg_lat=_axis_is_arithmetic(met.lat))


def astype_state(atm: "Atm" = None, cache: "Cache" = None,
                 met: "Met" = None, clim=None, dtype=jnp.float32):
    """Cast model state to a compute precision (framework extension;
    the reference is double-only).

    In fp32 mode positions, quantities, per-parcel timesteps and met
    grid axes go to float32 while parcel **time stays float64** (jsec
    magnitudes ~1e9 need it).  Position resolution at float32 is
    ~1e-5 degrees (~1 m) — the same order as the float32 met fields'
    own information content.  Float32 halves the bytes every gather
    moves; float64 remains the reference-parity default.  Returns the same tuple shape as the non-None inputs.
    """
    out = []
    if atm is not None:
        out.append(atm.replace(
            lon=atm.lon.astype(dtype), lat=atm.lat.astype(dtype),
            p=atm.p.astype(dtype),
            q={k: v.astype(dtype) for k, v in atm.q.items()}))
    if cache is not None:
        out.append(cache.replace(
            dt=cache.dt.astype(dtype),
            iso_var=cache.iso_var.astype(dtype),
            iso_ps=cache.iso_ps.astype(dtype),
            iso_ts=cache.iso_ts.astype(dtype)))
    if met is not None:
        out.append(dataclasses.replace(
            met, lon=met.lon.astype(dtype), lat=met.lat.astype(dtype),
            p=met.p.astype(dtype), hybrid=met.hybrid.astype(dtype)))
    if clim is not None:
        out.append(jax.tree.map(
            lambda a: a.astype(dtype)
            if hasattr(a, "dtype") and a.dtype == jnp.float64 else a,
            clim))
    return out[0] if len(out) == 1 else tuple(out)


def stack_met(met0: Met, met1: Met) -> Met:
    """Stack two time-bracketing snapshots along a new leading axis.

    Returns a Met whose array fields have shape [2, ...]; this is the
    form consumed by the interpolation kernels (replaces the reference
    met0/met1 pointer pair, c:6232).
    """
    return jax.tree.map(lambda a, b: jnp.stack([a, b]), met0, met1)


@dataclass
class Clim:
    """Climatological data (reference clim_t, mptrac.h:3536-3586)."""
    # Zonal-mean tropopause (built-in table, reference c:241-396)
    tropo_time: jnp.ndarray          # [ntime]
    tropo_lat: jnp.ndarray           # [nlat]
    tropo: jnp.ndarray               # [ntime, nlat] hPa
    # Photolysis table (clim_photo_t h:3428): rates [np, nsza, no3c]
    photo_p: jnp.ndarray
    photo_sza: jnp.ndarray
    photo_o3c: jnp.ndarray
    photo: Dict[str, jnp.ndarray]
    # Zonal mean fields (clim_zm_t h:3504): vmr [ntime, nlat, np]
    zm: Dict[str, "ClimZm"]
    # Time series (clim_ts_t h:3484)
    ts: Dict[str, "ClimTs"]

    def replace(self, **kw) -> "Clim":
        return dataclasses.replace(self, **kw)


@dataclass
class ClimZm:
    """One zonal-mean climatology (reference clim_zm_t, mptrac.h:3504)."""
    time: jnp.ndarray    # [ntime]
    lat: jnp.ndarray     # [nlat]
    p: jnp.ndarray       # [np]
    vmr: jnp.ndarray     # [ntime, nlat, np]


@dataclass
class ClimTs:
    """One climatological time series (reference clim_ts_t, mptrac.h:3484)."""
    time: jnp.ndarray    # [ntime]
    vmr: jnp.ndarray     # [ntime]


_register(ClimZm, ["time", "lat", "p", "vmr"])
_register(ClimTs, ["time", "vmr"])
_register(Clim, ["tropo_time", "tropo_lat", "tropo",
                 "photo_p", "photo_sza", "photo_o3c", "photo", "zm", "ts"])
