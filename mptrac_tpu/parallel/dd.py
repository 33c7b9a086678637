"""Spatial domain decomposition with parcel migration.

JAX rebuild of the reference's experimental MPI domain
decomposition (SURVEY §2.9/§3.4; reference /root/reference/src/mptrac.c:
dd_init c:2193, dd_assign_subdomains c:1918, dd_sort c:2384,
dd_communicate_particles c:2072 with MPI_Alltoallv, halo reads
dd_read_met_nc_grid c:11077):

* The met grid is split into a ``zonal x meridional`` grid of
  subdomains, one per device.  Each device's tile carries ``halo``
  extra longitude columns on both sides (periodic across the date
  line) and clamped latitude halos — built host-side once per met
  interval as a stacked ``[ndev, nx_loc, ny_loc, np]`` array, replacing
  per-step halo exchanges (met is static between reads).
* Parcels are sharded by owning subdomain with a fixed per-device
  capacity.  Each step runs the full physics pipeline per-device under
  ``shard_map``, then migrates parcels whose position left their
  owner's tile: bucket-sort by destination into fixed-capacity
  per-destination slots and exchange with ``jax.lax.all_to_all``
  (replacing MPI_Alltoallv; static shapes, overflow detected like the
  reference's NP check c:2281).
* Parcels leaving the global latitude range are dropped with a count
  (reference c:2486-2489 drops them with a warning).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mptrac_tpu.config import Ctl
from mptrac_tpu.types import Atm, Cache, Clim, Met


@dataclass(frozen=True)
class DDGrid:
    """Static decomposition descriptor (reference dd_t, mptrac.h:3772)."""
    n_zonal: int              # subdomains along longitude
    n_merid: int              # subdomains along latitude
    halo: int                 # halo width in grid points
    nx_glob: int              # global longitudes (incl. wrap column)
    ny_glob: int
    lon0: float               # global lon axis origin + spacing
    dlon: float
    periodic: bool            # global zonal coverage

    @property
    def ndev(self) -> int:
        return self.n_zonal * self.n_merid

    @property
    def nx_loc(self) -> int:
        base = self.nx_glob // self.n_zonal
        return base + 2 * self.halo

    @property
    def ny_loc(self) -> int:
        base = -(-self.ny_glob // self.n_merid)
        return base + 2 * self.halo

    def owner_of(self, lon, lat, lat_axis):
        """Target device index per parcel (reference
        dd_assign_subdomains, c:1918): zonal index from the regular lon
        axis, meridional from the irregular lat axis.  Longitude is
        wrapped into the global axis span first (module_position wraps
        to [-180, 180) while grids may span [0, 360])."""
        base_x = self.nx_glob // self.n_zonal
        lon_w = lon - jnp.floor((lon - self.lon0) / 360.0) * 360.0
        ix = jnp.floor((lon_w - self.lon0) / self.dlon).astype(jnp.int32)
        ix = jnp.clip(ix, 0, self.nx_glob - 1)
        sx = jnp.clip(ix // base_x, 0, self.n_zonal - 1)
        # compare-count over the short latitude axis
        iy = jnp.sum(lat_axis <= lat[..., None], axis=-1).astype(
            jnp.int32) - 1
        iy = jnp.clip(iy, 0, self.ny_glob - 1)
        base_y = -(-self.ny_glob // self.n_merid)
        sy = jnp.clip(iy // base_y, 0, self.n_merid - 1)
        return (sx * self.n_merid + sy).astype(jnp.int32)


def plan_decomposition(ctl: Ctl, met: Met, ndev: Optional[int] = None
                       ) -> DDGrid:
    n_zonal = ctl.dd_subdomains_zonal
    n_merid = ctl.dd_subdomains_meridional
    if ndev is not None and n_zonal * n_merid != ndev:
        raise ValueError(
            f"DD subdomains {n_zonal}x{n_merid} != {ndev} devices")
    lon = np.asarray(met.lon)
    lat = np.asarray(met.lat)
    periodic = abs(lon[-1] - lon[0] - 360.0) < 0.01
    return DDGrid(
        n_zonal=n_zonal, n_merid=n_merid, halo=max(ctl.dd_halos_size, 1),
        nx_glob=lon.size, ny_glob=lat.size,
        lon0=float(lon[0]), dlon=float(lon[1] - lon[0]),
        periodic=periodic)


def tile_selection(dd: DDGrid, rank: int, lat_glob: np.ndarray):
    """Hyperslab index arrays + replacement axes for one subdomain:
    (xidx, yidx, lon_axis, lat_axis).  x indices wrap periodically
    through the duplicated last column; y halos clamp at the poles
    with the axis extrapolated by the edge spacing so locate_irr stays
    strictly monotonic."""
    sx, sy = rank // dd.n_merid, rank % dd.n_merid
    base_x = dd.nx_glob // dd.n_zonal
    base_y = -(-dd.ny_glob // dd.n_merid)
    h = dd.halo
    startx = sx * base_x - h
    xraw = np.arange(startx, startx + base_x + 2 * h)
    if dd.periodic:
        xidx = np.mod(xraw, dd.nx_glob - 1)
    else:
        xidx = np.clip(xraw, 0, dd.nx_glob - 1)
    lon_axis = dd.lon0 + dd.dlon * xraw

    starty = sy * base_y - h
    yraw = np.arange(starty, starty + base_y + 2 * h)
    yidx = np.clip(yraw, 0, dd.ny_glob - 1)
    lat = np.asarray(lat_glob, np.float64)
    edge0 = lat[1] - lat[0]
    edge1 = lat[-1] - lat[-2]
    lat_axis = lat[yidx]
    lat_axis = np.where(yraw < 0, lat[0] + yraw * edge0, lat_axis)
    lat_axis = np.where(yraw > dd.ny_glob - 1,
                        lat[-1] + (yraw - (dd.ny_glob - 1)) * edge1,
                        lat_axis)
    return xidx, yidx, lon_axis, lat_axis


def read_met_tile(filename: str, ctl: Ctl, dd: DDGrid, rank: int,
                  lat_glob, clim=None) -> Met:
    """Read ONE subdomain's met tile (with halos) directly from the
    file as a hyperslab — each rank reads only its own rows instead of
    the full global grid (reference dd_read_met_nc_grid per-rank
    parallel-netCDF reads, c:11045-11253).  Preprocessing then runs on
    the tile only."""
    from mptrac_tpu.met.build import read_met
    sel = tile_selection(dd, rank, lat_glob)
    return read_met(filename, ctl, clim=clim, sel=sel)


def make_tiles(dd: DDGrid, met: Met) -> Met:
    """Split a global snapshot (or stacked pair) into per-device tiles
    with halos: arrays gain a leading [ndev] axis (the device shard
    axis)."""
    lon = np.asarray(met.lon if met.lon.ndim == 1 else met.lon[0])
    lat = np.asarray(met.lat if met.lat.ndim == 1 else met.lat[0])
    base_x = dd.nx_glob // dd.n_zonal
    base_y = -(-dd.ny_glob // dd.n_merid)
    h = dd.halo

    def xids(sx):
        start = sx * base_x - h
        idx = np.arange(start, start + base_x + 2 * h)
        if dd.periodic:
            # wrap through the duplicated last column: use modulo on
            # the nx-1 unique columns
            return np.mod(idx, dd.nx_glob - 1)
        return np.clip(idx, 0, dd.nx_glob - 1)

    def yids(sy):
        start = sy * base_y - h
        idx = np.arange(start, start + base_y + 2 * h)
        return idx, np.clip(idx, 0, dd.ny_glob - 1)

    tiles_lon, tiles_lat = [], []
    xsel, ysel = [], []
    for sx in range(dd.n_zonal):
        for sy in range(dd.n_merid):
            xi = xids(sx)
            yraw, yi = yids(sy)
            xsel.append(xi)
            ysel.append(yi)
            # local lon axis must stay monotonic across the wrap:
            # rebuild from the owner's start offset
            start = sx * base_x - h
            tiles_lon.append(dd.lon0 + dd.dlon
                             * np.arange(start, start + base_x + 2 * h))
            # halo rows clamped at the poles reuse the edge DATA row,
            # but the axis must stay strictly monotonic for locate_irr:
            # extrapolate axis values beyond the poles by edge spacing
            edge0 = lat[1] - lat[0]
            edge1 = lat[-1] - lat[-2]
            tlat = lat[yi].astype(np.float64)
            below = yraw < 0
            above = yraw > dd.ny_glob - 1
            tlat = np.where(below, lat[0] + yraw * edge0, tlat)
            tlat = np.where(above,
                            lat[-1] + (yraw - (dd.ny_glob - 1)) * edge1,
                            tlat)
            tiles_lat.append(tlat)
    xsel = np.array(xsel)
    ysel = np.array(ysel)

    def split3(a):
        out = np.stack([np.asarray(a)[..., xs, :, :][..., :, ys, :]
                        for xs, ys in zip(xsel, ysel)])
        return jnp.asarray(out)

    def split2(a):
        out = np.stack([np.asarray(a)[..., xs, :][..., :, ys]
                        for xs, ys in zip(xsel, ysel)])
        return jnp.asarray(out)

    stacked = met.lon.ndim == 2  # met0/met1 pair
    return Met(
        time=jnp.broadcast_to(met.time, (dd.ndev,) + met.time.shape),
        lon=jnp.asarray(np.broadcast_to(
            np.stack(tiles_lon)[:, None] if stacked
            else np.stack(tiles_lon),
            (dd.ndev, 2, dd.nx_loc) if stacked
            else (dd.ndev, dd.nx_loc))),
        lat=jnp.asarray(np.broadcast_to(
            np.stack(tiles_lat)[:, None] if stacked
            else np.stack(tiles_lat),
            (dd.ndev, 2, dd.ny_loc) if stacked
            else (dd.ndev, dd.ny_loc))),
        p=jnp.broadcast_to(met.p, (dd.ndev,) + met.p.shape),
        hybrid=jnp.broadcast_to(met.hybrid,
                                (dd.ndev,) + met.hybrid.shape),
        fields2d={k: split2(v) for k, v in met.fields2d.items()},
        fields3d={k: split3(v) for k, v in met.fields3d.items()},
        coord_type=met.coord_type, npl_ml=met.npl_ml)


def scatter_parcels(dd: DDGrid, atm: Atm, cap: int, lat_axis
                    ) -> Tuple[Atm, Cache]:
    """Distribute a host Atm onto per-device slots [ndev * cap]:
    argsort bucketing, no per-parcel loop (the reference's analog is
    the initial dd_sort + MPI scatter, c:2384)."""
    n = int(atm.np)
    lon = np.asarray(atm.lon)[:n]
    lat = np.asarray(atm.lat)[:n]
    owner = np.asarray(dd.owner_of(jnp.asarray(lon), jnp.asarray(lat),
                                   jnp.asarray(lat_axis)))
    counts = np.bincount(owner, minlength=dd.ndev).astype(np.int32)
    if n and counts.max() > cap:
        raise ValueError("DD per-device capacity exceeded!")
    order = np.argsort(owner, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n) - starts[owner[order]]
    slots = owner[order] * cap + pos

    out = Atm.zeros(dd.ndev * cap, tuple(atm.q))
    N = dd.ndev * cap

    def place(src, fill=0.0):
        a = np.full(N, fill, np.float64)
        a[slots] = np.asarray(src)[:n][order]
        return jnp.asarray(a)

    out = out.replace(
        time=place(atm.time), p=place(atm.p, 1000.0),
        lon=place(atm.lon), lat=place(atm.lat),
        q={k: place(v) for k, v in atm.q.items()},
        np=jnp.asarray(counts))
    cache = Cache.zeros(dd.ndev * cap)
    # per-device scalar fields get a [ndev] leading axis
    cache = cache.replace(rng_ctr=jnp.zeros(dd.ndev, jnp.uint64))
    return out, cache


def gather_parcels(dd: DDGrid, atm: Atm, cap: int) -> Atm:
    """Collect live parcels from all devices into a dense host Atm
    (vectorized keep-mask, no per-device loop)."""
    counts = np.asarray(atm.np)
    slot = np.arange(dd.ndev * cap)
    keep = np.flatnonzero(slot % cap < counts[slot // cap])
    n = keep.size
    return Atm(
        time=jnp.asarray(np.asarray(atm.time)[keep]),
        p=jnp.asarray(np.asarray(atm.p)[keep]),
        lon=jnp.asarray(np.asarray(atm.lon)[keep]),
        lat=jnp.asarray(np.asarray(atm.lat)[keep]),
        q={k: jnp.asarray(np.asarray(v)[keep]) for k, v in atm.q.items()},
        np=jnp.asarray(n, jnp.int32))


def make_dd_step(ctl: Ctl, clim: Clim, dd: DDGrid, mesh: Mesh, cap: int,
                 exch_cap: int, lat_axis, exchange: bool = True):
    """Build the jitted SPMD step: local physics + all_to_all parcel
    migration.  ``exch_cap`` is the per-destination migration capacity
    (static; overflow is counted, mirroring the reference's hard NP
    check).  ``exchange=False`` skips the migration phase entirely
    (physics-only; the bench uses the delta to attribute per-step
    communication + compaction cost, and the third output becomes the
    would-migrate parcel count instead of the overflow count)."""
    from mptrac_tpu.physics import pipeline

    axis = mesh.axis_names[0]
    ndev = dd.ndev
    lat_axis = jnp.asarray(lat_axis)
    qnames = tuple(ctl.qnt_name)
    nfields = 4 + len(qnames)

    def local_step(met01, atm, cache, t):
        """Runs per device: met01 leaves have a leading [1] device axis
        from shard_map — squeeze it; atm/cache are the local [cap]
        slices."""
        from mptrac_tpu.types import CACHE_DEVICE_SCALAR_FIELDS
        met_loc = jax.tree.map(lambda x: x[0], met01)
        atm = atm.replace(np=atm.np[0])
        # per-device scalar fields arrive [1]-shaped: squeeze them all
        cache = cache.replace(**{
            k: getattr(cache, k)[0] for k in CACHE_DEVICE_SCALAR_FIELDS})
        my = jax.lax.axis_index(axis)

        # Device-local RNG stream: offset the Squares counter far per
        # device so streams never overlap (2^40 draws each).
        cache = cache.replace(
            rng_ctr=cache.rng_ctr
            + my.astype(jnp.uint64) * jnp.uint64(1 << 40))
        atm2, cache2 = pipeline.run_timestep(ctl, clim, met_loc, atm,
                                             cache, t)
        cache2 = cache2.replace(
            rng_ctr=cache2.rng_ctr
            - my.astype(jnp.uint64) * jnp.uint64(1 << 40))

        # --- Migration (reference module_dd, c:4168) ---
        dest = dd.owner_of(atm2.lon, atm2.lat, lat_axis)
        valid = atm2.mask
        # out-of-global-latitude parcels are dropped
        glat0, glat1 = lat_axis[0], lat_axis[-1]
        lost = valid & ((atm2.lat < jnp.minimum(glat0, glat1))
                        | (atm2.lat > jnp.maximum(glat0, glat1)))
        valid = valid & ~lost
        stay = valid & (dest == my)
        move = valid & (dest != my)

        if not exchange:
            cache2 = cache2.replace(**{
                k: getattr(cache2, k)[None]
                for k in CACHE_DEVICE_SCALAR_FIELDS})
            return (atm2.replace(np=atm2.np[None]), cache2,
                    jnp.sum(move)[None], jnp.sum(lost)[None])

        fields = jnp.stack(
            [atm2.time, atm2.p, atm2.lon, atm2.lat]
            + [atm2.q[k] for k in qnames]
            + [cache2.uvwp[0].astype(atm2.time.dtype),
               cache2.uvwp[1].astype(atm2.time.dtype),
               cache2.uvwp[2].astype(atm2.time.dtype)],
            axis=-1)                                  # [cap, F+3]

        # Compact keepers to the front
        keep_order = jnp.argsort(~stay, stable=True)
        fields_k = fields[keep_order]
        n_keep = jnp.sum(stay).astype(jnp.int32)

        # Bucket movers by destination into the send buffer
        send = jnp.zeros((ndev, exch_cap, nfields + 3),
                         fields.dtype)
        sent_flag = jnp.zeros((ndev, exch_cap), jnp.int32)
        dest_mv = jnp.where(move, dest, ndev)
        mv_order = jnp.argsort(dest_mv, stable=True)
        dsorted = dest_mv[mv_order]
        # rank within destination bucket
        idx = jnp.arange(dsorted.shape[0])
        bucket_start = jnp.searchsorted(dsorted, jnp.arange(ndev),
                                        side="left")
        pos = idx - bucket_start[jnp.clip(dsorted, 0, ndev - 1)]
        ok = (dsorted < ndev) & (pos < exch_cap)
        overflow = jnp.sum((dsorted < ndev) & (pos >= exch_cap))
        # out-of-range destination drops the scatter (non-ok entries)
        dscat = jnp.where(ok, dsorted, ndev)
        pscat = jnp.where(ok, pos, 0)
        send = send.at[dscat, pscat].set(fields[mv_order], mode="drop")
        sent_flag = sent_flag.at[dscat, pscat].set(
            jnp.where(ok, 1, 0), mode="drop")

        # Exchange (replaces MPI_Alltoallv, c:2243)
        recv = jax.lax.all_to_all(send, axis, split_axis=0,
                                  concat_axis=0, tiled=True)
        rflag = jax.lax.all_to_all(sent_flag, axis, split_axis=0,
                                   concat_axis=0, tiled=True)
        recv = recv.reshape(ndev * exch_cap, nfields + 3)
        rflag = rflag.reshape(ndev * exch_cap)

        # Append received parcels after the keepers
        r_order = jnp.argsort(rflag == 0, stable=True)
        recv_c = recv[r_order]
        n_recv = jnp.sum(rflag).astype(jnp.int32)
        slots = jnp.arange(fields.shape[0])
        recv_idx = jnp.clip(slots - n_keep, 0, ndev * exch_cap - 1)
        take_recv = (slots >= n_keep) & (slots < n_keep + n_recv)
        merged = jnp.where(take_recv[:, None], recv_c[recv_idx],
                           fields_k)
        n_new = n_keep + n_recv
        live = slots < n_new
        merged = jnp.where(live[:, None], merged, 0.0)

        atm3 = atm2.replace(
            time=merged[:, 0], p=jnp.where(live, merged[:, 1], 1000.0),
            lon=merged[:, 2], lat=merged[:, 3],
            q={k: merged[:, 4 + i] for i, k in enumerate(qnames)},
            np=n_new[None])
        cache3 = cache2.replace(
            uvwp=merged[:, nfields:nfields + 3].T.astype(jnp.float32),
            **{k: getattr(cache2, k)[None]
               for k in CACHE_DEVICE_SCALAR_FIELDS})
        return atm3, cache3, overflow[None], jnp.sum(lost)[None]

    in_specs = (P(axis),  # pytree prefix: every met tile leaf sharded
                _atm_spec(axis, qnames), _cache_spec(axis), P())
    out_specs = (_atm_spec(axis, qnames), _cache_spec(axis), P(axis),
                 P(axis))

    smapped = shard_map(local_step, mesh=mesh, in_specs=in_specs,
                        out_specs=out_specs, check_vma=False)
    return jax.jit(smapped)


def _atm_spec(axis, qnames):
    return Atm(time=P(axis), p=P(axis), lon=P(axis), lat=P(axis),
               q={k: P(axis) for k in qnames}, np=P(axis))


def _cache_spec(axis):
    """Derived from the Cache field categories (types.py) so a new
    Cache field can never be silently dropped from the DD spec."""
    from mptrac_tpu.types import cache_field_tree
    return cache_field_tree(particle=P(axis), particle2d=P(None, axis),
                            device_scalar=P(axis), glob=P())
