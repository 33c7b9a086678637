"""Optimized advection interpolation path.

The reference's inner loop gathers u, v, w from met0 and met1
separately — 48 scalar gathers per RK node (8 corners x 3 fields x 2
snapshots).  Packing everything one parcel needs at a grid location
into one table row turns those into a single wide-row gather per node
(``build_advect_pack64``).

Interpolation arithmetic runs in float32 (the met fields are float32;
the reference also loses f32 information at the load), while positions
and the RK accumulation stay in float64.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from mptrac_tpu.ops import interp
from mptrac_tpu.types import Met


class MetPack(NamedTuple):
    """Precomputed wide-row gather tables for one met snapshot pair:

    - ``w64``:  [nx*ny*npl, 64] — 8 corners x (u0,v0,w0,u1,v1,w1) in
      lanes 0-47 plus 8 corners x (t0,t1) in lanes 48-63.  One offset
      per parcel per RK stage (build_advect_pack64); or the 8-wide
      table (build_advect_pack, 8 offsets).
    - ``sfc``:  [nx*ny, 128] — 16 surface fields x 4 corners x 2
      snapshots (build_sfc_pack); one offset per parcel serves every
      2-D interpolation of a module.

    Either entry may be None; modules fall back to the exact
    (reference-parity) interpolation path.
    """
    w64: Optional[jnp.ndarray] = None
    sfc: Optional[jnp.ndarray] = None


#: parcel-chunk size bounding gather intermediates: XLA materializes
#: gathered rows ([np, 64/128] f32 — tens of GB at 100M parcels), so
#: the packed-interp kernels map over chunks of this many parcels
import os as _os
GATHER_CHUNK = int(_os.environ.get("MPTRAC_GATHER_CHUNK", 2_097_152))


def map_chunks(fn, args, chunk=None):
    """Apply ``fn`` over parcel-dimension chunks (lax.map) so the
    gathered-row intermediates stay bounded.  ``args`` are [n, ...]
    arrays; fn returns arrays with the chunk dimension first."""
    chunk = chunk or GATHER_CHUNK
    n = args[0].shape[0]
    if n <= chunk:
        return fn(*args)
    nch = -(-n // chunk)
    pad = nch * chunk - n

    def prep(x):
        if pad:
            x = jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
        return x.reshape(nch, chunk, *x.shape[1:])

    out = jax.lax.map(lambda xs: fn(*xs),
                      tuple(prep(x) for x in args))
    return jax.tree.map(
        lambda o: o.reshape(nch * chunk, *o.shape[2:])[:n], out)


#: 2-D fields packed by build_sfc_pack, in lane order
SFC_FIELDS = ("ps", "pbl", "ts", "zs", "cape", "cin", "pel", "plcl",
              "ess", "nss", "shf", "sst", "pt", "tt", "zt", "h2ot")


def build_met_pack(met01: Met) -> MetPack:
    """Build all gather tables for a met pair (once per met interval,
    amortized over the steps in between — replaces the reference's
    per-parcel cached-index reuse, mptrac.h:964)."""
    return MetPack(w64=build_advect_pack64(met01),
                   sfc=build_sfc_pack(met01))


def build_sfc_pack(met01: Met) -> jnp.ndarray:
    """[nx*ny, 128] float32: the 16 hot 2-D surface fields
    (SFC_FIELDS) x 4 horizontal corners x 2 snapshots.

    Lane = field*8 + (dx*2 + dy)*2 + snapshot, edge-clamped like
    build_advect_pack64.  ~16 MB at 1-degree resolution."""
    f0 = met01.fields2d[SFC_FIELDS[0]]
    nx, ny = f0.shape[-2:]
    nxy = nx * ny
    lanes = []
    for name in SFC_FIELDS:
        f2 = met01.fields2d[name]
        fe = jnp.pad(f2, ((0, 0), (0, 1), (0, 1)), mode="edge")
        for dx in (0, 1):
            for dy in (0, 1):
                for s in (0, 1):
                    lanes.append(fe[s, dx:dx + nx,
                                    dy:dy + ny].reshape(nxy))
    return jnp.stack(lanes, axis=-1)


def interp_sfc_packed(met01: Met, sfc: jnp.ndarray, names, ts,
                      loc: "interp.Locator"):
    """Time + bilinear interpolation of several surface fields from
    one sfc-pack gather; semantics match interp.interp_time_2d
    (incl. the non-finite nearest-neighbour and single-snapshot
    fallbacks, reference c:3084-3166).

    Returns {name: [np] value} for each requested name."""
    ny = met01.fields2d[SFC_FIELDS[0]].shape[-1]
    base = loc.ix * ny + loc.iy
    dtype = loc.wy.dtype
    wt = interp.time_weight(met01, ts)

    def core(base, wx, wy, wt):
        rows = jnp.take(sfc, base, axis=0)             # [C, 128]
        vals = []
        for name in names:
            f = SFC_FIELDS.index(name)

            def snap(s, f=f):
                a00 = rows[:, f * 8 + 0 + s].astype(dtype)
                a01 = rows[:, f * 8 + 2 + s].astype(dtype)
                a10 = rows[:, f * 8 + 4 + s].astype(dtype)
                a11 = rows[:, f * 8 + 6 + s].astype(dtype)
                ok = (jnp.isfinite(a00) & jnp.isfinite(a01)
                      & jnp.isfinite(a10) & jnp.isfinite(a11))
                aux0 = wy * (a00 - a01) + a01
                aux1 = wy * (a10 - a11) + a11
                bilin = wx * (aux0 - aux1) + aux1
                nn = jnp.where(
                    wy < 0.5,
                    jnp.where(wx < 0.5, a11, a01),
                    jnp.where(wx < 0.5, a10, a00))
                return jnp.where(ok, bilin, nn)

            v0, v1 = snap(0), snap(1)
            both = jnp.isfinite(v0) & jnp.isfinite(v1)
            vals.append(jnp.where(both, wt * (v0 - v1) + v1,
                                  jnp.where(wt < 0.5, v1, v0)))
        return jnp.stack(vals, axis=-1)                # [C, K]

    stacked = map_chunks(core, (base, loc.wx, loc.wy, wt))
    return {name: stacked[:, i] for i, name in enumerate(names)}


def interp_t_packed64(met01: Met, w64: jnp.ndarray, ts,
                      loc: "interp.Locator"):
    """Temperature from lanes 48-63 of the 64-wide corner table
    (trilinear + time lerp, same arithmetic as interp_uvw_packed64)."""
    u3 = met01.fields3d["u"]
    nx, ny, npl = u3.shape[-3:]
    base = (loc.ix * ny + loc.iy) * npl + loc.iz
    dtype = met01.lon.dtype
    wt = interp.time_weight(met01, ts)

    def core(base, wxf, wyf, wzf, wt):
        rows = jnp.take(w64, base, axis=0)
        wz = wzf[:, None]
        wy = wyf[:, None]
        wx = wxf[:, None]

        def c(i):
            return rows[:, 48 + i * 2:48 + (i + 1) * 2]
        a00 = wz * (c(0) - c(1)) + c(1)
        a01 = wz * (c(2) - c(3)) + c(3)
        a10 = wz * (c(4) - c(5)) + c(5)
        a11 = wz * (c(6) - c(7)) + c(7)
        a0 = wy * (a00 - a01) + a01
        a1 = wy * (a10 - a11) + a11
        vals = wx * (a0 - a1) + a1                     # [C, 2]
        v0 = vals[:, 0].astype(dtype)
        v1 = vals[:, 1].astype(dtype)
        return wt * (v0 - v1) + v1

    return map_chunks(core, (base, loc.wx.astype(jnp.float32),
                             loc.wy.astype(jnp.float32),
                             loc.wz.astype(jnp.float32), wt))


def build_advect_pack(met01: Met) -> jnp.ndarray:
    """Precompute the packed wind table [nx*ny*npl, 8] float32 from a
    stacked met pair.  Done once per met interval (amortized over all
    steps between met reads)."""
    u = met01.fields3d["u"]      # [2, nx, ny, npl] f32
    v = met01.fields3d["v"]
    w = met01.fields3d["w"]
    nx, ny, npl = u.shape[-3:]
    n = nx * ny * npl
    pack = jnp.stack([
        u[0].reshape(n), v[0].reshape(n), w[0].reshape(n),
        u[1].reshape(n), v[1].reshape(n), w[1].reshape(n),
        jnp.zeros(n, u.dtype), jnp.zeros(n, u.dtype)], axis=-1)
    return pack


def build_advect_pack64(met01: Met) -> jnp.ndarray:
    """Corner-complete packed wind table [nx*ny*npl, 64] float32.

    Packing the full 2x2x2 corner block x (u0,v0,w0,u1,v1,w1) into one
    64-lane row turns the 8-corner gather (8 offsets/parcel) into a
    single-offset gather.  Costs 64x the base field memory (1 GB for a
    1-degree global grid with 61 levels) — use ``build_advect_pack``
    (8-wide, 8 offsets) when device memory is tight.

    Lane layout: lane = corner*6 + comp, corner order (dx,dy,dz) =
    (0,0,0),(0,0,1),(0,1,0),(0,1,1),(1,0,0),(1,0,1),(1,1,0),(1,1,1),
    comp order (u0,v0,w0,u1,v1,w1); lanes 48-63 hold temperature
    (t0,t1) at the same 8 corners (used by module_meteo).
    """
    u = met01.fields3d["u"]      # [2, nx, ny, npl] f32
    v = met01.fields3d["v"]
    w = met01.fields3d["w"]
    t = met01.fields3d.get("t")
    nx, ny, npl = u.shape[-3:]
    n = nx * ny * npl

    def edge(f):
        # clamp-extend by one cell on each spatial axis (matches the
        # locate_3d index clamping at grid edges)
        return jnp.pad(f, ((0, 0), (0, 1), (0, 1), (0, 1)),
                       mode="edge")

    ue, ve, we = edge(u), edge(v), edge(w)
    te = edge(t) if t is not None else None
    lanes = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                for f in (ue, ve, we):
                    lanes.append(f[0, dx:dx + nx, dy:dy + ny,
                                   dz:dz + npl].reshape(n))
                for f in (ue, ve, we):
                    lanes.append(f[1, dx:dx + nx, dy:dy + ny,
                                   dz:dz + npl].reshape(n))
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                for s in (0, 1):
                    lanes.append(
                        te[s, dx:dx + nx, dy:dy + ny,
                           dz:dz + npl].reshape(n)
                        if te is not None else jnp.zeros(n, u.dtype))
    return jnp.stack(lanes, axis=-1)


def interp_uvw_packed64(met01: Met, pack64: jnp.ndarray, ts,
                        loc: "interp.Locator"):
    """Single-gather trilinear + time interpolation of (u, v, w) from
    the 64-wide corner table; numerically identical to
    interp_uvw_packed (same f32 arithmetic order)."""
    u3 = met01.fields3d["u"]
    nx, ny, npl = u3.shape[-3:]
    base = (loc.ix * ny + loc.iy) * npl + loc.iz
    dtype = met01.lon.dtype
    t0, t1 = met01.time[0], met01.time[1]
    wt = ((t1 - ts) / (t1 - t0)).astype(dtype)

    def core(base, wxf, wyf, wzf, wt):
        rows = jnp.take(pack64, base, axis=0)          # [C, 64] f32
        wz = wzf[:, None]
        wy = wyf[:, None]
        wx = wxf[:, None]

        def c(i):
            return rows[:, i * 6:(i + 1) * 6]
        a00 = wz * (c(0) - c(1)) + c(1)
        a01 = wz * (c(2) - c(3)) + c(3)
        a10 = wz * (c(4) - c(5)) + c(5)
        a11 = wz * (c(6) - c(7)) + c(7)
        a0 = wy * (a00 - a01) + a01
        a1 = wy * (a10 - a11) + a11
        vals = wx * (a0 - a1) + a1                     # [C, 6]
        v0 = vals[:, 0:3].astype(dtype)
        v1 = vals[:, 3:6].astype(dtype)
        return wt[:, None] * (v0 - v1) + v1            # [C, 3]

    out = map_chunks(core, (base, loc.wx.astype(jnp.float32),
                            loc.wy.astype(jnp.float32),
                            loc.wz.astype(jnp.float32), wt))
    return out[:, 0], out[:, 1], out[:, 2]


def interp_uvw_packed(met01: Met, pack: jnp.ndarray, ts, loc:
                      "interp.Locator"):
    """Time + trilinear interpolation of (u, v, w) from the packed
    table; returns three float64 arrays matching the reference
    intpol_met_time_3d results to f32 rounding."""
    u3 = met01.fields3d["u"]
    nx, ny, npl = u3.shape[-3:]
    ix, iy, iz = loc.ix, loc.iy, loc.iz
    base = (ix * ny + iy) * npl + iz

    # 8 corners: offsets in the flattened index space
    oy = npl
    ox = ny * npl
    corners = jnp.stack([
        base, base + 1, base + oy, base + oy + 1,
        base + ox, base + ox + 1, base + ox + oy, base + ox + oy + 1],
        axis=-1)                                       # [np, 8]
    rows = jnp.take(pack, corners, axis=0)             # [np, 8, 8] f32

    wz = loc.wz.astype(jnp.float32)[:, None]
    wy = loc.wy.astype(jnp.float32)[:, None]
    wx = loc.wx.astype(jnp.float32)[:, None]

    # corner order: (dx, dy, dz) = (0,0,0),(0,0,1),(0,1,0),(0,1,1),
    #                              (1,0,0),(1,0,1),(1,1,0),(1,1,1)
    c = rows  # [np, corner, comp]
    a00 = wz * (c[:, 0] - c[:, 1]) + c[:, 1]
    a01 = wz * (c[:, 2] - c[:, 3]) + c[:, 3]
    a10 = wz * (c[:, 4] - c[:, 5]) + c[:, 5]
    a11 = wz * (c[:, 6] - c[:, 7]) + c[:, 7]
    a0 = wy * (a00 - a01) + a01
    a1 = wy * (a10 - a11) + a11
    vals = wx * (a0 - a1) + a1                         # [np, 8]

    # Time lerp in the grid-axis dtype: float64 in parity mode (the
    # reference's double math over float fields), float32 in fp32 mode
    dtype = met01.lon.dtype
    t0, t1 = met01.time[0], met01.time[1]
    wt = ((t1 - ts) / (t1 - t0)).astype(dtype)
    v0 = vals[:, 0:3].astype(dtype)
    v1 = vals[:, 3:6].astype(dtype)
    out = wt[:, None] * (v0 - v1) + v1
    return out[:, 0], out[:, 1], out[:, 2]
