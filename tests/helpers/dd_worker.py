"""Worker for the 2-process domain-decomposition test.

Usage: python dd_worker.py <pid> <nproc> <port> <metdir>

Each process joins the multi-controller runtime with ONE cpu device
(an MPI-rank-like layout), reads only its own met hyperslab tile,
holds only its parcel shard, and runs the shard_map DD step — the
lax.all_to_all parcel exchange crosses the process boundary
(reference MPI_Alltoallv, mptrac.c:2072-2193).
"""

import os
import sys

pid, nproc, port, metdir = (int(sys.argv[1]), int(sys.argv[2]),
                            sys.argv[3], sys.argv[4])
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from mptrac_tpu.parallel import multihost

multihost.init_distributed(f"localhost:{port}", nproc, pid,
                           local_devices=1)

import jax
import jax.numpy as jnp
import numpy as np

import mptrac_tpu
from mptrac_tpu import read_ctl
from mptrac_tpu.climatology import read_clim
from mptrac_tpu.parallel import dd as ddm
from mptrac_tpu.types import Atm, stack_met

assert jax.process_count() == nproc
assert len(jax.devices()) == nproc

ctl = read_ctl(None, [
    "NQ", "1", "QNT_NAME[0]", "m", "METBASE", "-", "DT_MOD", "180",
    "DIFFUSION", "0", "T_STOP", "3600", "MET_TROPO", "0",
    "MET_CAPE", "0", "MET_PBL", "3",
    "DD", "1", "DD_SUBDOMAINS_ZONAL", str(nproc),
    "DD_SUBDOMAINS_MERIDIONAL", "1", "DD_HALOS_SIZE", "2"])
clim = read_clim(ctl)

# MET_MPI_SHARE analog: rank 0 reads, everyone receives the broadcast
from mptrac_tpu.met.build import read_met
met_shared = multihost.read_met_shared(
    os.path.join(metdir, "wind_2000_01_01_00.nc"), ctl)
met_glob = read_met(os.path.join(metdir, "wind_2000_01_01_00.nc"), ctl)
np.testing.assert_allclose(
    np.asarray(met_shared.fields3d["u"]),
    np.asarray(met_glob.fields3d["u"]), atol=0)
assert float(met_shared.time) == float(met_glob.time)
dd = ddm.plan_decomposition(ctl, met_glob, ndev=nproc)
lat_glob = np.asarray(met_glob.lat)

tiles_local = []
for fn in ("wind_2000_01_01_00.nc", "wind_2000_01_01_01.nc"):
    t = ddm.read_met_tile(os.path.join(metdir, fn), ctl, dd, pid,
                          lat_glob, clim)
    tiles_local.append(t)
tile_pair = stack_met(tiles_local[0], tiles_local[1])
# sanity: the hyperslab tile matches the sliced global read
sel = ddm.tile_selection(dd, pid, lat_glob)
assert tile_pair.fields3d["u"].shape[1] == sel[0].size

mesh = multihost.global_mesh("sub")

# Deterministic parcels on every process; keep only my shard
cap = 64
n = 40
rng = np.random.default_rng(7)
atm_h = Atm.zeros(n, ("m",))
atm_h = atm_h.replace(
    time=jnp.zeros(n, jnp.float64),
    lon=jnp.asarray(rng.uniform(-170, 170, n)),
    lat=jnp.asarray(rng.uniform(-60, 60, n)),
    p=jnp.asarray(rng.uniform(300, 800, n)),
    np=jnp.asarray(n, jnp.int32))
atm_h.q["m"] = jnp.ones(n, jnp.float64)
atm_all, cache_all = ddm.scatter_parcels(dd, atm_h, cap, lat_glob)
n_mine = int(np.asarray(atm_all.np)[pid])


def shard(tree, rank_block):
    return jax.tree.map(
        lambda x: np.asarray(x)[rank_block], tree)


blk = slice(pid * cap, (pid + 1) * cap)
atm_local = Atm(
    time=np.asarray(atm_all.time)[blk], p=np.asarray(atm_all.p)[blk],
    lon=np.asarray(atm_all.lon)[blk], lat=np.asarray(atm_all.lat)[blk],
    q={k: np.asarray(v)[blk] for k, v in atm_all.q.items()},
    np=np.asarray(atm_all.np)[pid:pid + 1])
cache_local = jax.tree.map(lambda x: x, cache_all)
from mptrac_tpu.types import Cache
cache_local = Cache.zeros(cap)
cache_local = cache_local.replace(rng_ctr=np.zeros(1, np.uint64))

atm_g = multihost.globalize(mesh, atm_local,
                            ddm._atm_spec("sub", ("m",)))
cache_g = multihost.globalize(mesh, cache_local,
                              ddm._cache_spec("sub"))
tiles_g = multihost.globalize(
    mesh, jax.tree.map(lambda x: np.asarray(x)[None], tile_pair))

dstep = ddm.make_dd_step(ctl, clim, dd, mesh, cap,
                         exch_cap=16, lat_axis=lat_glob)
a, c = atm_g, cache_g
for i in range(4):
    a, c, overflow, lost = dstep(tiles_g, a, c,
                                 jnp.asarray((i + 1) * 180.0))
res = multihost.localize(a)
ov = multihost.localize(overflow)

total = multihost.allsum_scalar(float(res.np[0]))
total_ov = multihost.allsum_scalar(float(ov[0]))
moved = multihost.allsum_scalar(
    float(np.abs(res.lon[:int(res.np[0])]).size))

assert total_ov == 0, f"overflow {total_ov}"
assert total == n, f"parcel count {total} != {n}"
print(f"OK pid={pid} n_init={n_mine} n_now={int(res.np[0])} "
      f"total={int(total)}")
