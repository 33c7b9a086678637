"""Physics-module tests: analytic advection, module behaviors, and a
full-pipeline smoke test with every module enabled."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mptrac_tpu import read_ctl, stack_met
from mptrac_tpu.climatology import read_clim
from mptrac_tpu.met.synthetic import make_wind_met, solid_body_solution
from mptrac_tpu.physics import pipeline
from mptrac_tpu.types import Atm, Cache


def make_atm(lon, lat, p, qnt_names=(), t=0.0):
    n = len(lon)
    atm = Atm.zeros(n, qnt_names)
    return atm.replace(
        time=jnp.full(n, t, jnp.float64),
        lon=jnp.asarray(lon, jnp.float64),
        lat=jnp.asarray(lat, jnp.float64),
        p=jnp.asarray(p, jnp.float64),
        np=jnp.asarray(n, jnp.int32))


def advect_only_ctl(**over):
    args = ["NQ", "0", "METBASE", "-", "DIFFUSION", "0",
            "T_STOP", "864000", "DT_MOD", "600", "ADVECT", "4",
            "MET_DT_OUT", "0"]
    for k, v in over.items():
        args += [k, str(v)]
    return read_ctl(None, args)


@pytest.mark.parametrize("alpha", [0.0, 45.0])
def test_solid_body_advection_analytic(alpha):
    """RK4 advection of the rotated solid-body flow must track the
    analytic great-circle trajectories (dd_test's validation approach,
    reference tests/dd_test)."""
    ctl = advect_only_ctl()
    clim = read_clim(ctl)
    u0 = 38.587660177302
    met0 = make_wind_met(t0=0.0, alpha=alpha, u0=u0)
    met1 = make_wind_met(t0=86400.0, alpha=alpha, u0=u0)
    met01 = stack_met(met0, met1)

    lon0 = np.array([0.0, 50.0, -120.0, 10.0])
    lat0 = np.array([0.0, 30.0, -45.0, 80.0])
    p0 = np.full(4, 500.0)
    atm = make_atm(lon0, lat0, p0)
    cache = Cache.zeros(4)

    nsteps = 24 * 3  # one day, 20-min steps
    dt = 1200.0
    ctl = ctl.replace(t_start=0.0, t_stop=nsteps * dt, dt_mod=dt)
    step = pipeline.make_step(ctl, clim)
    for i in range(1, nsteps + 1):
        atm, cache = step(met01, atm, cache,
                          jnp.asarray(i * dt, jnp.float64))

    lon_exp, lat_exp = solid_body_solution(lon0, lat0, u0, nsteps * dt,
                                           alpha)
    # 1-degree grid, trilinear wind sampling: error is dominated by the
    # O(dx) interpolation of the curved flow (halves when the grid is
    # refined), worst for the high-latitude parcel.
    dlat = np.abs(np.asarray(atm.lat) - lat_exp)
    dlon = np.abs((np.asarray(atm.lon) - lon_exp + 180) % 360 - 180)
    assert dlat.max() < 0.05 if alpha == 0.0 else dlat.max() < 0.1
    assert (dlon * np.cos(np.deg2rad(lat_exp))).max() < 0.15


def test_full_pipeline_all_modules():
    """Every module enabled at once: compiles and produces finite
    state."""
    ctl = read_ctl(None, [
        "NQ", "10",
        "QNT_NAME[0]", "m", "QNT_NAME[1]", "vmr", "QNT_NAME[2]", "t",
        "QNT_NAME[3]", "ens", "QNT_NAME[4]", "Cx",
        "QNT_NAME[5]", "loss_rate", "QNT_NAME[6]", "mloss_oh",
        "QNT_NAME[7]", "aoa", "QNT_NAME[8]", "rp", "QNT_NAME[9]", "rhop",
        "METBASE", "-", "DIFFUSION", "1", "TURB_PBL_SCHEME", "1",
        "CONV_CAPE", "0", "CONV_MIX_PBL", "1",
        "TDEC_TROP", "86400", "TDEC_STRAT", "86400",
        "MIXING_TROP", "0.5", "MIXING_STRAT", "0.1",
        "SPECIES", "SO2", "RADIO_DECAY", "1",
        "BOUND_LAT0", "-90", "BOUND_LAT1", "90",
        "BOUND_P0", "1e10", "BOUND_P1", "500", "BOUND_MASS", "1",
        "DRY_DEPO_VDEP", "0.01",
        "T_STOP", "86400", "DT_MOD", "600"])
    assert ctl.oh_chem_reaction == 3      # SO2 preset
    assert ctl.wet_depo_ic_h[0] > 0       # wet depo enabled via preset
    clim = read_clim(ctl)
    met0 = make_wind_met(t0=0.0, nx=72, ny=37, nz=20)
    met1 = make_wind_met(t0=3600.0, nx=72, ny=37, nz=20)
    met01 = stack_met(met0, met1)

    n = 500
    rng = np.random.default_rng(1)
    atm = make_atm(rng.uniform(-180, 180, n), rng.uniform(-85, 85, n),
                   rng.uniform(100, 1000, n), ctl.qnt_name)
    atm.q["m"] = jnp.ones(n, jnp.float64)
    atm.q["vmr"] = jnp.full(n, 1e-9, jnp.float64)
    atm.q["rp"] = jnp.full(n, 1.0, jnp.float64)
    atm.q["rhop"] = jnp.full(n, 1000.0, jnp.float64)
    cache = Cache.zeros(n)

    ctl = ctl.replace(t_start=0.0)
    atm, cache = pipeline.init_modules(ctl, clim, met01, atm, cache)
    step = pipeline.make_step(ctl, clim)
    for i in (1, 2):
        atm, cache = step(met01, atm, cache,
                          jnp.asarray(i * 600.0, jnp.float64))
    assert np.isfinite(np.asarray(atm.lon)).all()
    assert np.isfinite(np.asarray(atm.lat)).all()
    assert np.isfinite(np.asarray(atm.p)).all()
    m = np.asarray(atm.q["m"])
    assert np.isfinite(m).all()
    assert (m <= 1.0 + 1e-12).all()      # only losses apply... bound sets 1
    assert int(cache.rng_ctr) > 0


def test_mixing_converges_to_box_mean():
    from mptrac_tpu.physics.mixing import module_mixing
    ctl = read_ctl(None, [
        "NQ", "1", "QNT_NAME[0]", "m", "METBASE", "-",
        "MIXING_TROP", "1", "MIXING_STRAT", "1",
        "MIXING_NX", "4", "MIXING_NY", "4", "MIXING_NZ", "2",
        "T_STOP", "3600"])
    clim = read_clim(ctl)
    # two parcels in the same box with masses 0 and 2 -> both become 1
    atm = make_atm([10.0, 10.0], [10.0, 10.0], [500.0, 500.0],
                   ctl.qnt_name)
    atm.q["m"] = jnp.asarray([0.0, 2.0])
    out = module_mixing(ctl, clim, atm, 0.0)
    np.testing.assert_allclose(np.asarray(out.q["m"]), [1.0, 1.0])


def test_radio_decay_halflife():
    from mptrac_tpu.physics.decay import module_radio_decay
    ctl = read_ctl(None, ["NQ", "1", "QNT_NAME[0]", "Arn222",
                          "METBASE", "-", "RADIO_DECAY", "1",
                          "T_STOP", "1"])
    atm = make_atm([0.0], [0.0], [500.0], ctl.qnt_name)
    atm.q["Arn222"] = jnp.asarray([1.0])
    cache = Cache.zeros(1)
    cache = cache.replace(dt=jnp.asarray([3.8235 * 86400.0]))  # 1 half-life
    out = module_radio_decay(ctl, cache, atm)
    np.testing.assert_allclose(np.asarray(out.q["Arn222"]), [0.5],
                               rtol=1e-12)


def test_sort_groups_by_cell():
    from mptrac_tpu.ops.sort import module_sort
    met0 = make_wind_met(nx=36, ny=19, nz=8)
    met01 = stack_met(met0, met0)
    rng = np.random.default_rng(2)
    n = 256
    atm = make_atm(rng.uniform(-180, 180, n), rng.uniform(-90, 90, n),
                   rng.uniform(10, 1000, n))
    cache = Cache.zeros(n)
    atm2, cache2 = module_sort(met01, atm, cache)
    from mptrac_tpu.ops.sort import sort_key
    keys = np.asarray(sort_key(met01, atm2))
    assert (np.diff(keys) >= 0).all()
    # same multiset of positions
    np.testing.assert_allclose(np.sort(np.asarray(atm.lon)),
                               np.sort(np.asarray(atm2.lon)))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_sort_handles_arbitrary_permutation(dtype):
    """module_sort is exact for ANY initial order (not only for the
    near-sorted order of a re-sort) in f32 and f64 state, permutes
    the cache with the parcels, and keeps parcel time float64."""
    from mptrac_tpu.ops.sort import module_sort, sort_key
    from mptrac_tpu.types import astype_state
    met01 = stack_met(make_wind_met(nx=36, ny=19, nz=8),
                      make_wind_met(t0=3600.0, nx=36, ny=19, nz=8))
    rng = np.random.default_rng(11)
    n = 2048
    atm = make_atm(rng.uniform(-180, 180, n), rng.uniform(-85, 85, n),
                   rng.uniform(10, 1000, n), ("m",))
    # times that need all 53 significand bits
    atm = atm.replace(time=jnp.asarray(rng.uniform(3e8, 4e8, n)),
                      q={"m": jnp.asarray(rng.uniform(0, 1, n))})
    cache = Cache.zeros(n).replace(
        dt=jnp.asarray(rng.uniform(-180, 180, n)),
        uvwp=jnp.asarray(rng.normal(size=(3, n)), jnp.float32),
        iso_var=jnp.asarray(rng.uniform(0, 1, n)))
    if dtype == jnp.float32:
        atm, cache, met01 = astype_state(atm, cache, met01)
    atm2, cache2 = jax.jit(module_sort)(met01, atm, cache)

    order = np.argsort(np.asarray(sort_key(met01, atm)), kind="stable")
    assert atm2.time.dtype == jnp.float64
    for f in ("time", "lon", "lat", "p"):
        assert getattr(atm2, f).dtype == getattr(atm, f).dtype
        np.testing.assert_array_equal(np.asarray(getattr(atm2, f)),
                                      np.asarray(getattr(atm, f))[order])
    np.testing.assert_array_equal(np.asarray(atm2.q["m"]),
                                  np.asarray(atm.q["m"])[order])
    for f in ("dt", "iso_var"):
        np.testing.assert_array_equal(np.asarray(getattr(cache2, f)),
                                      np.asarray(getattr(cache, f))[order])
    np.testing.assert_array_equal(np.asarray(cache2.uvwp),
                                  np.asarray(cache.uvwp)[:, order])


def test_clim_tropo_exact_in_f32():
    """At table nodes the tropopause lookup returns clim.tropo[i, j]
    bit for bit in f32 state: the one-hot row selection must not lose
    mantissa bits (a GPU would run a default-precision f32 matmul in
    TF32)."""
    from mptrac_tpu.climatology import clim_tropo
    from mptrac_tpu.types import astype_state
    ctl = read_ctl(None, ["NQ", "0", "METBASE", "-"])
    clim = astype_state(clim=read_clim(ctl))
    assert clim.tropo.dtype == jnp.float32
    tt = np.asarray(clim.tropo_time)
    tl = np.asarray(clim.tropo_lat)
    # interior nodes: at the last node of an axis the lookup
    # interpolates with weight 1 from the cell below
    ii, jj = np.meshgrid(np.arange(tt.size - 1), np.arange(tl.size - 1),
                         indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    got = jax.jit(lambda t, lat: clim_tropo(clim, t, lat))(
        jnp.asarray(tt[ii], jnp.float64), jnp.asarray(tl[jj]))
    assert got.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(clim.tropo)[ii, jj])


def test_isosurf_pressure_and_balloon(tmp_path):
    """Isosurface modes: 1 pins parcels to their initial pressure, 4
    follows a balloon p(t) track (reference module_isosurf,
    c:4878-5001)."""
    import jax
    from mptrac_tpu import read_ctl, stack_met
    from mptrac_tpu.met.synthetic import make_wind_met
    from mptrac_tpu.physics.isosurf import (module_isosurf,
                                            module_isosurf_init)
    from mptrac_tpu.types import Atm, Cache

    met01 = stack_met(make_wind_met(t0=0.0, w0=1.0),
                      make_wind_met(t0=86400.0, w0=1.0))
    n = 8
    atm = Atm.zeros(n).replace(
        time=jnp.full(n, 3000.0),
        lon=jnp.linspace(-150, 150, n),
        lat=jnp.zeros(n), p=jnp.linspace(300, 800, n),
        np=jnp.asarray(n, jnp.int32))
    cache = Cache.zeros(n)

    # mode 1: restore the saved pressure after perturbation
    ctl = read_ctl(None, ["NQ", "0", "METBASE", "-", "T_STOP", "86400",
                          "ISOSURF", "1"])
    cache1 = module_isosurf_init(ctl, cache, met01, atm)
    moved = atm.replace(p=atm.p + 37.0)
    back = module_isosurf(ctl, cache1, met01, moved)
    np.testing.assert_allclose(np.asarray(back.p), np.asarray(atm.p))

    # mode 4: balloon track linear interp + clamped ends
    track = tmp_path / "balloon.tab"
    track.write_text("# t p\n0 500\n6000 400\n12000 300\n")
    ctl4 = read_ctl(None, ["NQ", "0", "METBASE", "-", "T_STOP", "86400",
                           "ISOSURF", "4", "BALLOON", str(track)])
    cache4 = module_isosurf_init(ctl4, Cache.zeros(n, iso_nmax=3),
                                 met01, atm)
    out = module_isosurf(ctl4, cache4, met01, atm)  # t=3000 -> 450 hPa
    np.testing.assert_allclose(np.asarray(out.p), 450.0)
    late = atm.replace(time=jnp.full(n, 99999.0))
    out2 = module_isosurf(ctl4, cache4, met01, late)  # clamp -> 300
    np.testing.assert_allclose(np.asarray(out2.p), 300.0)
