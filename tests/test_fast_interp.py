"""The packed-table fast path (ops.fast_interp, TPU_FAST 1) must match
the exact path: to float32 interpolation tolerance where the tables
interpolate in f32, and to rounding where both do the same arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mptrac_tpu import read_ctl, stack_met
from mptrac_tpu.climatology import read_clim
from mptrac_tpu.met.synthetic import make_wind_met
from mptrac_tpu.ops.fast_interp import build_advect_pack, build_met_pack
from mptrac_tpu.physics import diffusion, meteo, pipeline
from mptrac_tpu.types import Atm, Cache, astype_state


def _met(seed=None, nx=36, ny=19, nz=8):
    """Synthetic met pair; with ``seed``, T, pbl, ps and pt vary in
    space and time so the tables have something to interpolate."""
    met0 = make_wind_met(t0=0.0, alpha=30.0, nx=nx, ny=ny, nz=nz)
    met1 = make_wind_met(t0=3600.0, alpha=30.0, nx=nx, ny=ny, nz=nz)
    met01 = stack_met(met0, met1)
    if seed is None:
        return met01
    rng = np.random.default_rng(seed)

    def noisy(f, scale):
        return f + jnp.asarray(rng.normal(0, scale, f.shape), f.dtype)

    f2 = dict(met01.fields2d)
    f2["pbl"] = noisy(f2["pbl"], 20.0)
    f2["ps"] = noisy(f2["ps"], 5.0)
    f2["pt"] = noisy(f2["pt"], 10.0)
    f3 = dict(met01.fields3d)
    f3["t"] = noisy(f3["t"], 5.0)
    return met01.replace(fields2d=f2, fields3d=f3)


def _atm(n, seed, qnt=()):
    rng = np.random.default_rng(seed)
    atm = Atm.zeros(n, qnt)
    return atm.replace(
        time=jnp.asarray(rng.uniform(0, 3600, n)),
        lon=jnp.asarray(rng.uniform(-180, 180, n)),
        lat=jnp.asarray(rng.uniform(-75, 75, n)),
        p=jnp.asarray(rng.uniform(200, 900, n)),
        np=jnp.asarray(n, jnp.int32))


def _active_cache(n, dtype=jnp.float64):
    return Cache.zeros(n, dtype).replace(dt=jnp.full(n, 180.0, dtype))


@pytest.mark.parametrize("advect", [1, 2, 4])
def test_fast_advect_matches_exact(advect):
    ctl = read_ctl(None, [
        "NQ", "0", "METBASE", "-", "DIFFUSION", "0",
        "ADVECT", str(advect), "MET_DT_OUT", "0", "T_STOP", "86400",
        "DT_MOD", "1200"]).replace(t_start=0.0, t_stop=36 * 1200.0)
    clim = read_clim(ctl)
    met01 = stack_met(make_wind_met(t0=0.0, alpha=30.0, nx=90, ny=46,
                                    nz=12),
                      make_wind_met(t0=86400.0, alpha=30.0, nx=90,
                                    ny=46, nz=12))
    pack = build_advect_pack(met01)

    n = 300
    atm0 = _atm(n, 11).replace(time=jnp.zeros(n))

    step_exact = jax.jit(lambda m, a, c, t: pipeline.run_timestep(
        ctl, clim, m, a, c, t))
    step_fast = jax.jit(lambda m, a, c, t: pipeline.run_timestep(
        ctl, clim, m, a, c, t, pack=pack))

    ae, af = atm0, atm0
    ce, cf = Cache.zeros(n), Cache.zeros(n)
    for i in range(1, 37):
        t = jnp.asarray(i * 1200.0)
        ae, ce = step_exact(met01, ae, ce, t)
        af, cf = step_fast(met01, af, cf, t)

    # 12 hours of advection: f32 interp noise accumulates ~1e-4 deg
    dlon = np.abs((np.asarray(af.lon) - np.asarray(ae.lon) + 180)
                  % 360 - 180)
    dlat = np.abs(np.asarray(af.lat) - np.asarray(ae.lat))
    assert dlon.max() < 5e-3
    assert dlat.max() < 5e-3
    np.testing.assert_allclose(np.asarray(af.p), np.asarray(ae.p),
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_meso_sigma_w64_matches_exact(dtype):
    """The 16-point subgrid variance read from one 64-wide row equals
    the exact path's 16 gathers: same f32 values, same summation
    order."""
    ctl = read_ctl(None, ["NQ", "0", "METBASE", "-", "DIFFUSION", "1",
                          "TURB_MESOX", "0.16", "TURB_MESOZ", "0.16"])
    met01 = _met()
    w64 = build_met_pack(met01).w64
    n = 500
    atm, cache = _atm(n, 3), _active_cache(n)
    if dtype == jnp.float32:
        atm, cache, met01 = astype_state(atm, cache, met01)
    meso = jax.jit(lambda a, c, m, w: diffusion.module_diff_meso(
        ctl, c, m, a, w))
    ae, ce = meso(atm, cache, met01, None)
    af, cf = meso(atm, cache, met01, w64)
    assert float(jnp.max(jnp.abs(ce.uvwp))) > 0
    np.testing.assert_allclose(np.asarray(cf.uvwp), np.asarray(ce.uvwp),
                               rtol=1e-6, atol=0)
    for f in ("lon", "lat", "p"):
        np.testing.assert_allclose(np.asarray(getattr(af, f)),
                                   np.asarray(getattr(ae, f)),
                                   rtol=1e-6, atol=0)
    assert int(cf.rng_ctr) == int(ce.rng_ctr)


def test_diff_turb_sfc_pack_matches_exact():
    """pbl and ps from the surface pack drive the PBL/troposphere
    blending exactly as the exact 2-D interpolation does."""
    ctl = read_ctl(None, ["NQ", "0", "METBASE", "-", "DIFFUSION", "1",
                          "TURB_DX_PBL", "50", "TURB_DZ_PBL", "1",
                          "TURB_DX_TROP", "50", "TURB_DZ_TROP", "0.5",
                          "TURB_DZ_STRAT", "0.1"])
    clim = read_clim(ctl)
    met01 = _met(seed=4)
    sfc = build_met_pack(met01).sfc
    n = 500
    atm = _atm(n, 5).replace(
        p=jnp.asarray(np.random.default_rng(6).uniform(700, 1010, n)))
    cache = _active_cache(n)
    turb = jax.jit(lambda a, c, m, s: diffusion.module_diff_turb(
        ctl, c, clim, m, a, s))
    ae, _ = turb(atm, cache, met01, None)
    af, _ = turb(atm, cache, met01, sfc)
    assert float(jnp.max(jnp.abs(ae.p - atm.p))) > 0
    for f in ("lon", "lat", "p"):
        np.testing.assert_allclose(np.asarray(getattr(af, f)),
                                   np.asarray(getattr(ae, f)),
                                   rtol=1e-12, atol=0)


def test_module_meteo_pack_matches_exact():
    """Temperature from lanes 48-63 of the corner table (f32 math) and
    surface fields from the surface pack match the exact path."""
    names = ("t", "theta", "ps", "pbl", "pt")
    args = ["NQ", str(len(names)), "METBASE", "-"]
    for i, q in enumerate(names):
        args += [f"QNT_NAME[{i}]", q]
    ctl = read_ctl(None, args)
    clim = read_clim(ctl)
    met01 = _met(seed=7)
    pack = jax.jit(build_met_pack)(met01)
    atm, cache = _atm(400, 8, ctl.qnt_name), _active_cache(400)
    run = jax.jit(lambda a, m, p: meteo.module_meteo(
        ctl, cache, clim, m, a, p))
    qe = run(atm, met01, None).q
    qf = run(atm, met01, pack).q
    for q in ("t", "theta"):
        np.testing.assert_allclose(np.asarray(qf[q]), np.asarray(qe[q]),
                                   rtol=1e-5)
    for q in ("ps", "pbl", "pt"):
        np.testing.assert_allclose(np.asarray(qf[q]), np.asarray(qe[q]),
                                   rtol=1e-12)
