"""fp32 compute mode: dtype stability through the pipeline and
accuracy vs the float64 reference path (framework extension — the
reference model is double-only; fp32 halves the bytes every gather
moves)."""

import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__ as g
from mptrac_tpu.ops.fast_interp import build_advect_pack
from mptrac_tpu.physics import pipeline
from mptrac_tpu.types import astype_state


def test_fp32_pipeline_stable_and_accurate():
    ctl, clim, met01, atm, cache = g._make_setup(4000)
    # pathwise comparison needs deterministic physics: the fp32
    # diffusion path draws a different (component-major) Squares
    # stream by design (ops.rng.squares_normal3_f32), so compare
    # deterministic modules only
    ctl = ctl.replace(diffusion=0)
    a32, c32, m32 = astype_state(atm, cache, met01)
    assert a32.lon.dtype == jnp.float32
    assert a32.time.dtype == jnp.float64          # jsec stays f64
    assert c32.dt.dtype == jnp.float32

    pack32 = build_advect_pack(m32)
    pack64 = build_advect_pack(met01)
    step = jax.jit(lambda m, a, c, t, p: pipeline.run_timestep(
        ctl, clim, m, a, c, t, pack=p))

    a, c = a32, c32
    a64, c64 = atm, cache
    for i in range(6):
        t = jnp.asarray((i + 1) * 180.0)
        a, c = step(m32, a, c, t, pack32)
        a64, c64 = step(met01, a64, c64, t, pack64)

    # no dtype creep through 6 full steps
    assert a.lon.dtype == jnp.float32
    assert a.p.dtype == jnp.float32
    assert a.q["m"].dtype == jnp.float32
    assert c.dt.dtype == jnp.float32

    # same trajectories to f32 rounding
    dlon = np.abs(np.asarray(a.lon, np.float64) - np.asarray(a64.lon))
    assert dlon.max() < 1e-3
    dm = np.abs(np.asarray(a.q["m"], np.float64)
                / np.asarray(a64.q["m"]) - 1)
    assert dm.max() < 1e-5


def test_fp32_diffusion_statistics():
    """fp32 diffusion uses its own Squares stream; trajectories are not
    pathwise-equal to f64 but the ensemble statistics must match: after
    several diffusion-dominated steps the parcel displacement mean and
    stddev agree within sampling error."""
    ctl, clim, met01, atm, cache = g._make_setup(20000)
    ctl = ctl.replace(advect=0, tdec_trop=0.0, tdec_strat=0.0)
    a32, c32, m32 = astype_state(atm, cache, met01)

    step = jax.jit(lambda m, a, c, t: pipeline.run_timestep(
        ctl, clim, m, a, c, t))
    a, c = a32, c32
    a64, c64 = atm, cache
    for i in range(4):
        t = jnp.asarray((i + 1) * 180.0)
        a, c = step(m32, a, c, t)
        a64, c64 = step(met01, a64, c64, t)

    for name in ("lon", "lat", "p"):
        d32 = np.asarray(getattr(a, name), np.float64) \
            - np.asarray(getattr(a32, name), np.float64)
        d64 = np.asarray(getattr(a64, name)) - np.asarray(
            getattr(atm, name))
        # displacement distributions match (mean ~ 0, same spread)
        s32, s64 = d32.std(), d64.std()
        assert s64 > 0
        assert abs(s32 - s64) / s64 < 0.05, (name, s32, s64)
        assert abs(d32.mean()) < 5 * s32 / np.sqrt(d32.size) + 1e-12


def test_rng3_component_major_stream():
    """module_rng3 fp32: deterministic, counter advance 3n+1, unit
    normal statistics per component, and rows decorrelated."""
    from mptrac_tpu.ops.rng import module_rng3
    n = 50000
    ctr = jnp.uint64(7)
    rs, ctr2 = module_rng3(1, ctr, n, dtype=jnp.float32)
    assert rs.shape == (3, n) and rs.dtype == jnp.float32
    assert int(ctr2) == 7 + 3 * n + 1
    rs_b, _ = module_rng3(1, ctr, n, dtype=jnp.float32)
    assert np.array_equal(np.asarray(rs), np.asarray(rs_b))
    x = np.asarray(rs, np.float64)
    assert np.all(np.abs(x.mean(axis=1)) < 0.02)
    assert np.all(np.abs(x.std(axis=1) - 1) < 0.02)
    corr = np.corrcoef(x)
    assert np.all(np.abs(corr - np.eye(3)) < 0.02)
    # different counters give a different stream
    rs_c, _ = module_rng3(1, ctr2, n, dtype=jnp.float32)
    assert not np.array_equal(np.asarray(rs), np.asarray(rs_c))
