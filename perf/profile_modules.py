#!/usr/bin/env python3
"""Per-module timing breakdown of the bench pipeline on the current
backend (the analog of the reference's SELECT_TIMER report,
/root/reference/docs/manual/profiling.md:40-80).

Each module is jitted and timed in isolation at bench shapes, plus
micro-benchmarks of the primitive costs (RNG draw, locate, packed
gather) so regressions can be attributed.

Usage: python perf/profile_modules.py [--np N] [--nx 360 --ny 181 --nz 61]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def timeit(fn, *args, n=10, **kw):
    import jax
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3  # ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--np", type=int, dest="n", default=2_000_000)
    ap.add_argument("--nx", type=int, default=360)
    ap.add_argument("--ny", type=int, default=181)
    ap.add_argument("--nz", type=int, default=61)
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mptrac_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    import __graft_entry__ as g
    from mptrac_tpu.ops import interp
    from mptrac_tpu.ops.fast_interp import build_met_pack
    from mptrac_tpu.ops.rng import module_rng
    from mptrac_tpu.physics import (advect, decay, diffusion, position,
                                    timesteps)
    from mptrac_tpu.physics import pipeline

    n = args.n
    ctl, clim, met01, atm, cache = g._make_setup(
        n, nx=args.nx, ny=args.ny, nz=args.nz)
    if not args.f64:
        from mptrac_tpu.types import astype_state
        atm, cache, met01, clim = astype_state(atm, cache, met01, clim)
    met01, atm, cache, clim = jax.device_put((met01, atm, cache, clim))
    pack = jax.jit(build_met_pack)(met01)
    jax.block_until_ready(pack)
    t = jnp.asarray(180.0, jnp.float64)
    print(f"backend={jax.default_backend()} n={n} "
          f"grid={args.nx}x{args.ny}x{args.nz} "
          f"dtype={'f64' if args.f64 else 'f32'}")

    # Prime cache.dt (timesteps) so physics modules act on active parcels
    cache = jax.jit(lambda c, a, m: timesteps.module_timesteps(
        ctl, c, m, a, t))(cache, atm, met01)
    jax.block_until_ready(cache.dt)

    dt_ms = {}
    dt_ms["timesteps"] = timeit(
        jax.jit(lambda c, a, m: timesteps.module_timesteps(
            ctl, c, m, a, t)), cache, atm, met01)
    dt_ms["position"] = timeit(
        jax.jit(lambda c, a, m, s: position.module_position(
            c, m, a, s)), cache, atm, met01, pack.sfc)
    dt_ms["advect_pack64"] = timeit(
        jax.jit(lambda c, a, m, w: advect.module_advect(
            ctl, c, m, a, w)), cache, atm, met01, pack.w64)
    dt_ms["advect_nopack"] = timeit(
        jax.jit(lambda c, a, m: advect.module_advect(
            ctl, c, m, a, None)), cache, atm, met01)
    dt_ms["diff_turb"] = timeit(
        jax.jit(lambda c, a, m, s: diffusion.module_diff_turb(
            ctl, c, clim, m, a, s)), cache, atm, met01, pack.sfc)
    dt_ms["diff_meso"] = timeit(
        jax.jit(lambda c, a, m, w: diffusion.module_diff_meso(
            ctl, c, m, a, w)), cache, atm, met01, pack.w64)
    dt_ms["decay"] = timeit(
        jax.jit(lambda c, a: decay.module_decay(ctl, c, clim, a)),
        cache, atm)
    dt_ms["full_step"] = timeit(
        jax.jit(lambda m, a, c, p: pipeline.run_timestep(
            ctl, clim, m, a, c, t, pack=p)), met01, atm, cache, pack)

    # --- primitive micro-benchmarks
    dtype = atm.lon.dtype
    dt_ms["rng_normal_3n"] = timeit(
        jax.jit(lambda ctr: module_rng(1, ctr, 3 * n, 1, dtype=dtype)),
        cache.rng_ctr)
    dt_ms["rng_threefry_3n"] = timeit(
        jax.jit(lambda ctr: module_rng(2, ctr, 3 * n, 1, dtype=dtype)),
        cache.rng_ctr)
    dt_ms["locate_3d"] = timeit(
        jax.jit(lambda a, m: interp.locate_3d(m, a.lon, a.lat, a.p)),
        atm, met01)
    loc = jax.jit(lambda a, m: interp.locate_3d(
        m, a.lon, a.lat, a.p))(atm, met01)
    jax.block_until_ready(loc)
    ny, npl = args.ny, args.nz
    base = (loc.ix * ny + loc.iy) * npl + loc.iz

    dt_ms["gather64_2M"] = timeit(
        jax.jit(lambda w, b: jnp.take(w, b, axis=0).sum(axis=1)),
        pack.w64, base)
    # gather on SORTED offsets (the module_sort payoff)
    base_sorted = jnp.sort(base)
    dt_ms["gather64_sorted"] = timeit(
        jax.jit(lambda w, b: jnp.take(w, b, axis=0).sum(axis=1)),
        pack.w64, base_sorted)
    dt_ms["gather_sfc"] = timeit(
        jax.jit(lambda s, b: jnp.take(s, b, axis=0).sum(axis=1)),
        pack.sfc, loc.ix * ny + loc.iy)

    total = sum(v for k, v in dt_ms.items()
                if k in ("timesteps", "position", "advect_pack64",
                         "diff_turb", "diff_meso", "decay"))
    print(f"{'module':<18} {'ms':>10} {'Mp/s':>10}")
    for k, v in dt_ms.items():
        print(f"{k:<18} {v:>10.2f} {n / v / 1e3:>10.1f}")
    print(f"{'sum(modules)':<18} {total:>10.2f} {n / total / 1e3:>10.1f}")


if __name__ == "__main__":
    main()
