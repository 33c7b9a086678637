#!/usr/bin/env python3
"""Benchmark: parcel-steps/s/chip for the full timestep pipeline.

Runs the flagship configuration (solid-body wind on an ERA-Interim-size
global grid; advection + turbulent + mesoscale diffusion + decay) for a
number of timed steps and prints ONE JSON line:

    {"metric": "parcel_steps_per_s_per_chip", "value": N,
     "unit": "parcel-steps/s", "vs_baseline": R}

Baseline: the reference's profiling example implies ~8.6e6
parcel-steps/s for MODULE_ADVECT on a 4-thread CPU
(/root/reference/docs/manual/profiling.md:60; BASELINE.md).

Default uses the packed-gather f32 interpolation fast path; --exact
switches to the reference-parity f64 path.
"""

import argparse
import json
import os
import sys
import time


BASELINE_PARCEL_STEPS_S = 8.6e6


def main():
    # stdout carries exactly ONE JSON line for the driver; route the
    # framework's leveled log (LOGLEV) off unless explicitly requested
    os.environ.setdefault("LOGLEV", "0")
    ap = argparse.ArgumentParser()
    ap.add_argument("--np", type=int, dest="n_parcels",
                    default=int(os.environ.get("BENCH_NP", 100_000_000)))
    ap.add_argument("--steps", type=int,
                    default=int(os.environ.get("BENCH_STEPS", 20)))
    ap.add_argument("--nx", type=int, default=360)
    ap.add_argument("--ny", type=int, default=181)
    ap.add_argument("--nz", type=int, default=61)
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU backend")
    ap.add_argument("--exact", action="store_true",
                    help="reference-parity f64 interpolation instead of "
                         "the packed f32 fast path")
    ap.add_argument("--pack8", action="store_true",
                    help="use the 8-wide packed wind table (8 gather "
                         "offsets/parcel) instead of the 64-wide "
                         "corner table (1 offset/parcel); 8x less "
                         "table memory, ~8x slower gathers")
    ap.add_argument("--fp32", action="store_true", default=True,
                    help="float32 compute mode (positions/quantities/"
                         "met axes; time stays float64; default, see "
                         "--f64)")
    ap.add_argument("--f64", dest="fp32", action="store_false",
                    help="float64 compute mode (reference parity)")
    ap.add_argument("--phys", default=os.environ.get("BENCH_PHYS",
                                                      "base"),
                    choices=["base", "conv", "chem", "full"],
                    help="physics ladder config (BASELINE.md): conv "
                         "adds convection; chem adds OH/H2O2 "
                         "chemistry + wet/dry deposition")
    ap.add_argument("--scan", type=int,
                    default=int(os.environ.get("BENCH_SCAN", 10)),
                    metavar="K",
                    help="advance K timesteps per device dispatch "
                         "(lax.scan) instead of one")
    ap.add_argument("--dd", type=int, default=0, metavar="N",
                    help="measure domain-decomposition scaling over N "
                         "devices (virtual CPU devices if fewer real "
                         "ones); prints dd_scaling_efficiency")
    args = ap.parse_args()

    if args.dd and args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.dd}")
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from mptrac_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    if args.dd:
        return bench_dd(args)

    import __graft_entry__ as g
    from mptrac_tpu.physics import pipeline

    def phase(msg, _t=[time.time()]):
        now = time.time()
        print(f"[bench +{now - _t[0]:7.1f}s] {msg}", file=sys.stderr,
              flush=True)
        _t[0] = now

    phase("imports done")
    # OOM resilience: if the requested size does not fit HBM, halve
    # and retry so a result is always reported (the JSON carries the
    # achieved n_parcels)
    for attempt in range(3):
        try:
            return run_flagship(args, g, pipeline, jnp, jax, phase)
        except Exception as exc:
            msg = str(exc)
            if ("RESOURCE_EXHAUSTED" not in msg
                    and "out of memory" not in msg.lower()
                    and "Allocation" not in msg):
                raise
            if os.environ.get("BENCH_OOM_DEBUG"):
                keep = [ln for ln in msg.splitlines()
                        if not ln.startswith("[2m")]
                print("\n".join(keep)[:6000], file=sys.stderr,
                      flush=True)
            args.n_parcels //= 2
            args._oom_retries = attempt + 1
            phase(f"OOM — LOUD FAILURE at {args.n_parcels * 2} "
                  f"parcels; retrying at {args.n_parcels} (the JSON "
                  "will carry oom_retries)")
    raise SystemExit("bench failed: persistent OOM")


def run_flagship(args, g, pipeline, jnp, jax, phase):
    import time

    ctl, clim, met01, atm, cache = g._make_setup(
        args.n_parcels, nx=args.nx, ny=args.ny, nz=args.nz,
        phys=args.phys)
    phase("setup built")
    if args.fp32:
        from mptrac_tpu.types import astype_state
        atm, cache, met01, clim = astype_state(atm, cache, met01, clim)
    # Device residency for the small constants (met, clim).  The
    # parcel state is NOT device_put — the copy would transiently
    # double ~10 GB at 100M parcels; it is donated into the step
    # instead.
    met01, clim = jax.device_put((met01, clim))

    pack = None
    if not args.exact:
        from mptrac_tpu.ops.fast_interp import (MetPack,
                                                build_advect_pack,
                                                build_met_pack)
        if args.pack8:
            pack = MetPack(w64=jax.jit(build_advect_pack)(met01))
        else:
            pack = jax.jit(build_met_pack)(met01)
        jax.block_until_ready(jax.tree.leaves(pack))
        phase("met pack built")

    def fetch(a, c):
        jax.block_until_ready((a, c))

    if args.scan > 1:
        # donate atm/cache so the 100M-parcel state is updated in
        # place (in+out copies would not fit HBM)
        ctl_scan = ctl

        def _scan_fn(met01, a, c, ts, pack=None):
            from mptrac_tpu.physics.pipeline import run_timestep

            def body(carry, t):
                aa, cc = carry
                aa, cc = run_timestep(ctl_scan, clim, met01, aa, cc, t,
                                      pipeline.StepFlags(),
                                      pack)
                return (aa, cc), None

            (a, c), _ = jax.lax.scan(body, (a, c), ts)
            return a, c

        scan = jax.jit(_scan_fn, donate_argnums=(1, 2))
        k = args.scan

        def step_block(a, c, i0):
            ts = (jnp.arange(k, dtype=jnp.float64) + i0 + 1) \
                * ctl.dt_mod
            if pack is not None:
                return scan(met01, a, c, ts, pack)
            return scan(met01, a, c, ts)

        t_compile0 = time.time()
        a, c = step_block(atm, cache, 0)
        fetch(a, c)
        # second warmup block: the first post-compile execution pays
        # one-time runtime costs (allocator growth, executable upload)
        a, c = step_block(a, c, k)
        fetch(a, c)
        compile_warmup_s = time.time() - t_compile0
        phase("compile + warmup (scan path)")
        nblocks = max(1, args.steps // k)
        block_t = []
        for b in range(nblocks):
            tb = time.time()
            a, c = step_block(a, c, (b + 2) * k)
            fetch(a, c)
            block_t.append(time.time() - tb)
        dt = sum(block_t)
        phase(f"timed {nblocks} blocks x {k} steps: "
              + " ".join(f"{x:.2f}s" for x in block_t))
        rate = args.n_parcels * nblocks * k / dt
    else:
        step = jax.jit(
            lambda m, a, c, t, p: pipeline.run_timestep(
                ctl, clim, m, a, c, t, pack=p))

        # Warmup / compile
        t = jnp.asarray(ctl.dt_mod, jnp.float64)
        a, c = step(met01, atm, cache, t, pack)
        fetch(a, c)

        t0 = time.time()
        for i in range(args.steps):
            t = jnp.asarray((i + 2) * ctl.dt_mod, jnp.float64)
            a, c = step(met01, a, c, t, pack)
        fetch(a, c)
        dt = time.time() - t0
        rate = args.n_parcels * args.steps / dt
    n_dev = jax.local_device_count()
    result = {
        "metric": "parcel_steps_per_s_per_chip",
        "value": rate / n_dev,
        "unit": "parcel-steps/s",
        "vs_baseline": rate / n_dev / BASELINE_PARCEL_STEPS_S,
        "n_parcels": args.n_parcels,
    }
    if getattr(args, "_oom_retries", 0):
        result["oom_retries"] = args._oom_retries
    if args.scan > 1:
        # compile-diet tracking (VERDICT r4 item 9): trace+lower+
        # compile + 2 warmup blocks, wall seconds
        result["compile_warmup_s"] = round(compile_warmup_s, 1)
    if args.phys != "base":
        result["metric"] += f"_{args.phys}"
    print(json.dumps(result))
    return 0


def bench_dd(args):
    """Scaling: rate of the domain-decomposed N-device step vs N x the
    plain single-device rate (the north-star >=80% efficiency metric).

    The reference's analog is the dd_test MPI scaling runs
    (/root/reference/projects/dd/); here the parcel migration rides
    jax.lax.all_to_all instead of MPI_Alltoallv."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__ as g
    from mptrac_tpu.parallel import dd as ddm
    from mptrac_tpu.parallel import mesh as pmesh
    from mptrac_tpu.physics import pipeline

    ndev = args.dd
    n = args.n_parcels - args.n_parcels % ndev
    ctl, clim, met01, atm, cache = g._make_setup(
        n, nx=args.nx, ny=args.ny, nz=args.nz)
    ctl = ctl.replace(diffusion=0, tdec_trop=0.0, tdec_strat=0.0)

    # --- single-device reference rate (same physics, no dd)
    dev0 = jax.devices()[0]
    atm0 = jax.device_put(atm, dev0)
    cache0 = jax.device_put(cache, dev0)
    met0d = jax.device_put(met01, dev0)
    step1 = jax.jit(
        lambda m, a, c, t: pipeline.run_timestep(ctl, clim, m, a, c, t))
    t = jnp.asarray(180.0, jnp.float64)
    a, c = step1(met0d, atm0, cache0, t)
    jax.block_until_ready(a.lon)
    t0 = time.time()
    for i in range(args.steps):
        a, c = step1(met0d, a, c, jnp.asarray((i + 2) * 180.0))
    jax.block_until_ready(a.lon)
    rate1 = n * args.steps / (time.time() - t0)

    # --- N-device domain-decomposed rate
    n_merid = 2 if ndev % 2 == 0 else 1
    ctl_dd = ctl.replace(dd=1, dd_subdomains_zonal=ndev // n_merid,
                         dd_subdomains_meridional=n_merid,
                         dd_halos_size=4)
    dd = ddm.plan_decomposition(
        ctl_dd, jax.tree.map(lambda x: x[0], met01), ndev=ndev)
    mesh_dd = pmesh.make_mesh(ndev, axis="sub")
    tiles = ddm.make_tiles(dd, met01)
    lat_axis = np.asarray(met01.lat[0])
    npmax_dev = max(256, 2 * n // ndev)
    atm_d, cache_d = ddm.scatter_parcels(dd, atm, npmax_dev, lat_axis)
    dstep = ddm.make_dd_step(ctl_dd, clim, dd, mesh_dd, npmax_dev,
                             exch_cap=max(64, npmax_dev // 8),
                             lat_axis=lat_axis)
    atm_d, cache_d, _, _ = dstep(tiles, atm_d, cache_d, t)
    jax.block_until_ready(atm_d.lon)
    t0 = time.time()
    overflow_tot = lost_tot = 0
    for i in range(args.steps):
        atm_d, cache_d, ovf, lost = dstep(tiles, atm_d, cache_d,
                                          jnp.asarray((i + 2) * 180.0))
        overflow_tot += int(jnp.sum(ovf))
        lost_tot += int(jnp.sum(lost))
    jax.block_until_ready(atm_d.lon)
    full_s = (time.time() - t0) / args.steps
    rate_n = n / full_s

    # --- Decomposition: physics-only step (exchange=False); the delta
    # --- attributes the all_to_all + bucket/compaction overhead, and
    # --- its third output counts would-migrate parcels per step
    pstep = ddm.make_dd_step(ctl_dd, clim, dd, mesh_dd, npmax_dev,
                             exch_cap=max(64, npmax_dev // 8),
                             lat_axis=lat_axis, exchange=False)
    tnext = jnp.asarray((args.steps + 2) * 180.0)
    a2, c2, mig, _ = pstep(tiles, atm_d, cache_d, tnext)
    migrated = int(jnp.sum(mig))
    jax.block_until_ready(a2.lon)
    t0 = time.time()
    for i in range(args.steps):
        a2, c2, _, _ = pstep(tiles, a2, c2,
                             jnp.asarray((args.steps + 3 + i) * 180.0))
    jax.block_until_ready(a2.lon)
    phys_s = (time.time() - t0) / args.steps

    result = {
        "metric": "dd_scaling_efficiency",
        "value": rate_n / (ndev * rate1),
        "unit": f"rate({ndev} dev) / ({ndev} x rate(1 dev))",
        "vs_baseline": rate_n / (ndev * rate1) / 0.8,
        "rate_1dev": rate1,
        "rate_ndev": rate_n,
        "step_ms_full": full_s * 1e3,
        "step_ms_physics": phys_s * 1e3,
        "step_ms_comm_compact": (full_s - phys_s) * 1e3,
        "migrated_per_step": migrated,
        "overflow": overflow_tot,
        "lost": lost_tot,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
