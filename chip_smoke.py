#!/usr/bin/env python3
"""Smoke run of the production path on the GPU.

    python chip_smoke.py              phases 1-4 on one GPU
    python chip_smoke.py --chips 4    phase 5 only, on four GPUs
    python chip_smoke.py --rehearse   every phase at a tiny size on the
                                      CPU (4 virtual devices); exits 3
                                      and prints no result

Phases:

1. Device: the card's name and power limit from nvidia-smi; JAX must
   find a GPU (there is no CPU fallback).
2. RNG: the Squares stream drawn on the card is bit-identical to the
   CPU stream and the golden doubles (chip test in tests/test_rng.py).
3. Main path: ``mptrac_tpu.tools.trac.main`` in this process, on 1-degree
   global synthetic solid-body met (360x181x61 pressure levels, four
   hourly netCDF files, so MetBuffer swaps twice), 10^7 parcels,
   DT_MOD 180 and the base physics ladder (advection, turbulent and
   mesoscale diffusion, decay), atm output at start and end; once with
   TPU_FAST 0 (exact f64 interpolation) and once with TPU_FAST 1
   (packed f32 tables).  Checks: the fast path against the exact path
   at DIFFUSION 0, and the card against a CPU child process (the plain
   reference) at 10^5 parcels with diffusion on.
4. Golden parity: parity/golden_zeta through run_trac on the card
   (chip tests in tests/test_zeta_parity.py).  The golden_chem set is
   not run: it fails on the CPU as well, for want of the OH
   climatology file its control file names.
5. Four cards (``--chips 4``): domain decomposition (parallel.dd) on a
   2x2 ``sub`` mesh at 1 degree with 10^7 parcels for 20 steps against
   the one-card run of the same physics, and the ``dp``-sharded step
   (parallel.mesh) against one card.

Files go under data/scratch/chip_smoke/ and a summary to
chiprun_out/chip_smoke*.json.  A failed phase raises: the script then
exits non-zero and prints no result line.  The last line of stdout is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "data" / "scratch" / "chip_smoke"
SEED = 0

#: (nx, ny, nz, parcels, reference parcels, DD parcels)
FULL = dict(nx=360, ny=181, nz=61, n=10_000_000, n_ref=100_000,
            n_dd=10_000_000)
TINY = dict(nx=36, ny=19, nz=8, n=2_000, n_ref=500, n_dd=4_000)

HOURS = 3           # model hours: met files 00..03, two MetBuffer swaps
DD_STEPS = 20

#: fast (f32 tables) vs exact (f64) path, DIFFUSION 0: the tolerance
#: of tests/test_fast_interp.py (f32 interpolation noise)
FAST_DEG, FAST_P_RTOL = 5e-3, 1e-4
#: Card vs CPU, same program, 10^5 parcels, diffusion on.  The Squares
#: stream is bit-identical (phase 2), so differences come only from the
#: two libms and from FMA contraction, which the GPU applies to f32
#: multiply-adds.  Two cases, (label, ctl lines, {TPU_FAST: (deg, p
#: rtol)}):
#: - mesoscale diffusion off: exact path to 1e-6 deg (f64
#:   interpolation); packed path to 1e-5 deg: one f32 ulp of an
#:   interpolated wind (~4e-6 m/s) moves a parcel ~7e-4 m per 180 s
#:   step, ~4e-7 deg over 60 steps, and 1e-5 keeps a factor ~20.
#:   Pressure to 1e-8, not 1e-9: the well-mixed drift term is a
#:   centred difference of kz over +-10 m (reference c:4643-4726),
#:   which divides last-bit differences of the PBL and tropopause
#:   weights by 20 m; the H100 read 8.5e-10 over 60 steps.
#: - all diffusion on (the base ladder): the mesoscale sigma is the f32
#:   variance E[u^2] - E[u]^2 of 16 winds of ~38 m/s (reference
#:   c:4280-4304), whose cancellation leaves an absolute error of a
#:   few ulp(E[u^2]) ~ 2.4e-4 (m/s)^2: the card's fused multiply-adds
#:   change sigma by up to sqrt(2.4e-4) ~ 0.016 m/s where the variance
#:   is small.  Through TURB_MESOX 0.16, |rs| <= 4.5, sqrt(1-r^2) =
#:   0.44 and the AR(1) memory (1/(1-r) = 10 steps) that is <= 0.05 m/s,
#:   <= 540 m over 60 steps of 180 s: 5e-3 deg, the bound the f32
#:   tables are held to.  Pressure moves only through the tropopause
#:   weight of the displaced latitude: 1e-6.
REF_CASES = (
    ("mesoscale diffusion off", "TURB_MESOX = 0\nTURB_MESOZ = 0\n",
     {0: (1e-6, 1e-8), 1: (1e-5, 1e-8)}),
    ("all diffusion on", "", {0: (5e-3, 1e-6), 1: (5e-3, 1e-6)}),
)
#: DD and dp-sharded runs against one card: the claim in README.md
DD_ATOL = 1e-9


def say(msg):
    print(msg, flush=True)


def card_info():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return [f"nvidia-smi not available ({type(exc).__name__})"]
    return out.splitlines()


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling."""

    def __init__(self, jax):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, secs, **_):
        if event.startswith("/jax/core/compile/"):
            self.total += secs


def peak_bytes(jax):
    stats = jax.local_devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ------------------------------------------------------------- set-up

def write_met(size):
    """Hourly synthetic solid-body met files (seeded by construction),
    written once per grid."""
    from mptrac_tpu.met.synthetic import make_wind_met
    from mptrac_tpu.met.write_nc import write_met_nc
    d = WORK / f"met_{size['nx']}x{size['ny']}x{size['nz']}"
    d.mkdir(parents=True, exist_ok=True)
    for h in range(HOURS + 1):
        fn = d / f"wind_2000_01_01_{h:02d}.nc"
        if not fn.exists():
            tmp = fn.with_suffix(".tmp")
            write_met_nc(str(tmp), make_wind_met(
                t0=3600.0 * h, nx=size["nx"], ny=size["ny"],
                nz=size["nz"], alpha=30.0), drop_wrap_column=True)
            tmp.rename(fn)
    return d / "wind"


CTL = """NQ = 2
QNT_NAME[0] = t
QNT_NAME[1] = m
METBASE = {metbase}
DT_MET = 3600
MET_TROPO = 0
MET_CAPE = 0
DT_MOD = 180
DIFFUSION = 1
TDEC_TROP = 259200
TDEC_STRAT = 259200
T_STOP = {t_stop}
ATM_TYPE = 1
ATM_TYPE_OUT = 1
ATM_BASENAME = atm
ATM_DT_OUT = {t_stop}
TPU_FAST = {fast}
"""


def make_run(name, metbase, n, fast, extra=""):
    """A run directory: control file (the base ladder of bench.py,
    without tropopause and CAPE diagnostics, which it does not use)
    and a seeded binary atm file of ``n`` parcels."""
    import numpy as np

    from mptrac_tpu import Atm, read_ctl
    from mptrac_tpu.io.atm_io import write_atm_bin
    d = WORK / name
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    (d / "trac.ctl").write_text(CTL.format(
        metbase=metbase, t_stop=3600 * HOURS, fast=fast) + extra)
    ctl = read_ctl(str(d / "trac.ctl"))
    rng = np.random.default_rng(SEED)
    atm = Atm(time=np.zeros(n), lon=rng.uniform(-180, 180, n),
              lat=rng.uniform(-60, 60, n), p=rng.uniform(200, 900, n),
              q={"t": np.zeros(n), "m": np.ones(n)}, np=np.int32(n))
    write_atm_bin(str(d / "init.bin"), ctl, atm)
    return d


def final_atm(d):
    """Positions of the last atm output of a run directory (host)."""
    import numpy as np
    path = sorted(d.glob("atm_*.bin"))[-1]
    with open(path, "rb") as f:
        head = np.frombuffer(f.read(8), "<i4")
        n = int(head[1])
        cols = np.frombuffer(f.read(8 * n * 4), "<f8").reshape(4, n)
    return path.name, dict(lon=cols[2], lat=cols[3], p=cols[1])


def compare(name, a, b, deg, p_rtol):
    import numpy as np
    dlon = np.abs((a["lon"] - b["lon"] + 180.0) % 360.0 - 180.0)
    dlat = np.abs(a["lat"] - b["lat"])
    rp = np.abs(a["p"] - b["p"]) / np.abs(b["p"])
    ok = (np.isfinite(a["lon"]).all() and np.isfinite(a["p"]).all()
          and dlon.max() <= deg and dlat.max() <= deg
          and rp.max() <= p_rtol)
    say(f"{name}: max|dlon| {dlon.max():.3e} deg, max|dlat| "
        f"{dlat.max():.3e} deg (tol {deg:g}), max rel dp {rp.max():.3e}"
        f" (tol {p_rtol:g}); f64 positions; {'PASS' if ok else 'FAIL'}")
    assert ok, name
    return dict(dlon=float(dlon.max()), dlat=float(dlat.max()),
                dp_rel=float(rp.max()), deg_tol=deg, p_rtol=p_rtol)


# ---------------------------------------------------------- phase 3

def run_cli(clock, d, *extra):
    """One ``trac`` CLI run in this process; returns its numbers and
    the Simulation it ran."""
    from mptrac_tpu import sim as sim_mod
    from mptrac_tpu.tools import trac

    sims = []
    orig = sim_mod.run_trac

    def capture(*a, **k):
        sims.append(orig(*a, **k))
        return sims[-1]

    (d / "dirlist").write_text(f"{d}\n")
    c0 = clock.total
    sim_mod.run_trac = capture
    t0 = time.perf_counter()
    try:
        rc = trac.main(["trac", str(d / "dirlist"), "trac.ctl",
                        "init.bin", *extra])
    finally:
        sim_mod.run_trac = orig
    wall = time.perf_counter() - t0
    assert rc == 0, f"trac exited {rc}"
    sim = sims[0]
    timers = {k: round(v["total"], 3)
              for k, v in sim.timers.as_dict().items()}
    return sim, dict(wall_s=round(wall, 3),
                     compile_s=round(clock.total - c0, 3),
                     timers_s=timers)


def scan_numbers(jax, sim):
    """compiled.memory_analysis() of the scanned step at the length
    of one met interval (reloaded from the compile cache), and the
    device seconds of one warm call of it on the final state."""
    import jax.numpy as jnp
    flags = next(iter(sim._scans))
    k = int(sim.ctl.dt_met // sim.ctl.dt_mod)
    args = [sim.metbuf.pair, sim.atm, sim.cache,
            jnp.arange(k, dtype=jnp.float64)]
    if sim._pack is not None:
        args.append(sim._pack)
    compiled = sim._scans[flags].lower(*args).compile()
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    out = {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(*args))
    out["steps"] = k
    out["warm_call_s"] = round(time.perf_counter() - t0, 4)
    return out


def start_cpu_reference(metbase, n_ref):
    """The plain reference: the same CLI on the CPU, in a child that
    never opens the card.  Returns (process, {(case, fast): run dir})."""
    dirs = {(c, fast): make_run(f"cpu_ref{c}_fast{fast}", metbase, n_ref,
                                fast, REF_CASES[c][1])
            for c in range(len(REF_CASES)) for fast in (0, 1)}
    dirlist = WORK / "cpu_ref.dirlist"
    dirlist.write_text("".join(f"{d}\n" for d in dirs.values()))
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT), LOGLEV="0")
    env.pop("MPTRAC_WORKERS", None)
    env.pop("XLA_FLAGS", None)
    log = open(WORK / "cpu_ref.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mptrac_tpu.tools.trac", str(dirlist),
         "trac.ctl", "init.bin"], cwd=ROOT, env=env, stdout=log,
        stderr=subprocess.STDOUT)
    log.close()
    return proc, dirs


def phase_main_path(jax, clock, size, summary):
    import numpy as np
    metbase = write_met(size)
    say(f"met: {HOURS + 1} hourly files, grid {size['nx']}x{size['ny']}"
        f"x{size['nz']} at {metbase.parent}")
    proc, cpu_dirs = start_cpu_reference(metbase, size["n_ref"])
    try:
        runs = {}
        for fast in (0, 1):
            d = make_run(f"base_fast{fast}", metbase, size["n"], fast)
            sim, res = run_cli(clock, d)
            res["peak_bytes_in_use"] = peak_bytes(jax)
            res["scanned_step"] = scan_numbers(jax, sim)
            res["parcel_steps"] = size["n"] * len(list(sim.times()))
            name, pos = final_atm(d)
            assert all(np.isfinite(v).all() for v in pos.values()), name
            del sim
            say(f"main path TPU_FAST {fast}: {size['n']} parcels, "
                f"{res['parcel_steps'] // size['n']} steps, wall "
                f"{res['wall_s']} s, compile {res['compile_s']} s, "
                f"peak_bytes_in_use {res['peak_bytes_in_use']} "
                "(process maximum so far)")
            say(f"  timers {res['timers_s']}")
            sc = res["scanned_step"]
            say(f"  scanned step ({sc['steps']} steps): memory_analysis "
                f"{ {k: v for k, v in sc.items() if 'bytes' in k} }; "
                f"warm call {sc['warm_call_s']} s = "
                f"{size['n'] * sc['steps'] / sc['warm_call_s']:.4g} "
                "parcel-steps/s")
            runs[f"fast{fast}"] = res
        summary["main_path"] = runs

        nodiff = {}
        for fast in (0, 1):
            d = make_run(f"nodiff_fast{fast}", metbase, size["n"], fast)
            _, res = run_cli(clock, d, "DIFFUSION", "0")
            nodiff[fast] = final_atm(d)[1]
            say(f"DIFFUSION 0, TPU_FAST {fast}: wall {res['wall_s']} s")
        summary["fast_vs_exact"] = compare(
            f"fast vs exact on the card, {size['n']} parcels, "
            "DIFFUSION 0", nodiff[1], nodiff[0], FAST_DEG, FAST_P_RTOL)

        card = {}
        for key in cpu_dirs:
            c, fast = key
            d = make_run(f"card_ref{c}_fast{fast}", metbase,
                         size["n_ref"], fast, REF_CASES[c][1])
            run_cli(clock, d)
            card[key] = final_atm(d)[1]
        t0 = time.perf_counter()
        rc = proc.wait(timeout=1800)
        say(f"CPU reference child: exit {rc}, waited "
            f"{time.perf_counter() - t0:.1f} s after the card runs")
        assert rc == 0, (WORK / "cpu_ref.log").read_text()[-3000:]
        summary["card_vs_cpu"] = {}
        for (c, fast), d in cpu_dirs.items():
            label, _, tols = REF_CASES[c]
            deg, p_rtol = tols[fast]
            summary["card_vs_cpu"][f"{label}, TPU_FAST {fast}"] = compare(
                f"card vs CPU, TPU_FAST {fast}, {size['n_ref']} parcels, "
                f"{label}", card[(c, fast)], final_atm(d)[1], deg,
                p_rtol)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ------------------------------------------------------- phases 2, 4

def phase_chip_tests(rehearse, summary):
    """The chip-marked tests, on the card, in this process."""
    import pytest

    class Outcomes:
        def __init__(self):
            self.by = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.by[report.nodeid] = report.outcome

    os.environ["MPTRAC_CHIP_TESTS"] = "1"
    out = Outcomes()
    rc = pytest.main(
        [str(ROOT / "tests" / "test_rng.py"),
         str(ROOT / "tests" / "test_zeta_parity.py"), "-m", "chip",
         "-q", "-p", "no:cacheprovider", "--rootdir", str(ROOT)],
        plugins=[out])
    summary["chip_tests"] = out.by
    for nodeid, outcome in sorted(out.by.items()):
        say(f"chip test {nodeid}: {outcome}")
    passed = [k for k, v in out.by.items() if v == "passed"]
    if rehearse:
        assert rc in (0, 5), rc
        return
    assert rc == 0 and len(passed) == len(out.by) == 4, out.by
    say("RNG: Squares bits and uniforms bit-identical to the CPU and "
        "the golden doubles; normals atol 5e-7 (f32 Box-Muller angle); "
        "golden_zeta: lon/lat/z atol 1e-4, other columns rtol 1e-4")


# ----------------------------------------------------------- phase 5

def phase_four_cards(jax, size, summary):
    import numpy as np
    import jax.numpy as jnp

    from mptrac_tpu import Atm, Cache, read_ctl, stack_met
    from mptrac_tpu.climatology import read_clim
    from mptrac_tpu.met.synthetic import make_wind_met
    from mptrac_tpu.parallel import dd as ddm
    from mptrac_tpu.parallel import mesh as pmesh
    from mptrac_tpu.physics import pipeline

    devs = jax.devices()
    assert len(devs) >= 4, f"{len(devs)} devices"
    ndev, n = 4, size["n_dd"]
    ctl = read_ctl(None, [
        "NQ", "2", "QNT_NAME[0]", "idx", "QNT_NAME[1]", "m",
        "METBASE", "-", "DT_MOD", "180", "DIFFUSION", "0",
        "T_STOP", str(180 * DD_STEPS)])
    clim = read_clim(ctl)
    met01 = stack_met(
        make_wind_met(t0=0.0, nx=size["nx"], ny=size["ny"],
                      nz=size["nz"], alpha=30.0),
        make_wind_met(t0=3600.0, nx=size["nx"], ny=size["ny"],
                      nz=size["nz"], alpha=30.0))
    rng = np.random.default_rng(SEED)
    atm = Atm.zeros(n, ctl.qnt_name).replace(
        time=jnp.zeros(n), lon=jnp.asarray(rng.uniform(-180, 180, n)),
        lat=jnp.asarray(rng.uniform(-60, 60, n)),
        p=jnp.asarray(rng.uniform(200, 900, n)),
        q={"idx": jnp.arange(n, dtype=jnp.float64), "m": jnp.ones(n)},
        np=jnp.asarray(n, jnp.int32))
    ts = [jnp.asarray(180.0 * i, jnp.float64)
          for i in range(1, DD_STEPS + 1)]

    def run(step, met, a, c):
        for t in ts:
            a, c = step(met, a, c, t)
        jax.block_until_ready(a.lon)
        return a

    step = jax.jit(lambda m, a, c, t: pipeline.run_timestep(
        ctl, clim, m, a, c, t))
    t0 = time.perf_counter()
    one = run(step, met01, atm, Cache.zeros(n, iso_npmax=1))
    say(f"one card: {n} parcels, {DD_STEPS} steps, "
        f"{time.perf_counter() - t0:.1f} s incl. compile")
    ref = {k: np.asarray(getattr(one, k)) for k in ("lon", "lat", "p")}

    def check_spread(x, what):
        got = {s.device for s in x.addressable_shards}
        assert got == set(devs[:ndev]), f"{what} on {got}"

    def diffs(got, idx):
        order = np.argsort(idx)
        out = {}
        for k in ("lon", "lat", "p"):
            d = got[k][order] - ref[k]
            if k == "lon":
                d = (d + 180.0) % 360.0 - 180.0
            out[k] = float(np.abs(d).max())
        return out

    # -- domain decomposition: 2x2 subdomains, all_to_all migration
    ctl_dd = ctl.replace(dd=1, dd_subdomains_zonal=2,
                         dd_subdomains_meridional=2, dd_halos_size=4)
    dd = ddm.plan_decomposition(ctl_dd, jax.tree.map(lambda x: x[0],
                                                     met01), ndev=ndev)
    mesh = pmesh.make_mesh(ndev, axis="sub")
    tiles = ddm.make_tiles(dd, met01)
    lat_axis = np.asarray(met01.lat[0])
    cap = 2 * n // ndev
    atm_d, cache_d = ddm.scatter_parcels(dd, atm, cap, lat_axis)
    dstep = ddm.make_dd_step(ctl_dd, clim, dd, mesh, cap,
                             exch_cap=cap // 8, lat_axis=lat_axis)

    def owners(a):
        counts = np.asarray(a.np)
        slot = np.arange(ndev * cap)
        live = slot % cap < counts[slot // cap]
        own = np.empty(n, np.int64)
        own[np.asarray(a.q["idx"])[live].astype(np.int64)] = \
            (slot // cap)[live]
        return own

    own = owners(atm_d)
    overflow = lost = 0
    migrated = []
    t0 = time.perf_counter()
    for t in ts:
        atm_d, cache_d, ovf, lst = dstep(tiles, atm_d, cache_d, t)
        overflow += int(jnp.sum(ovf))
        lost += int(jnp.sum(lst))
        own2 = owners(atm_d)
        migrated.append(int(np.sum(own2 != own)))
        own = own2
    say(f"DD: {DD_STEPS} steps {time.perf_counter() - t0:.1f} s incl. "
        "compile and host-side migration counts")
    check_spread(atm_d.lon, "DD parcels")
    out = ddm.gather_parcels(dd, atm_d, cap)
    got = {k: np.asarray(getattr(out, k)) for k in ("lon", "lat", "p")}
    dd_diff = diffs(got, np.asarray(out.q["idx"]))
    ok = (overflow == 0 and lost == 0 and int(out.np) == n
          and max(dd_diff.values()) <= DD_ATOL)
    say(f"DD 2x2 on {ndev} cards vs one card: max|d| {dd_diff} "
        f"(atol {DD_ATOL:g}, f64), overflow {overflow}, lost {lost}, "
        f"migrated_per_step {migrated}; {'PASS' if ok else 'FAIL'}")
    assert ok
    summary["dd"] = dict(max_abs_diff=dd_diff, atol=DD_ATOL,
                         overflow=overflow, lost=lost,
                         migrated_per_step=migrated)

    # -- data parallel: parcels sharded over a dp mesh, met replicated
    mesh_dp = pmesh.make_mesh(ndev)
    a = pmesh.shard_atm(atm, mesh_dp)
    c = pmesh.shard_cache(Cache.zeros(n, iso_npmax=1), mesh_dp)
    m = pmesh.replicate_met(met01, mesh_dp)
    check_spread(a.lon, "dp parcels")
    dp = run(step, m, a, c)
    check_spread(dp.lon, "dp result")
    dp_diff = diffs({k: np.asarray(getattr(dp, k))
                     for k in ("lon", "lat", "p")},
                    np.asarray(dp.q["idx"]))
    ok = max(dp_diff.values()) <= DD_ATOL
    say(f"dp-sharded step on {ndev} cards vs one card: max|d| {dp_diff}"
        f" (atol {DD_ATOL:g}); {'PASS' if ok else 'FAIL'}")
    assert ok
    summary["dp"] = dict(max_abs_diff=dp_diff, atol=DD_ATOL)


# -------------------------------------------------------------- main

def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args()

    if not (ROOT / "mptrac_tpu" / "__init__.py").is_file():
        print(f"chip_smoke.py must run from a checkout of the repository"
              f" ({ROOT} holds no mptrac_tpu package)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("LOGLEV", "0")
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=4").strip()

    for line in card_info():
        say(f"card: {line}")
    import jax

    import mptrac_tpu  # noqa: F401  (x64)
    from mptrac_tpu.utils.compile_cache import enable_compile_cache
    say(f"compile cache: {enable_compile_cache()}")
    dev = jax.devices()[0]
    say(f"jax {jax.__version__}: {len(jax.devices())} x "
        f"{dev.platform} {dev.device_kind}")
    if dev.platform != "gpu" and not args.rehearse:
        print(f"JAX found no GPU (default platform {dev.platform})",
              file=sys.stderr)
        return 1
    clock = CompileClock(jax)
    size = TINY if args.rehearse else FULL
    WORK.mkdir(parents=True, exist_ok=True)
    summary = dict(card=card_info(), jax=jax.__version__, size=size,
                   chips=args.chips)
    t0 = time.perf_counter()
    if args.chips == 4:
        phase_four_cards(jax, size, summary)
    else:
        phase_chip_tests(args.rehearse, summary)
        phase_main_path(jax, clock, size, summary)
    summary["total_s"] = round(time.perf_counter() - t0, 1)
    say(f"all phases passed in {summary['total_s']} s")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    suffix = "_4chips" if args.chips == 4 else ""
    (out / f"chip_smoke{suffix}.json").write_text(
        json.dumps(summary, indent=1, default=str))
    if args.rehearse:
        print("rehearsal on the CPU passed; no GPU, so no result",
              file=sys.stderr)
        return 3
    count = len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
