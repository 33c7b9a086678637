"""High-level simulation driver.

Equivalent of the reference ``trac`` main loop
(/root/reference/src/trac.c:95-185) and the ``mptrac_*`` high-level API
(mptrac_get_met c:6187, mptrac_init c:6312, mptrac_run_timestep c:7545,
mptrac_write_output c:7919).

The time loop runs on the host; each step invokes one jitted XLA graph
(recompiled only when the static StepFlags gate pattern changes, of
which there are at most a few combinations).  Met snapshots are
double-buffered host-side and uploaded as a stacked [2, ...] pair.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from mptrac_tpu.climatology import read_clim
from mptrac_tpu.config import Ctl, read_ctl
from mptrac_tpu.io import atm_io
from mptrac_tpu.met.build import read_met
from mptrac_tpu.met.read_nc import get_met_filename
from mptrac_tpu.physics import pipeline
from mptrac_tpu.physics.timesteps import init_time_range
from mptrac_tpu.types import Atm, Cache, Clim, Met, stack_met


class MetBuffer:
    """Double-buffered met reader (reference mptrac_get_met, c:6187).

    Keeps the two snapshots bracketing the current time; re-reads one
    file per met interval crossing and rebuilds the stacked pair.
    """

    def __init__(self, ctl: Ctl, clim: Clim):
        self.ctl = ctl
        self.clim = clim
        self.met0: Optional[Met] = None
        self.met1: Optional[Met] = None
        self._files = (None, None)
        self.pair: Optional[Met] = None
        # Native decode-ahead for binary containers (reference analog:
        # the `cat > /dev/null &` page-cache prefetch, c:6222)
        self._loader = None
        self._prefetched: Optional[str] = None
        if ctl.met_type in (1, 2) and not ctl.met_pck_zstd:
            try:
                from mptrac_tpu.native_loader import AsyncMetLoader
                self._loader = AsyncMetLoader()
            except Exception:
                self._loader = None

    def _read(self, filename: str) -> Met:
        from mptrac_tpu.met.build import read_met, _to_met
        if self._loader is not None and self._prefetched == filename:
            raw = self._loader.wait()
            raw["coord_type"] = self.ctl.met_coord_type
            self._prefetched = None
            met = _to_met(self.ctl, raw, raw["lon"], raw["lat"],
                          raw["p"], raw["fields2d"], raw["fields3d"])
        else:
            met = read_met(filename, self.ctl, self.clim)
        # queue the following interval's file for background decode
        if self._loader is not None:
            nxt = get_met_filename(
                self.ctl, float(met.time)
                + self.ctl.direction * self.ctl.dt_met,
                self.ctl.direction)
            if os.path.exists(nxt) and nxt != self._prefetched:
                self._loader.prefetch(nxt, self.ctl.met_type)
                self._prefetched = nxt
        return met

    def get(self, t: float) -> Met:
        ctl = self.ctl
        changed = False
        if self.met0 is None:
            # Initial read of both bracketing snapshots (c:6205-6218)
            f0 = get_met_filename(
                ctl, t + (-1 if ctl.direction == -1 else 0), -1)
            f1 = get_met_filename(
                ctl, t + (1 if ctl.direction == 1 else 0), 1)
            self.met0 = self._read(f0)
            self.met1 = (self.met0 if f1 == f0
                         else self._read(f1))
            changed = True
        # Forward: advance when t passes met1 (c:6236-6248)
        if t > float(self.met1.time):
            self.met0 = self.met1
            self.met1 = self._read(get_met_filename(ctl, t, 1))
            changed = True
        # Backward: advance when t passes met0 (c:6264-6276)
        if t < float(self.met0.time):
            self.met1 = self.met0
            self.met0 = self._read(get_met_filename(ctl, t, -1))
            changed = True
        if changed:
            self._check_grids()
            self.pair = stack_met(self.met0, self.met1)
        return self.pair

    def _check_grids(self):
        m0, m1 = self.met0, self.met1
        import numpy as np
        if (m0.nx, m0.ny, m0.npl) != (m1.nx, m1.ny, m1.npl):
            raise ValueError("Meteo grid dimensions do not match!")
        if not np.allclose(np.asarray(m0.lon), np.asarray(m1.lon),
                           atol=0.001):
            raise ValueError("Meteo grid longitudes do not match!")


class Simulation:
    """One model run: ctl + clim + atm + cache + met buffer.

    ``checkpoint_file``/``checkpoint_dt`` enable periodic full-state
    checkpoints (framework extension; the reference is restartable only
    through atm outputs, see mptrac_tpu.checkpoint).
    """

    def __init__(self, ctl: Ctl, atm: Atm, clim: Optional[Clim] = None,
                 dirname: str = ".", checkpoint_file: Optional[str] = None,
                 checkpoint_dt: float = 0.0):
        from mptrac_tpu.utils.timers import Timers
        self.clim = clim if clim is not None else read_clim(ctl)
        self.ctl = init_time_range(ctl, atm.time[:int(atm.np)])
        self.atm = atm
        self.cache = Cache.zeros(atm.npmax, atm.time.dtype)
        self.metbuf = MetBuffer(self.ctl, self.clim)
        self.dirname = dirname
        self.timers = Timers()
        self.checkpoint_file = checkpoint_file
        self.checkpoint_dt = checkpoint_dt
        self._resume_t: Optional[float] = None
        self._steps: Dict[pipeline.StepFlags, object] = {}
        self._scans: Dict[pipeline.StepFlags, object] = {}
        self._output: Optional[object] = None
        self._pack = None
        self._pack_src = None
        self._pack_builder = None

    def resume(self, path: Optional[str] = None):
        """Restore state from a checkpoint and continue from its time."""
        from mptrac_tpu.checkpoint import load_checkpoint
        self.atm, self.cache, t, _ = load_checkpoint(
            path or self.checkpoint_file)
        self._resume_t = t
        return self

    def _step_fn(self, flags: pipeline.StepFlags):
        fn = self._steps.get(flags)
        if fn is None:
            ctl, clim = self.ctl, self.clim
            use_pack = bool(ctl.tpu_fast)

            @jax.jit
            def fn(met01, atm, cache, t, pack=None):
                return pipeline.run_timestep(
                    ctl, clim, met01, atm, cache, t, flags,
                    pack if use_pack else None)
            self._steps[flags] = fn
        return fn

    def _scan_fn(self, flags: pipeline.StepFlags):
        fn = self._scans.get(flags)
        if fn is None:
            fn = pipeline.make_scan_step(
                self.ctl, self.clim, flags,
                use_pack=bool(self.ctl.tpu_fast))
            self._scans[flags] = fn
        return fn

    def _get_pack(self, met01):
        """Packed gather tables, rebuilt per met interval
        (ops.fast_interp; TPU_FAST 1 only)."""
        if not self.ctl.tpu_fast:
            return None
        if self._pack_src is not met01:
            from mptrac_tpu.ops.fast_interp import build_met_pack
            if self._pack_builder is None:
                self._pack_builder = jax.jit(build_met_pack)
            self._pack = self._pack_builder(met01)
            self._pack_src = met01
        return self._pack

    def _sort(self, met01):
        with self.timers.timer("MODULE_SORT", "PHYSICS"):
            from mptrac_tpu.ops.sort import module_sort
            self.atm, self.cache = module_sort(met01, self.atm,
                                               self.cache)

    def _event_due(self, t: float) -> bool:
        """True when step t needs host-side work besides the jitted
        step itself: interval outputs, sorting, checkpoints."""
        ctl = self.ctl

        def hit(dt):
            return dt > 0 and math.fmod(t, dt) == 0

        return (t == ctl.t_stop
                or (ctl.atm_basename != "-" and hit(ctl.atm_dt_out))
                or (ctl.grid_basename != "-" and hit(ctl.grid_dt_out))
                or (ctl.ens_basename != "-" and hit(ctl.ens_dt_out))
                or ctl.vtk_basename != "-"
                or hit(ctl.sort_dt)
                or (self.checkpoint_file is not None
                    and hit(self.checkpoint_dt)))

    @property
    def _per_step_output(self) -> bool:
        ctl = self.ctl
        return any(b != "-" for b in (ctl.csi_basename,
                                      ctl.prof_basename,
                                      ctl.sample_basename,
                                      ctl.stat_basename))

    def _flags(self, t: float) -> pipeline.StepFlags:
        ctl = self.ctl

        def hit(dt):
            return dt <= 0 or math.fmod(t, dt) == 0

        return pipeline.StepFlags(
            do_conv=ctl.conv_dt <= 0 or math.fmod(t, ctl.conv_dt) == 0,
            do_mixing=hit(ctl.mixing_dt),
            do_kpp=hit(ctl.dt_kpp),
            do_meteo=(ctl.met_dt_out > 0
                      and (ctl.met_dt_out < ctl.dt_mod
                           or math.fmod(t, ctl.met_dt_out) == 0)),
        )

    def times(self):
        """Iterator over model step times (reference trac.c:122-129)."""
        ctl = self.ctl
        t = ctl.t_start
        while ctl.direction * (t - ctl.t_stop) < ctl.dt_mod:
            yield min(t, ctl.t_stop) if ctl.direction == 1 else max(
                t, ctl.t_stop)
            t += ctl.direction * ctl.dt_mod

    def advance(self, t: float, write_output: bool = True,
                first: bool = False):
        """One wall-clock step of the driver loop at model time ``t``:
        met buffering, optional sort, the jitted timestep, output and
        checkpointing (reference trac.c:122-160)."""
        with self.timers.timer("GET_MET", "INPUT"):
            met01 = self.metbuf.get(t)
        if first:
            self.atm, self.cache = pipeline.init_modules(
                self.ctl, self.clim, met01, self.atm, self.cache)
        if self.ctl.sort_dt > 0 and math.fmod(t, self.ctl.sort_dt) == 0:
            self._sort(met01)
        step = self._step_fn(self._flags(t))
        with self.timers.timer("RUN_TIMESTEP", "PHYSICS", sync=None):
            self.atm, self.cache = step(met01, self.atm, self.cache, t,
                                        self._get_pack(met01))
        if write_output:
            with self.timers.timer("WRITE_OUTPUT", "OUTPUT"):
                self.write_output(t)
        if (self.checkpoint_file and self.checkpoint_dt > 0
                and math.fmod(t, self.checkpoint_dt) == 0):
            from mptrac_tpu.checkpoint import save_checkpoint
            save_checkpoint(self.checkpoint_file, self.atm,
                            self.cache, t)

    def close(self):
        """Flush and close output files."""
        if self._output is not None:
            self._output.close()
            self._output = None

    def run(self, write_output: bool = True, progress: bool = False,
            scan: bool = True):
        """Run the full time loop.

        Homogeneous runs of steps — same static flags, same met pair,
        no interval output / sort / checkpoint due — are batched into
        one on-device ``lax.scan`` dispatch (the reference dispatches
        every step from the host, trac.c:122-160; per-dispatch latency
        would dominate).  ``scan=False`` forces one dispatch
        per step."""
        ts = [t for t in self.times()
              if not (self._resume_t is not None
                      and self.ctl.direction * (t - self._resume_t)
                      <= 0)]
        batch_ok = scan and not self._per_step_output
        first = True
        i = 0
        while i < len(ts):
            t = ts[i]
            # group of scannable steps starting at ts[i]
            j = i
            if batch_ok and not first:
                flags = self._flags(t)
                met1_t = (float(self.metbuf.met1.time)
                          if self.metbuf.met1 is not None else None)
                while j < len(ts):
                    tj = ts[j]
                    if self._event_due(tj) or self._flags(tj) != flags:
                        break
                    if met1_t is not None and (
                            self.ctl.direction == 1 and tj > met1_t
                            or self.ctl.direction == -1
                            and tj < float(self.metbuf.met0.time)):
                        break
                    j += 1
            if j - i >= 2:
                with self.timers.timer("GET_MET", "INPUT"):
                    met01 = self.metbuf.get(ts[i])
                scanf = self._scan_fn(self._flags(ts[i]))
                tvec = jnp.asarray(ts[i:j], jnp.float64)
                with self.timers.timer("RUN_TIMESTEP", "PHYSICS",
                                       sync=None):
                    pack = self._get_pack(met01)
                    if pack is not None:
                        self.atm, self.cache = scanf(
                            met01, self.atm, self.cache, tvec, pack)
                    else:
                        self.atm, self.cache = scanf(
                            met01, self.atm, self.cache, tvec)
                if progress:
                    print(f"  t={ts[i]:.0f}..{ts[j - 1]:.0f} "
                          f"(scan x{j - i})", flush=True)
                i = j
                continue
            self.advance(t, write_output, first=first)
            first = False
            if progress:
                print(f"  t={t:.0f}", flush=True)
            i += 1
        self.close()
        # End-of-run timer table (reference PRINT_TIMERS, h:2255)
        from mptrac_tpu.utils.log import get_level
        if get_level() >= 1:
            self.timers.report()
        return self.atm

    def write_output(self, t: float):
        """Output dispatcher (reference mptrac_write_output, c:7919)."""
        from mptrac_tpu.io.output import OutputManager
        if self._output is None:
            self._output = OutputManager(self.dirname, self.ctl)
        self._output.write(self.metbuf, self.atm, t)


def run_trac(dirname: str, ctl_file: str, atm_file: str, args=()):
    """Equivalent of the reference trac driver for one dirlist task
    (trac.c:95-185)."""
    ctl_path = os.path.join(dirname, ctl_file)
    ctl = read_ctl(ctl_path, args)
    atm_path = os.path.join(dirname, atm_file)
    atm = atm_io.read_atm(atm_path, ctl)
    sim = Simulation(ctl, atm, dirname=dirname)
    sim.run()
    return sim
