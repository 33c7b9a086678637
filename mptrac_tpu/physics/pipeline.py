"""Per-timestep module pipeline.

Rebuild of ``mptrac_run_timestep``
(/root/reference/src/mptrac.c:7545-7694): the fixed module order with
static (trace-time) enables resolved from Ctl, so XLA compiles one
fixed graph per configuration.  The whole step is jittable:
``step = make_step(ctl, clim); atm, cache = step(met01, atm, cache, t)``.

Module-level time gating that depends on the wall-clock step (fmod
checks on conv_dt / mixing_dt / dt_kpp) is passed in as static flags by
the driver, keeping the traced graph shape-stable.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mptrac_tpu.config import Ctl
from mptrac_tpu.physics import advect as m_advect
from mptrac_tpu.physics import diffusion as m_diff
from mptrac_tpu.physics import meteo as m_meteo
from mptrac_tpu.physics import position as m_position
from mptrac_tpu.physics import timesteps as m_timesteps
from mptrac_tpu.types import Atm, Cache, Clim, Met


class StepFlags(NamedTuple):
    """Per-step static gates evaluated by the driver (fmod of the
    wall-clock time against module intervals, reference c:7599, 7638,
    7645)."""
    do_conv: bool = True
    do_mixing: bool = True
    do_kpp: bool = True
    do_meteo: bool = True


def run_timestep(ctl: Ctl, clim: Clim, met01: Met, atm: Atm, cache: Cache,
                 t, flags: StepFlags = StepFlags(), pack=None):
    """One model timestep; mirrors the reference module order.

    ``pack`` optionally supplies precomputed wide-row gather tables
    for the fast path: a MetPack (ops.fast_interp.build_met_pack) or a
    bare packed wind table (build_advect_pack / build_advect_pack64)."""
    from mptrac_tpu.ops.fast_interp import MetPack
    if pack is not None and not isinstance(pack, MetPack):
        pack = MetPack(w64=pack, sfc=None)
    wpack = pack.w64 if pack is not None else None
    sfc = pack.sfc if pack is not None else None

    # Set timesteps of air parcels
    with jax.named_scope("module_timesteps"):
        cache = m_timesteps.module_timesteps(ctl, cache, met01, atm, t)

    # (module_sort is a performance transform — handled by the driver)

    # Check positions (initial)
    atm = m_position.module_position(cache, met01, atm, sfc)

    # Advection
    if ctl.advect > 0:
        with jax.named_scope("module_advect"):
            atm = m_advect.module_advect(ctl, cache, met01, atm, wpack)

    # Turbulent diffusion
    if ctl.diffusion and (
            ctl.turb_dx_pbl > 0 or ctl.turb_dz_pbl > 0
            or ctl.turb_dx_trop > 0 or ctl.turb_dz_trop > 0
            or ctl.turb_dx_strat > 0 or ctl.turb_dz_strat > 0):
        atm, cache = m_diff.module_diff_turb(ctl, cache, clim, met01,
                                             atm, sfc)

    # PBL diffusion scheme
    if ctl.diffusion and ctl.turb_pbl_scheme == 1:
        from mptrac_tpu.physics.pbl import module_diff_pbl
        atm, cache = module_diff_pbl(ctl, cache, met01, atm)

    # Mesoscale diffusion
    if ctl.diffusion and (ctl.turb_mesox > 0 or ctl.turb_mesoz > 0):
        atm, cache = m_diff.module_diff_meso(ctl, cache, met01, atm,
                                             wpack)

    # Convection
    if (ctl.conv_mix_pbl or ctl.conv_cape >= 0) and flags.do_conv:
        from mptrac_tpu.physics.convection import module_convection
        atm, cache = module_convection(ctl, cache, met01, atm)

    # Sedimentation
    if ctl.qnt("rp") >= 0 and ctl.qnt("rhop") >= 0:
        from mptrac_tpu.physics.sedi import module_sedi
        atm = module_sedi(ctl, cache, met01, atm)

    # Isosurface
    if 1 <= ctl.isosurf <= 4:
        from mptrac_tpu.physics.isosurf import module_isosurf
        atm = module_isosurf(ctl, cache, met01, atm)

    # Check positions (final)
    atm = m_position.module_position(cache, met01, atm, sfc)

    # Interpolate meteo data
    if ctl.met_dt_out > 0 and flags.do_meteo:
        atm = m_meteo.module_meteo(ctl, cache, clim, met01, atm, pack)

    # Boundary conditions (initial)
    bound_on = (ctl.bound_lat0 < ctl.bound_lat1
                and ctl.bound_p0 > ctl.bound_p1)
    if bound_on:
        from mptrac_tpu.physics.bound import module_bound_cond
        atm = module_bound_cond(ctl, cache, clim, met01, atm)

    # Initialize total loss rate
    if ctl.qnt("loss_rate") >= 0:
        q = dict(atm.q)
        q["loss_rate"] = jnp.where((cache.dt != 0) & atm.mask, 0.0,
                                   q["loss_rate"])
        atm = atm.replace(q=q)

    # Exponential decay
    if ctl.tdec_trop > 0 and ctl.tdec_strat > 0:
        from mptrac_tpu.physics.decay import module_decay
        atm = module_decay(ctl, cache, clim, atm)

    # Interparcel mixing
    if (ctl.mixing_trop >= 0 and ctl.mixing_strat >= 0
            and flags.do_mixing):
        from mptrac_tpu.physics.mixing import module_mixing
        atm = module_mixing(ctl, clim, atm, t)

    # Chemistry grid
    if (ctl.oh_chem_reaction != 0 or ctl.h2o2_chem_reaction != 0
            or (ctl.kpp_chem and flags.do_kpp)):
        from mptrac_tpu.physics.chem import module_chem_grid
        atm = module_chem_grid(ctl, met01, atm, t)

    # OH chemistry
    if ctl.oh_chem_reaction != 0:
        from mptrac_tpu.physics.chem import module_oh_chem
        atm = module_oh_chem(ctl, cache, clim, met01, atm)

    # H2O2 chemistry
    if ctl.h2o2_chem_reaction != 0:
        from mptrac_tpu.physics.chem import module_h2o2_chem
        atm = module_h2o2_chem(ctl, cache, clim, met01, atm)

    # First-order tracer chemistry
    if ctl.tracer_chem:
        from mptrac_tpu.physics.chem import module_tracer_chem
        atm = module_tracer_chem(ctl, cache, clim, met01, atm)

    # Radioactive decay
    if ctl.radio_decay:
        from mptrac_tpu.physics.decay import module_radio_decay
        atm = module_radio_decay(ctl, cache, atm)

    # KPP full chemistry
    if ctl.kpp_chem and flags.do_kpp:
        from mptrac_tpu.physics.kpp import module_kpp_chem
        atm = module_kpp_chem(ctl, cache, clim, met01, atm)

    # Wet deposition
    if ((ctl.wet_depo_ic_a > 0 or ctl.wet_depo_ic_h[0] > 0)
            and (ctl.wet_depo_bc_a > 0 or ctl.wet_depo_bc_h[0] > 0)):
        from mptrac_tpu.physics.depo import module_wet_depo
        atm = module_wet_depo(ctl, cache, met01, atm)

    # Dry deposition
    if ctl.dry_depo_vdep > 0:
        from mptrac_tpu.physics.depo import module_dry_depo
        atm = module_dry_depo(ctl, cache, met01, atm)

    # Boundary conditions (final)
    if bound_on:
        from mptrac_tpu.physics.bound import module_bound_cond
        atm = module_bound_cond(ctl, cache, clim, met01, atm)

    return atm, cache


def make_step(ctl: Ctl, clim: Clim, flags: StepFlags = StepFlags()):
    """Build a jitted step function closed over static config."""
    @jax.jit
    def step(met01: Met, atm: Atm, cache: Cache, t):
        return run_timestep(ctl, clim, met01, atm, cache, t, flags)
    return step


def make_scan_step(ctl: Ctl, clim: Clim, flags: StepFlags = StepFlags(),
                   use_pack: bool = False):
    """Build a jitted multi-step function: ``lax.scan`` over a vector
    of model times, so one dispatch advances many timesteps.

    The reference dispatches every step from the host
    (trac.c:122-160); per-dispatch latency dominates at small step
    costs, so the driver batches the homogeneous steps
    between met swaps / output times into one on-device scan.  All
    scanned steps share the same static module gates (``flags``)."""
    @jax.jit
    def scan_steps(met01: Met, atm: Atm, cache: Cache, ts, pack=None):
        def body(carry, t):
            a, c = carry
            a, c = run_timestep(ctl, clim, met01, a, c, t, flags,
                                pack if use_pack else None)
            return (a, c), None

        (atm, cache), _ = jax.lax.scan(body, (atm, cache), ts)
        return atm, cache

    return scan_steps


def init_modules(ctl: Ctl, clim: Clim, met01: Met, atm: Atm,
                 cache: Cache):
    """First-step module initialization (reference c:7556-7567)."""
    if 1 <= ctl.isosurf <= 4:
        from mptrac_tpu.physics.isosurf import module_isosurf_init
        cache = module_isosurf_init(ctl, cache, met01, atm)
    atm = m_advect.module_advect_init(ctl, met01, atm)
    from mptrac_tpu.physics.chem import module_chem_init
    atm = module_chem_init(ctl, clim, met01, atm)
    return atm, cache
