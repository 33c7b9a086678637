"""Full chemistry (KPP mechanism) with a JAX Rosenbrock solver.

Rebuild of the reference's optional KPP chemistry
(/root/reference/src/mptrac.c module_kpp_chem c:5001, mechanism
projects/kpp/chem/chem.eqn, rate constants projects/kpp/chem/chem.kpp):
a 15-species HOx/Ox/SO2 stratospheric mechanism with 39 reactions (JPL
rates, photolysis table lookups, aqueous SO2+H2O2), integrated per
parcel over DT_KPP.

Instead of KPP-generated C code and a per-parcel Rosenbrock loop, the
stoichiometry lives in data tables (mptrac_tpu/data/kpp_mechanism.npz)
and a vectorized 4-stage Rosenbrock (Rodas3) integrator with adaptive
step control runs for all parcels simultaneously under vmap; the
15x15 linear stage solves batch onto the MXU.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mptrac_tpu import climatology as cl
from mptrac_tpu.config import Ctl
from mptrac_tpu.constants import AVO, MA, RI
from mptrac_tpu.ops import interp
from mptrac_tpu.physics.chem import clim_photo, cos_sza, molec_dens
from mptrac_tpu.types import Atm, Cache, Clim, Met

def _load_mechanism():
    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "kpp_mechanism.npz")
    with np.load(path) as d:
        return (jnp.asarray(d["react_v"]), jnp.asarray(d["react_f"]),
                jnp.asarray(d["net_v"]),
                [str(s) for s in d["var_species"]],
                [str(s) for s in d["fix_species"]])


REACT_V, REACT_F, NET_V, VAR_SPECIES, FIX_SPECIES = _load_mechanism()
NVAR = len(VAR_SPECIES)
NREACT = REACT_V.shape[0]

#: quantity name carrying each variable species (SET_VAR calls,
#: chem.kpp:97-110; so2 is carried in qnt_Cx)
SPECIES_QNT = {"o3p": "Co3p", "o1d": "Co1d", "h2o2": "Ch2o2",
               "oh": "Coh", "ho2": "Cho2", "h": "Ch", "n2o": "Cn2o",
               "ccl3f": "Cccl3f", "ccl2f2": "Cccl2f2", "co": "Cco",
               "so2": "Cx"}


def _arr_ab(t, a, b):
    return a * jnp.exp(-b / t)


def _arr_ac(t, a, c):
    return a * (t / 298.0) ** c


def _k3rd_jpl(t, M, k0_300, n, kinf_300, m):
    k0 = k0_300 * (298.0 / t) ** n * M
    kinf = kinf_300 * (298.0 / t) ** m
    c = jnp.log10(k0 / kinf)
    return k0 / (1.0 + k0 / kinf) * 0.6 ** (1.0 / (1.0 + c * c))


def _kcar_jpl(t, M, k0_300, n, kinf_300, m, a, b):
    """CO + OH chemical activation rate (chem.kpp kcar_jpl)."""
    return (_k3rd_jpl(t, M, k0_300, n, kinf_300, m)
            + _arr_ab(t, a, -b))


def rate_constants(clim: Clim, t, M, p, sza, o3c, lwc):
    """All 39 reaction rate constants (chem.kpp:124-195)."""

    def photo(key):
        if key in clim.photo:
            return clim_photo(clim.photo[key], clim, p, sza, o3c)
        return jnp.zeros_like(t)

    k = [None] * NREACT
    k[0] = _arr_ac(t, 6.1e-34, -2.4) * M
    k[1] = _arr_ab(t, 8e-12, 2060)
    k[2] = _arr_ab(t, 1.8e-11, -180)
    k[3] = _arr_ab(t, 3e-11, -200)
    k[4] = _arr_ab(t, 1.4e-12, 2000)
    k[5] = _arr_ab(t, 3.3e-11, -55)
    k[6] = _arr_ab(t, 2.4e-10, 0)
    k[7] = _arr_ab(t, 1.2e-10, 0)
    k[8] = _arr_ab(t, 1.63e-10, -60)
    k[9] = _arr_ab(t, 2.15e-11, -110)
    k[10] = _arr_ac(t, 2.8e-36, -0.9) * M
    k[11] = _arr_ab(t, 1.19e-10, -20)
    k[12] = _arr_ab(t, 1.75e-10, 0)
    k[13] = _arr_ab(t, 7.5e-11, -115)
    k[14] = _arr_ab(t, 2.3e-10, 0)
    k[15] = _arr_ab(t, 1.4e-10, -25)
    k[16] = _k3rd_jpl(t, M, 5.3e-32, 1.8, 9.5e-11, -0.4)
    k[17] = _arr_ab(t, 1.4e-10, 470)
    k[18] = _arr_ab(t, 7.2e-11, 0)
    k[19] = _arr_ab(t, 1.6e-12, 0)
    k[20] = _arr_ab(t, 6.9e-12, 0)
    k[21] = _arr_ab(t, 1.7e-12, 940)
    k[22] = _arr_ab(t, 1.8e-12, 0)
    k[23] = _k3rd_jpl(t, M, 6.9e-31, 1.0, 2.6e-11, 0)
    k[24] = _arr_ab(t, 4.8e-11, -250)
    k[25] = jnp.full_like(t, 1.8e-12)
    k[26] = _kcar_jpl(t, M, 6.9e-33, 2.1, 1.1e-12, -1.3, 1.85e-13, 65)
    k[27] = _arr_ab(t, 1e-14, 490)
    k[28] = (_arr_ab(t, 3e-13, -460)
             + _arr_ab(t, 2.1e-33, -920) * M)
    k[29] = photo("o2")
    k[30] = photo("o3_1")
    k[31] = photo("o3_2")
    k[32] = photo("h2o")
    k[33] = photo("h2o2")
    k[34] = photo("n2o")
    k[35] = photo("ccl3f")
    k[36] = photo("ccl3f")   # reference uses ccl3f table for both
    # Aqueous SO2 + H2O2 (chem.kpp:176-190)
    kaq = 9.1e7 * jnp.exp(-29700.0 / RI * (1.0 / t - 1.0 / 298.15)) \
        / (AVO * 1e-3) ** 2
    H_SO2 = 1.3e-2 * jnp.exp(2900.0 * (1.0 / t - 1.0 / 298.15)) * RI * t
    K_1S = 1.23e-2 * jnp.exp(2.01e3 * (1.0 / t - 1.0 / 298.15)) \
        * AVO * 1e-3
    H_h2o2 = 8.3e2 * jnp.exp(7600.0 * (1.0 / t - 1.0 / 298.15)) * RI * t
    rho_air = 100.0 * p / (RI * t) * MA / 1000.0
    CWC = lwc * rho_air / 1000.0
    k[37] = kaq * K_1S * H_SO2 * H_h2o2 * CWC
    k[38] = _k3rd_jpl(t, M, 2.9e-31, 4.1, 1.7e-12, -0.2)
    return jnp.stack(k, axis=-1)     # [np, NREACT]


def _rhs(c, fix, rconst):
    """dC/dt for one parcel: rates = k * prod(C^order); dC = S^T r.

    The matrix products here and in the Rosenbrock solve run in
    float64 (KPP state is always f64), which no GPU runs in TF32; an
    f32 KPP path would need ``precision=HIGHEST`` on them."""
    logc = jnp.log(jnp.maximum(c, 1e-30))
    logf = jnp.log(jnp.maximum(fix, 1e-30))
    # reaction rates; integer orders
    lograte = (REACT_V @ logc + REACT_F @ logf)
    rates = rconst * jnp.exp(lograte)
    return NET_V.T @ rates


# Rodas3 coefficients (KPP int/rosenbrock.f90 SUBROUTINE Rodas3; the
# reference selects method 4 = Rodas3 in module_kpp_chem, c:5044)
_GAMMA = 0.5
_ALPHA = np.array([
    [0.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0],
    [2.0, 0.0, 0.0, 0.0],
    [2.0, 0.0, 1.0, 0.0]])
_C = np.array([
    [0.0, 0.0, 0.0, 0.0],
    [4.0, 0.0, 0.0, 0.0],
    [1.0, -1.0, 0.0, 0.0],
    [1.0, -1.0, -8.0 / 3.0, 0.0]])
_M = np.array([2.0, 0.0, 1.0, 1.0])
_E = np.array([0.0, 0.0, 0.0, 1.0])


def _rosenbrock_step(c, fix, rconst, h):
    """One Rodas3 step; returns (c_new, err_norm)."""
    f0 = _rhs(c, fix, rconst)
    J = jax.jacfwd(lambda x: _rhs(x, fix, rconst))(c)
    A = jnp.eye(NVAR) / (h * _GAMMA) - J
    lu, piv = jax.scipy.linalg.lu_factor(A)

    ks = []
    for i in range(4):
        ci = c
        for j in range(i):
            ci = ci + _ALPHA[i, j] * ks[j]
        fi = f0 if i in (0, 1) else _rhs(ci, fix, rconst)
        rhs = fi
        for j in range(i):
            rhs = rhs + (_C[i, j] / h) * ks[j]
        ks.append(jax.scipy.linalg.lu_solve((lu, piv), rhs))
    c_new = c
    for i in range(4):
        c_new = c_new + _M[i] * ks[i]
    err_vec = sum(_E[i] * ks[i] for i in range(4))
    scale = 1.0 + jnp.abs(c_new) * 1e-3
    err = jnp.sqrt(jnp.mean((err_vec / scale) ** 2))
    return jnp.maximum(c_new, 0.0), err


def integrate(c0, fix, rconst, dt, rtol=1e-3, max_steps=1000):
    """Adaptive Rodas3 integration of one parcel over dt.

    Step control follows KPP's ros_Integrator (rosenbrock.f90): safety
    factor 0.9, growth capped x5, shrink capped x0.2, and growth
    disabled immediately after a rejection (RejectLastH memory) to
    prevent accept/reject chattering on stiff transients."""

    def cond(state):
        t, h, c, n, rejected = state
        return (t < dt * (1.0 - 1e-12)) & (n < max_steps)

    def body(state):
        t, h, c, n, rejected = state
        h_eff = jnp.minimum(h, dt - t)
        c_new, err = _rosenbrock_step(c, fix, rconst, h_eff)
        err = jnp.where(jnp.isfinite(err), err, 1e10)
        accept = err <= 1.0
        fac = jnp.clip(0.9 * jnp.maximum(err, 1e-10) ** (-1.0 / 3.0),
                       0.2, 5.0)
        fac = jnp.where(accept & rejected, jnp.minimum(fac, 1.0), fac)
        t2 = jnp.where(accept, t + h_eff, t)
        c2 = jnp.where(accept, c_new, c)
        h2 = jnp.clip(h_eff * fac, 1e-12 * dt, dt)
        return (t2, h2, c2, n + 1, ~accept)

    t0 = jnp.asarray(0.0, c0.dtype)
    h0 = jnp.asarray(dt * 1e-6, c0.dtype)
    _, _, c_final, _, _ = jax.lax.while_loop(
        cond, body, (t0, h0, c0, 0, jnp.asarray(False)))
    return c_final


def module_kpp_chem(ctl: Ctl, cache: Cache, clim: Clim, met01: Met,
                    atm: Atm) -> Atm:
    """Full-chemistry step over DT_KPP (reference module_kpp_chem,
    c:5001)."""
    active = (cache.dt != 0.0) & atm.mask
    loc = interp.locate_3d(met01, atm.lon, atm.lat, atm.p)
    t = interp.interp_time_3d(met01, "t", atm.time, loc)
    lwc = interp.interp_time_3d(met01, "lwc", atm.time, loc)
    h2o = interp.interp_time_3d(met01, "h2o", atm.time, loc)
    o3 = interp.interp_time_3d(met01, "o3", atm.time, loc)
    o3c = interp.interp_time_2d(met01, "o3c", atm.time, loc)
    M = molec_dens(atm.p, t)
    sza = jnp.arccos(jnp.clip(cos_sza(atm.time, atm.lon, atm.lat),
                              -1.0, 1.0))
    rconst = rate_constants(clim, t, M, atm.p, sza, o3c, lwc)

    # Assemble concentrations [np, NVAR] in molec/cm^3
    q = dict(atm.q)
    cols = []
    for sp in VAR_SPECIES:
        if sp == "h2o":
            cols.append(h2o * M)
        elif sp == "o3":
            cols.append(o3 * M)
        elif sp in SPECIES_QNT and SPECIES_QNT[sp] in q:
            cols.append(q[SPECIES_QNT[sp]] * M)
        else:
            cols.append(jnp.zeros_like(M))
    c0 = jnp.stack(cols, axis=-1)
    # FIX order is (o2, h2, n2) per the mechanism tables
    fix = jnp.stack([0.2095 * M, 5e-7 * M, 0.7808 * M], axis=-1)

    c_final = jax.vmap(integrate, in_axes=(0, 0, 0, None))(
        c0, fix, rconst, ctl.dt_kpp)

    # Write back (kpp_chem_output2atm, chem.kpp C_UTIL)
    for i, sp in enumerate(VAR_SPECIES):
        qnt = SPECIES_QNT.get(sp)
        if qnt and qnt in q:
            new = c_final[:, i] / M
            if qnt == "Cx" and "m" in q:
                # track SO2 mass loss like the reference couples Cx->m
                ratio = jnp.where(c0[:, i] > 0, c_final[:, i]
                                  / jnp.maximum(c0[:, i], 1e-30), 1.0)
                if "mloss_kpp" in q:
                    q["mloss_kpp"] = jnp.where(
                        active, q["mloss_kpp"]
                        + q["m"] * (1.0 - ratio), q["mloss_kpp"])
                q["m"] = jnp.where(active, q["m"] * ratio, q["m"])
            q[qnt] = jnp.where(active, new, q[qnt])
    return atm.replace(q=q)
