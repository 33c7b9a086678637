"""Diabatic-zeta end-to-end golden parity vs the reference model
(reference analog tests/interoper_test/run.sh: MET_CLAMS 1,
MET_VERT_COORD 1, ADVECT_VERT_COORD 1; intpol_met_4d_zeta
mptrac.c:2808, diabatic advect block c:3680-3764, module_advect_init
c:3762).

``parity/golden_zeta`` is minted by parity/mint_zeta.sh: synthetic
CLaMS-convention met files (dims (time, lon, lat, lev), PRESS/ZETA/
ZETA_DOT_TOT/GPH variables, ``base_YYMMDDHH.nc`` names) drive 6 h of
pure diabatic advection (120 steps at DT_MOD 180, diffusion zeroed)
through the reference binary; the framework must match running the
exact same ctl + IC + met fixtures end-to-end through run_trac.
"""

import pathlib

import pytest

from test_full_parity import assert_tab_close, run_ours

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLD = REPO / "parity" / "golden_zeta" / "data"


@pytest.fixture(scope="module")
def zeta_run(tmp_path_factory):
    if not (GOLD / "trac.ctl").exists():
        pytest.skip("golden_zeta fixtures not minted")
    base = tmp_path_factory.mktemp("parity_zeta")
    import shutil
    data = base / "data"
    data.mkdir()
    for f in GOLD.glob("clams_*.nc"):
        shutil.copy(f, data / f.name)
    shutil.copy(GOLD / "trac.ctl", data / "trac.ctl")
    shutil.copy(GOLD / "atm_init.tab", data / "atm_init.tab")
    import os
    from mptrac_tpu.sim import run_trac
    cwd = os.getcwd()
    os.chdir(base)
    try:
        run_trac("data", "trac.ctl", "atm_init.tab",
                 ["ATM_BASENAME", "atm"])
    finally:
        os.chdir(cwd)
    return data


@pytest.mark.parametrize("stamp", ["00_00_00", "03_00_00", "06_00_00"])
def test_zeta_atm(zeta_run, stamp):
    """Positions after 0/60/120 diabatic-zeta steps: lon/lat/z to
    1e-4 deg / 1e-4 km; zeta and diagnosed quantities to %g format
    precision scale."""
    f = f"atm_2016_07_01_{stamp}.tab"
    assert_tab_close(
        zeta_run / f, GOLD / f,
        col_tol={0: (0, 0), 1: (0, 1e-4), 2: (0, 1e-4), 3: (0, 1e-4)},
        default=(1e-4, 1e-4))


@pytest.mark.chip
@pytest.mark.parametrize("stamp", ["00_00_00", "03_00_00", "06_00_00"])
def test_zeta_atm_on_chip(chip, zeta_run, stamp):
    """The same golden check with run_trac on the GPU."""
    test_zeta_atm(zeta_run, stamp)
