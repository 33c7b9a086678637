"""Production driver and platform handling: the packed fast path with
re-sorting through Simulation.run, rejected options, the compile
cache location, and start-up without the requested platform."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _sim(tmp_path, *extra):
    from mptrac_tpu import read_ctl
    from mptrac_tpu.met.synthetic import make_wind_met
    from mptrac_tpu.met.write_nc import write_met_nc
    from mptrac_tpu.sim import Simulation
    from mptrac_tpu.types import Atm

    for hour in (0, 1, 2):
        fn = tmp_path / f"wind_2000_01_01_{hour:02d}.nc"
        if not fn.exists():
            write_met_nc(str(fn), make_wind_met(t0=3600.0 * hour, nx=36,
                                                ny=19, nz=8, alpha=30.0),
                         drop_wrap_column=True)
    ctl = read_ctl(None, [
        "NQ", "2", "QNT_NAME[0]", "idx", "QNT_NAME[1]", "t",
        "METBASE", str(tmp_path / "wind"), "DT_MET", "3600",
        "MET_TROPO", "0", "MET_CAPE", "0", "DIFFUSION", "0",
        "DT_MOD", "300", "T_STOP", "7200", *extra])
    n = 400
    rng = np.random.default_rng(9)
    atm = Atm.zeros(n, ctl.qnt_name).replace(
        time=jnp.zeros(n),
        lon=jnp.asarray(rng.uniform(-170, 170, n)),
        lat=jnp.asarray(rng.uniform(-80, 80, n)),
        p=jnp.asarray(rng.uniform(200, 900, n)),
        np=jnp.asarray(n, jnp.int32))
    atm.q["idx"] = jnp.arange(n, dtype=jnp.float64)
    return Simulation(ctl, atm, dirname=str(tmp_path))


def test_run_fast_sorted_matches_exact(tmp_path):
    """TPU_FAST 1 with SORT_DT re-sorting, through two met swaps,
    against the exact path without sorting: same parcels (matched by
    idx) to f32 interpolation tolerance."""
    exact = _sim(tmp_path, "TPU_FAST", "0").run(write_output=False)
    sim = _sim(tmp_path, "TPU_FAST", "1", "SORT_DT", "1800")
    fast = sim.run(write_output=False)
    oe = np.argsort(np.asarray(exact.q["idx"]))
    of = np.argsort(np.asarray(fast.q["idx"]))
    # the sort really permuted the parcels
    assert not np.array_equal(of, oe)

    def col(a, f, o):
        return np.asarray(getattr(a, f) if f != "t" else a.q["t"])[o]
    dlon = np.abs((col(fast, "lon", of) - col(exact, "lon", oe) + 180)
                  % 360 - 180)
    assert dlon.max() < 5e-3
    np.testing.assert_allclose(col(fast, "lat", of),
                               col(exact, "lat", oe), rtol=0, atol=5e-3)
    np.testing.assert_allclose(col(fast, "p", of), col(exact, "p", oe),
                               rtol=1e-4)
    np.testing.assert_allclose(col(fast, "t", of), col(exact, "t", oe),
                               rtol=1e-5)


def test_tpu_fast_2_rejected():
    from mptrac_tpu import read_ctl
    assert read_ctl(None, ["TPU_FAST", "1"]).tpu_fast == 1
    with pytest.raises(ValueError, match="fused RK kernel.*removed"):
        read_ctl(None, ["TPU_FAST", "2"])


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(from_env, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set; otherwise the
    cache goes to <checkout>/.jax_cache."""
    from mptrac_tpu.utils.compile_cache import enable_compile_cache
    before = jax.config.jax_compilation_cache_dir
    try:
        if from_env:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = enable_compile_cache()
            assert path == str(REPO / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_unregistered_platform_raises():
    """No silent CPU fallback when the requested platform is absent."""
    env = dict(os.environ, JAX_PLATFORMS="nosuchplatform")
    r = subprocess.run(
        [sys.executable, "-c",
         "import mptrac_tpu, jax; print(jax.devices()[0].platform)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "cpu" not in r.stdout
    assert "nosuchplatform" in r.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_needs_gpu_and_checkout(alone, tmp_path):
    """chip_smoke.py fails, and prints no result line, on the CPU and
    in a directory without the rest of the checkout."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_worker_cards(monkeypatch):
    """One GPU per trac worker process, capped at the visible GPUs."""
    from mptrac_tpu.tools.trac import worker_cards
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    assert worker_cards(4) == ["3", "5"]
    assert worker_cards(1) == ["3"]
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert worker_cards(3) == [None, None, None]
