"""chip_smoke.py's guard, comparison and phases, and the compile-cache helper.

The smoke script's phases run here on the CPU at small populations; the
``gpu``-marked test runs them on a card.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from mcrat_tpu import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_guard_exits_nonzero_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "fallback"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(ROOT, ".jax_cache")
    assert runtime.compile_cache_dir() == want
    before = jax.config.jax_compilation_cache_dir
    try:
        assert runtime.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _population(rng, tail, n=20_000):
    """A narrow lognormal spectrum, or a nonthermal-like one: seed photons
    upscattered by gamma^2 with gamma drawn from a p = 2.5 power law on
    [1, 100], spanning four decades."""
    e = np.exp(rng.normal(-3.0, 0.6, n))
    if tail:
        gamma = (1.0 - rng.uniform(size=n) * (1.0 - 100.0 ** -1.5)) ** (-1.0 / 1.5)
        e = e * gamma**2
    return dict(
        e=e, w=rng.uniform(1.0, 3.0, n),
        ns=rng.poisson(6.0, n).astype(float),
        q=rng.uniform(-0.3, 0.3, n), u=rng.uniform(-0.3, 0.3, n),
    )


@pytest.mark.parametrize("tail", [False, True], ids=["lognormal", "nonthermal"])
@pytest.mark.parametrize("shift", [1.0, 1.1], ids=["identical", "shifted_10pct"])
def test_population_comparison(shift, tail):
    ref = _population(np.random.default_rng(0), tail)
    test = dict(ref, e=ref["e"] * shift)
    rows = {name: d <= lim for name, d, lim in chip_smoke.compare_populations(ref, test)}
    if shift == 1.0:
        assert all(rows.values())
    else:
        assert not rows["mean_energy"]
        if not tail:
            assert not rows["tercile_fraction"]


@pytest.mark.parametrize("use_cli", [True, False], ids=["cli", "run_rank"])
def test_main_path_phase(tmp_path, use_cli):
    out = chip_smoke.run_main_path(str(tmp_path), 1000, 2000, use_cli=use_cli)
    assert 1000 <= out["n_photons"] <= 2000
    assert out["total_scatterings"] > 0
    assert ("population" in out) == use_cli


def test_float64_comparison_phase():
    chip_smoke.compare_with_cpu_float64(table=False)


def test_serial_oracle_phase():
    chip_smoke.compare_with_serial_oracle()


@pytest.mark.gpu
def test_correctness_phases_on_gpu(gpu):
    chip_smoke.compare_with_cpu_float64(table=False)
    chip_smoke.compare_with_cpu_float64(table=True)
    chip_smoke.compare_with_serial_oracle()


def test_trace_reduction_on_a_recorded_trace(tmp_path):
    """tools/profile_transport.device_op_times on a small CPU trace: the
    traced program's matmul shows up, and busy time fits in the window."""
    import glob
    import importlib.util

    import jax.numpy as jnp

    spec = importlib.util.spec_from_file_location(
        "profile_transport", os.path.join(ROOT, "tools", "profile_transport.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    f = jax.jit(lambda x: jnp.sin(x) @ x + 1.0)
    x = jnp.ones((256, 256))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    path = glob.glob(str(tmp_path / "plugins" / "profile" / "*" / "*.xplane.pb"))[0]
    red = mod.device_op_times(path, plane_name="/host:CPU",
                              line_prefixes=("tf_XLA",))
    assert any("dot" in o["name"] for o in red["ops"]), (red["lines"], red["ops"][:8])
    assert 0 < red["busy_ns"] <= red["window_ns"]
    assert red["op_total_ns"] >= red["busy_ns"]
