"""bench.py's guard and its driver-point timing, at small sizes on the CPU."""
import os
import subprocess
import sys

import pytest

import bench
import chip_smoke
from mcrat_tpu import driver
from mcrat_tpu.config import Config, Dims, Geometry, SimType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench.py")],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode != 0
    assert '"metric"' not in out.stdout


@pytest.mark.parametrize("write_outputs", [True, False], ids=["outputs", "no_outputs"])
def test_time_run_rank_counts(write_outputs):
    """The driver point reads its counts from the driver's per-frame log, so
    they do not depend on whether the run writes its outputs."""
    cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                 simulation_type=SimType.SPHERICAL_OUTFLOW)
    par = chip_smoke.main_path_par(1000, 2000)
    el, n_scatt, n_live = bench._time_run_rank(
        cfg, par, driver.default_synthetic_factory(cfg, par), write_outputs)
    assert el > 0
    assert 1000 <= n_live <= 2000
    # same seeds either way: the same scatterings
    assert n_scatt == bench._time_run_rank(
        cfg, par, driver.default_synthetic_factory(cfg, par), not write_outputs)[1]
    assert n_scatt > 0
