"""Hot cross-section table: physical limits and interpolation."""
import jax.numpy as jnp
import numpy as np
import pytest

from mcrat_tpu.config import Config, NonthermalDist, TauCalculation
from mcrat_tpu.constants import KB_OVER_MEC2
from mcrat_tpu.ops import hot_xsec
from mcrat_tpu.ops.compton import kn_cross_section


@pytest.fixture(scope="module")
def thermal_table(tmp_path_factory):
    cfg = Config(dtype="float64")
    path = tmp_path_factory.mktemp("xsec") / "hot.npz"
    return hot_xsec.load_or_build(cfg, str(path), dtype="float64"), str(path), cfg


def test_cold_limit_is_kn(thermal_table):
    """theta -> 0: sigma_hat -> sigma_KN(eps') for all photon energies."""
    table, _, _ = thermal_table
    e = jnp.asarray(10.0 ** np.linspace(-8, 2, 13))
    temp = jnp.full(e.shape, 10.0**-3.9 / KB_OVER_MEC2)  # just above table floor
    got = hot_xsec.interp_thermal(table, e, temp)
    want = kn_cross_section(e)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-2)


def test_hot_electrons_deepen_kn_suppression(thermal_table):
    """Relativistic electrons boost the photon energy in their rest frame, so
    at eps' where KN suppression begins, hot theta gives a smaller <sigma>
    than cold theta; deep in the Thomson regime both limits are ~1."""
    table, _, _ = thermal_table
    # deep Thomson regime: no suppression even for theta ~ 1 (gamma ~ few)
    e_low = jnp.asarray([1e-8])
    hot_low = hot_xsec.interp_thermal(table, e_low, jnp.asarray([1.0 / KB_OVER_MEC2]))
    assert float(hot_low[0]) == pytest.approx(1.0, rel=2e-2)
    # KN onset: hot electrons see eps gamma (1 - mu beta) >~ 1
    e = jnp.asarray([0.1])
    hot = hot_xsec.interp_thermal(table, e, jnp.asarray([1.0 / KB_OVER_MEC2]))  # theta=1
    cold = hot_xsec.interp_thermal(table, e, jnp.asarray([1e-3 / KB_OVER_MEC2]))
    assert float(cold[0]) == pytest.approx(float(kn_cross_section(e)[0]), rel=3e-2)
    assert float(hot[0]) < 0.75 * float(cold[0])


def test_below_floor_returns_plain_kn(thermal_table):
    table, _, _ = thermal_table
    e = jnp.asarray([1e-4, 1.0, 10.0])
    temp = jnp.full(e.shape, 1.0)  # absurdly cold => below table floor
    got = hot_xsec.interp_thermal(table, e, temp)
    np.testing.assert_allclose(np.asarray(got), np.asarray(kn_cross_section(e)), rtol=1e-12)


def test_out_of_range_recompute_matches_table(thermal_table):
    """Out-of-table lanes take the direct quadrature (reference recomputes the
    integral on the fly, hot_x_section.c:545-605): the direct integral must
    agree with the table interior, and out-of-range energies must continue the
    physical trend (sigma ~ const in deep Thomson, declining KN tail) instead
    of freezing at the clamped edge value."""
    table, _, _ = thermal_table
    # interior agreement: direct quadrature vs bilinear table
    e_in = jnp.asarray([1e-6, 1e-2, 1.0])
    theta_in = jnp.asarray([1e-2, 0.3, 2.0])
    direct = hot_xsec.direct_sigma_hat(e_in, theta_in)
    interp = hot_xsec.interp_thermal(table, e_in, theta_in / KB_OVER_MEC2)
    np.testing.assert_allclose(np.asarray(direct), np.asarray(interp), rtol=3e-2)

    # beyond the high-energy edge (log10 e > 6) sigma keeps FALLING; an edge
    # clamp would return the same value for both energies
    e_hi = jnp.asarray([10.0**6.5, 10.0**7.5])
    th = jnp.full(e_hi.shape, 0.1)
    got = np.asarray(hot_xsec.interp_thermal(table, e_hi, th / KB_OVER_MEC2))
    assert got[1] < 0.5 * got[0]
    # and tracks plain KN at these energies within the hot correction
    kn = np.asarray(kn_cross_section(e_hi))
    np.testing.assert_allclose(got, kn, rtol=0.6)

    # beyond the hot edge (theta > 1e4) the suppression keeps deepening
    e = jnp.asarray([1e-3, 1e-3])
    th2 = jnp.asarray([10.0**3.9, 10.0**4.5])
    got2 = np.asarray(hot_xsec.interp_thermal(table, e, th2 / KB_OVER_MEC2))
    assert got2[1] < got2[0]


def test_cache_roundtrip(thermal_table):
    table, path, cfg = thermal_table
    table2 = hot_xsec.load_or_build(cfg, path, dtype="float64")
    np.testing.assert_array_equal(np.asarray(table.thermal), np.asarray(table2.thermal))


def test_nonthermal_table_monotone_kn():
    """Power-law subgroup cross sections decrease with subgroup gamma (deeper
    KN suppression for more energetic electrons)."""
    cfg = Config(
        dtype="float64",
        tau_calculation=TauCalculation.TABLE,
        nonthermal_e_dist=NonthermalDist.POWERLAW,
        powerlaw_index=2.5,
        gamma_min=1.0,
        gamma_max=100.0,
    )
    log_e, table = hot_xsec.build_nonthermal_table(cfg, n_gamma_nodes=64, n_mu_nodes=32)
    assert table.shape == (hot_xsec.N_PH_E + 1, cfg.n_gamma)
    # at moderate eps' the higher-gamma subgroups see larger eps in the rest
    # frame -> smaller sigma; but subgroup columns also carry the pdf fraction.
    # Check basic sanity: all finite, and values bounded by the subgroup pdf mass.
    vals = 10.0**table
    assert np.isfinite(vals).all()
    assert (vals <= 1.0 + 1e-9).all()
