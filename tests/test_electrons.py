"""Thermal electron sampler validation.

The reference has no unit test for its Maxwell-Juttner sampler
(sampleThermalElectron, Src/electron.c:202-237); these tests validate the
mcrat_tpu sampler's first two moments against direct quadrature of the MJ
density across the nonrelativistic -> ultrarelativistic range, plus the
electron-photon relative-angle law used by the scattering rate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcrat_tpu.constants import KB_OVER_MEC2
from mcrat_tpu.ops import electrons


def mj_moments(theta):
    """E[xi], E[xi^2] of the MJ density in xi = (gamma-1)/theta by quadrature."""
    xi = np.linspace(1e-8, 400.0, 4_000_001)
    a = theta * xi
    # log-space for stability: f = (1+a) sqrt(a(2+a)) e^-xi
    logf = np.log1p(a) + 0.5 * (np.log(a) + np.log(2.0 + a)) - xi
    f = np.exp(logf - logf.max())
    z = np.trapezoid(f, xi)
    m1 = np.trapezoid(xi * f, xi) / z
    m2 = np.trapezoid(xi * xi * f, xi) / z
    return m1, m2


@pytest.mark.parametrize(
    "temp",
    [1e5, 1e7, 1e9, 1e10, 1e11],
    ids=["nonrel", "threshold", "trans-rel", "relativistic", "ultra-rel"],
)
def test_maxwell_juttner_moments(temp):
    theta = KB_OVER_MEC2 * temp
    n = 200_000
    key = jax.random.PRNGKey(42)
    t = jnp.full((n,), temp, jnp.float64)
    gamma, gb = electrons.sample_thermal_gamma_beta(key, t)
    xi = np.asarray((gamma - 1.0) / theta)
    m1, m2 = mj_moments(theta)
    se1 = np.sqrt(max(m2 - m1 * m1, 1e-30) / n)
    assert abs(xi.mean() - m1) < 5.0 * se1 + 1e-3 * m1, (temp, xi.mean(), m1)
    # gamma*beta consistency: gb^2 == gamma^2 - 1
    np.testing.assert_allclose(
        np.asarray(gb) ** 2, np.asarray(gamma) ** 2 - 1.0, rtol=1e-10, atol=1e-12
    )
    # nonrelativistic limit: xi is chi^2_3 / 2, i.e. Maxwell-Boltzmann energies
    if temp <= 1e5:
        assert abs(xi.mean() - 1.5) < 0.02


def test_mixed_temperature_batch():
    """One batch spanning 6 decades of temperature samples every lane correctly
    (the old envelope stalled whole-batch rejection at high theta)."""
    key = jax.random.PRNGKey(7)
    temps = np.logspace(5, 11, 120_000)
    gamma, gb = electrons.sample_thermal_gamma_beta(key, jnp.asarray(temps))
    gamma = np.asarray(gamma)
    assert np.all(np.isfinite(gamma)) and np.all(gamma >= 1.0)
    # hottest decade: mean xi should be ~3 (Gamma(3) limit), far from the
    # fallback init 1.5 that a stalled rejection would produce
    hot = temps > 1e10
    xi_hot = (gamma[hot] - 1.0) / (KB_OVER_MEC2 * temps[hot])
    assert 2.7 < xi_hot.mean() < 3.3, xi_hot.mean()


def test_electron_relative_angle_law():
    """cos(theta_rel) follows (1 - beta cos t) sin t / (2) exactly (inverse CDF,
    reference: Src/electron.c:196)."""
    key = jax.random.PRNGKey(3)
    beta = jnp.full((400_000,), 0.9, jnp.float64)
    c = np.asarray(electrons.sample_electron_cos_theta(key, beta))
    # analytic CDF: F(c) = [ (1 - beta c)^2 - (1+beta)^2 ] / ( -4 beta )
    grid = np.linspace(-0.999, 0.999, 21)
    emp = np.searchsorted(np.sort(c), grid) / len(c)
    ana = ((1.0 - 0.9 * grid) ** 2 - (1.0 + 0.9) ** 2) / (-4.0 * 0.9)
    np.testing.assert_allclose(emp, ana, atol=5e-3)


def test_thermal_sampler_finite_when_uniform_products_underflow(monkeypatch):
    """A float32 product of uniforms can flush to 0; the Maxwell-Juttner
    proposal must not turn that into an infinite-gamma electron."""
    import jax.numpy as jnp

    from mcrat_tpu.ops import electrons

    tiny = jnp.finfo(jnp.float32).tiny
    # words: three proposal uniforms, the mixture pick (0.75 selects the
    # Gamma(2) product u0 * u1 = tiny^2 -> 0), the acceptance uniform
    words = jnp.asarray([tiny, tiny, tiny, 0.75, tiny], jnp.float32)
    monkeypatch.setattr(
        electrons, "uniform_pos",
        lambda key, shape, dtype: jnp.broadcast_to(words, shape).astype(dtype),
    )
    g, gb = electrons.sample_thermal_gamma_beta(
        jax.random.PRNGKey(0), jnp.full((8,), 1e5, jnp.float32)
    )
    assert np.isfinite(np.asarray(g)).all() and np.isfinite(np.asarray(gb)).all()
