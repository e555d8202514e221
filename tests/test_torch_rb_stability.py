"""``linear_stability_analysis(base_T=...)`` on the port's coupled
``(u, T)`` propagator about the Rayleigh-Benard conduction state (the case
of ``tests/test_scalars.py``: Ra 2000, Pr 1, 4 x 2 elements at order 6):
the leading growth rate against the exact free-slip relation (<1.5 %, JAX's
gate) and against the JAX package's eigenvalues from the same seed.  Cut to
10 steps a matvec and k_dim 10 (JAX's test takes 40 and 24; the port's
plain CPU step is host-bound)."""

import numpy as np
import pytest
import torch

from nekstab_next_tpu.algorithms.stability import (
    linear_stability_analysis as jax_linear_stability_analysis,
)
from nekstab_next_tpu.cases.rayleigh_benard import RayleighBenardCase as JaxRB
from nekstab_next_tpu_torch.algorithms.stability import (
    coupled_space,
    linear_stability_analysis,
)
from nekstab_next_tpu_torch.cases.rayleigh_benard import (
    K_CRITICAL,
    RA_CRITICAL,
    RayleighBenardCase,
    growth_rate_freeslip,
)
from nekstab_next_tpu_torch.interop import thermal_case_arrays, thermal_case_from_arrays

NSTEPS = 10
EIGS = dict(k_dim=10, nev=1, tol=1e-8, max_restarts=10)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread and no ``opt_einsum`` path search while this
    module runs (the test suite runs several worker processes at once)."""
    threads = torch.get_num_threads()
    opt = torch.backends.opt_einsum.enabled
    torch.set_num_threads(1)
    torch.backends.opt_einsum.enabled = False
    yield
    torch.set_num_threads(threads)
    torch.backends.opt_einsum.enabled = opt


def test_exact_relation_constants():
    """The neutral curve's minimum and the growth rates the chip check uses."""
    assert abs(RA_CRITICAL - 657.5113644795163) < 1e-9
    assert growth_rate_freeslip(RA_CRITICAL, 1.0, K_CRITICAL) == pytest.approx(0.0, abs=1e-9)
    assert growth_rate_freeslip(2000.0, 1.0, K_CRITICAL) == pytest.approx(11.0155, abs=1e-4)
    # the rung's box, eight critical wavelengths wide: admissible k = m k_c / 8
    assert growth_rate_freeslip(2000.0, 1.0, 10 * K_CRITICAL / 8) == pytest.approx(12.0372, abs=1e-4)
    assert growth_rate_freeslip(2000.0, 1.0, 11 * K_CRITICAL / 8) == pytest.approx(11.9756, abs=1e-4)


def test_rb_growth_rate_matches_exact_and_jax():
    jcase = JaxRB()
    case = thermal_case_from_arrays(RayleighBenardCase(device="cpu"), thermal_case_arrays(jcase))
    res = linear_stability_analysis(case.make_ns(), case.base_u, horizon=NSTEPS * case.dt,
                                    nsteps=NSTEPS, base_T=case.base_T, **EIGS)
    sigma, exact = float(np.real(res.lam[0])), case.exact_growth_rate()
    assert abs(sigma - exact) < 0.015 * abs(exact), (sigma, exact)
    assert abs(float(np.imag(res.lam[0]))) < 1e-3  # a stationary mode
    ref = jax_linear_stability_analysis(jcase.make_ns(), jcase.base_u,
                                        horizon=NSTEPS * jcase.dt, nsteps=NSTEPS,
                                        base_T=jcase.base_T, **EIGS)
    assert res.n_matvecs == ref.n_matvecs
    assert abs(res.lam[0] - ref.lam[0]) <= 1e-8 * abs(ref.lam[0])
    # modes come back as unit (u, T) pairs, with no spurious filter
    (re, im), = res.modes
    assert isinstance(re, tuple) and re[1].shape == case.base_T.shape
    space = coupled_space(case.sem)
    assert float(space.dot(re, re) + space.dot(im, im)) == pytest.approx(1.0, abs=1e-12)
    assert res.mode_gradient_norms is None and res.spurious is None
