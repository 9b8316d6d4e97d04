"""The port's coefficient derivations (``naturaldiffusion_tpu_torch.coeffs``
and ``schedules``) against the JAX package's and against the golden matrices
the repository keeps under ``results/corpus/``.

All of it is numpy float64: the same recursions as the JAX package, so the
two registries agree to 1e-12.  The golden npz files were written by the
reference's SymPy/analytic analyzers; the tolerances are the JAX package's
own (``tests/test_golden_matrices.py``): 1e-8, and 2e-4 for DEIS, whose
reference quadrature ran in float32.
"""

import glob
import os
from pathlib import Path

import numpy as np
import pytest

from naturaldiffusion_tpu import schedules as jax_schedules
from naturaldiffusion_tpu.coeffs import registry as jax_registry
from naturaldiffusion_tpu.coeffs import reverse_diffusion as jax_rd
from naturaldiffusion_tpu.coeffs import sd3 as jax_sd3
from naturaldiffusion_tpu_torch import schedules
from naturaldiffusion_tpu_torch.coeffs import registry
from naturaldiffusion_tpu_torch.coeffs import reverse_diffusion, sd3
from naturaldiffusion_tpu_torch.coeffs.matrix import CoeffMatrix
import torch_port_util  # noqa: F401  binds torch's CPU math first

CORPUS = Path(__file__).resolve().parent.parent / "results" / "corpus"
JAX_TOL = 1e-12
GOLDEN_TOL = {"deis_tab": 2e-4}
GOLDEN_DEFAULT_TOL = 1e-8


def _assert_matrices_close(got, want, tol):
    for f in ("x0", "eps", "node"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape, (f, a.shape, b.shape)
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=f)


def test_registry_names_and_specs_equal_jax():
    assert list(registry.DERIVERS) == list(jax_registry.DERIVERS)
    assert len(registry.DERIVERS) == 14
    for name, spec in registry.DERIVERS.items():
        js = jax_registry.DERIVERS[name]
        assert (spec.step_counts, spec.result_dir, spec.prefix,
                spec.rows_per_step) == (js.step_counts, js.result_dir,
                                        js.prefix, js.rows_per_step), name


@pytest.mark.parametrize("name,steps", [
    pytest.param(name, n, id=f"{name}-{n}")
    for name, spec in jax_registry.DERIVERS.items()
    for n in spec.step_counts])
def test_derivation_equals_jax(name, steps):
    got = registry.derive(name, steps)
    want = jax_registry.derive(name, steps)
    assert got.num_step == steps * registry.DERIVERS[name].rows_per_step
    _assert_matrices_close(got, want, JAX_TOL)
    assert got.is_deterministic == want.is_deterministic


def _golden_cases():
    cases = []
    for name, spec in jax_registry.DERIVERS.items():
        pattern = str(CORPUS / spec.result_dir / f"{spec.prefix}_*.npz")
        for path in sorted(glob.glob(pattern)):
            suffix = os.path.basename(path)[:-4][len(spec.prefix) + 1:]
            if suffix.isdigit():
                rows = int(suffix)
                cases.append(pytest.param(
                    name, round(rows / spec.rows_per_step), path,
                    id=f"{name}-{rows}"))
    return cases


GOLDEN = _golden_cases()


def test_corpus_holds_every_derivation():
    """The corpus names every derivation, so no name goes unchecked."""
    assert {c.values[0] for c in GOLDEN} == set(registry.DERIVERS)
    assert len(GOLDEN) >= 50


@pytest.mark.parametrize("name,steps,path", GOLDEN)
def test_derivation_matches_golden_corpus(name, steps, path):
    got = registry.DERIVERS[name].fn(steps)
    want = CoeffMatrix.load(path)
    _assert_matrices_close(got, want,
                           GOLDEN_TOL.get(name, GOLDEN_DEFAULT_TOL))


@pytest.mark.parametrize("name", [n for n in jax_registry.DERIVERS
                                  if "analytic" not in n])
def test_marginal_invariant_outside_the_corpus(name):
    """At 30 steps, a count no golden file has: row sums of x0 track alpha_t
    and eps row norms sigma_t; only flow matching is exact, the rest are
    discretisations within a few percent (the JAX test's bounds)."""
    cm = registry.derive(name, 30)
    sig_err, noi_err = cm.marginal_errors()
    want_sig, want_noi = jax_registry.derive(name, 30).marginal_errors()
    np.testing.assert_allclose(sig_err, want_sig, atol=JAX_TOL, rtol=0)
    np.testing.assert_allclose(noi_err, want_noi, atol=JAX_TOL, rtol=0)
    tol = {"flow_euler": 1e-12}.get(name, 0.1)
    assert sig_err.max() < tol and noi_err.max() < tol


@pytest.mark.parametrize("pair", [
    ("derive_ddpm", "derive_ddpm_analytic"),
    ("derive_ddim", "derive_ddim_analytic"),
])
def test_analytic_and_affine_agree(pair):
    """The two DDPM/DDIM derivations cross-check (reference
    ``src/AnalyzeDDPMDDIM.py:446-453``); node rows differ only in the
    analytic path's hard-coded start row."""
    from naturaldiffusion_tpu_torch.coeffs import ddpm_ddim
    a, b = (getattr(ddpm_ddim, f)(12) for f in pair)
    np.testing.assert_allclose(a.x0, b.x0, atol=1e-10)
    np.testing.assert_allclose(a.eps, b.eps, atol=1e-10)
    np.testing.assert_allclose(a.node[1:], b.node[1:], atol=1e-10)


def test_linear_vpsde_equals_jax():
    t = np.linspace(1e-3, 1.0, 17)
    a, b = schedules.LinearVPSDE(), jax_schedules.LinearVPSDE()
    for f in ("beta", "log_alpha", "alpha", "sigma", "lam", "t2alpha",
              "t2rho", "d_log_alpha_bar_dt"):
        np.testing.assert_allclose(getattr(a, f)(t), getattr(b, f)(t),
                                   atol=JAX_TOL, rtol=0, err_msg=f)
    lam = a.lam(t)
    np.testing.assert_allclose(a.inverse_lam(lam), b.inverse_lam(lam),
                               atol=JAX_TOL, rtol=0)
    np.testing.assert_allclose(a.inverse_lam(lam), t, atol=1e-9)
    rho = a.t2rho(t)
    np.testing.assert_allclose(a.rho2t(rho), b.rho2t(rho), atol=JAX_TOL)
    ab = a.t2alpha(t)
    np.testing.assert_allclose(a.alpha2t(ab), b.alpha2t(ab), atol=JAX_TOL)


def test_piecewise_vpsde_equals_jax():
    betas = np.linspace(0.1 / 1000, 20.0 / 1000, 1000)
    a = schedules.PiecewiseVPSDE.from_betas(betas)
    b = jax_schedules.PiecewiseVPSDE.from_betas(betas)
    assert (a.T, a.sampling_eps) == (b.T, b.sampling_eps)
    t = np.linspace(10.0, 990.0, 9)
    for f in ("t2alpha", "t2rho", "d_log_alpha_bar_dt", "log_alpha"):
        np.testing.assert_allclose(getattr(a, f)(t), getattr(b, f)(t),
                                   atol=JAX_TOL, rtol=0, err_msg=f)
    ab, rho = a.t2alpha(t), a.t2rho(t)
    np.testing.assert_allclose(a.alpha2t(ab), b.alpha2t(ab), atol=JAX_TOL)
    np.testing.assert_allclose(a.rho2t(rho), b.rho2t(rho), atol=JAX_TOL)


@pytest.mark.parametrize("order", [1.0, 2.0, 3.0])
def test_flow_sigmas_and_deis_grid_equal_jax(order):
    np.testing.assert_array_equal(schedules.flow_sigmas(12),
                                  jax_schedules.flow_sigmas(12))
    got = schedules.deis_rev_ts(schedules.LinearVPSDE(), 12, order)
    want = jax_schedules.deis_rev_ts(jax_schedules.LinearVPSDE(), 12, order)
    np.testing.assert_allclose(got, want, atol=JAX_TOL, rtol=0)


@pytest.mark.parametrize("fn", ["sde_equivalent_coeff",
                                "ode_equivalent_coeff"])
@pytest.mark.parametrize("skip", [1, 10])
def test_reverse_diffusion_equals_jax(fn, skip):
    got = getattr(reverse_diffusion, fn)(skip_step=skip, stride=10)
    want = getattr(jax_rd, fn)(skip_step=skip, stride=10)
    np.testing.assert_allclose(got, want, atol=JAX_TOL, rtol=0)


@pytest.mark.parametrize("cliplen", [0, 5])
def test_sd3_weights_equal_jax(cliplen):
    ts, sig = sd3.flow_match_sigmas(28)
    jts, jsig = jax_sd3.flow_match_sigmas(28)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(sig, jsig)
    w = sd3.sd3_euler_weights(28, cliplen=cliplen)
    np.testing.assert_array_equal(w, jax_sd3.sd3_euler_weights(
        28, cliplen=cliplen))
    _assert_matrices_close(sd3.sd3_weight_matrix(w),
                           jax_sd3.sd3_weight_matrix(w), JAX_TOL)
    with pytest.raises(ValueError, match="all-zero row"):
        sd3.sd3_weight_matrix(np.zeros((28, 28)))
