"""Functional-transform composition: vmap ensembles and second-order AD.

jit / grad / remat / shard_map coverage lives in test_grad.py and the
sharding tests; this module pins the remaining two transforms a
JAX framework owes its users:

* ``jax.vmap`` over *parameters* — a K-member physics ensemble (K
  Charnock laws) through the full fixed-point solve in one batched
  call, the idiomatic replacement for the reference's
  recompile-per-namelist workflow;
* second-order AD (``jax.hessian``) through the solve — what Laplace /
  Gauss-Newton uncertainty quantification of a flux calibration needs.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# depth tests: vmap ensembles + hessians — deselect with -m 'not slow' (make test-fast)
pytestmark = pytest.mark.slow


def _load_example():
    path = pathlib.Path(__file__).parent.parent / "examples" / \
        "calibrate_charnock.py"
    spec = importlib.util.spec_from_file_location("calibrate_charnock", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_vmap_charnock_ensemble_matches_loop():
    """A K-member Charnock-law ensemble via one vmap over the full
    COARE 3.6 solve equals the member-by-member loop to fp64 roundoff
    (jit fusion may reassociate, so not bitwise), and the ensemble
    actually spreads (different laws -> different stresses)."""
    mod = _load_example()
    obs = mod.make_campaign(n=128, seed=11)

    params = jnp.array([[1.0e-3, 0.0], [1.7e-3, -5.0e-3],
                        [2.4e-3, 2.0e-3], [1.2e-3, 8.0e-3]])   # (K, 2)

    def member(p):
        charn = lambda w: jnp.clip(p[0] * w + p[1], 0.0, 0.028)  # noqa: E731
        tau, qh, ql = mod.fluxes(obs, charn_fn=charn)
        return jnp.stack([tau, qh, ql])

    batched = jax.jit(jax.vmap(member))(params)          # (K, 3, n)
    looped = jnp.stack([member(p) for p in params])
    np.testing.assert_allclose(np.asarray(batched), np.asarray(looped),
                               rtol=1e-12, atol=1e-12)

    tau_spread = np.asarray(batched)[:, 0].std(axis=0)
    assert tau_spread.max() > 1e-4, "ensemble members did not differ"


def test_hessian_through_solve_is_sane():
    """jax.hessian of the flux-mismatch loss w.r.t. the Charnock (slope,
    offset), THROUGH the 5-iteration bulk solve: finite, symmetric,
    positive-definite at the optimum, and matching central finite
    differences of jax.grad."""
    mod = _load_example()
    obs = mod.make_campaign(n=64, seed=5)
    tau_o, qh_o, ql_o = mod.fluxes(obs)                  # truth forcing

    def loss(p):
        charn = lambda w: jnp.clip(p[0] * w + p[1], 0.0, 0.028)  # noqa: E731
        tau, qh, ql = mod.fluxes(obs, charn_fn=charn)
        return ((tau - tau_o) ** 2 + (qh - qh_o) ** 2
                + (ql - ql_o) ** 2).mean()

    p0 = jnp.array([mod.TRUE_SLOPE, mod.TRUE_OFFSET])
    H = np.asarray(jax.hessian(loss)(p0))

    assert np.all(np.isfinite(H))
    np.testing.assert_allclose(H, H.T, rtol=1e-10)
    evals = np.linalg.eigvalsh(H)
    assert evals.min() > 0.0, f"Hessian not PD at the optimum: {evals}"

    g = jax.grad(loss)
    eps = 1e-7
    for j in range(2):
        e = jnp.zeros(2).at[j].set(eps)
        fd_col = (np.asarray(g(p0 + e)) - np.asarray(g(p0 - e))) / (2 * eps)
        np.testing.assert_allclose(H[:, j], fd_col,
                                   rtol=5e-5, atol=1e-8 * abs(H).max())
