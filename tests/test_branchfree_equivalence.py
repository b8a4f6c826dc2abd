"""Branch-free masked math vs literal control flow.

The JAX implementation rewrites every data-dependent branch of the
reference as masked arithmetic (warm-layer early-exit cascade, LKB lookup
loop, skin-layer regimes).  These tests drive the scalar control-flow
oracles (tests/oracle/, transcribed branch by branch from
mod_skin_coare.f90 / mod_phymbl.f90) against the vectorized branch-free
versions over randomized inputs that hit every branch.

The whole-algorithm oracles live in test_oracle_ocean.py /
test_oracle_ice.py; this file keeps focused component-level coverage of
the two nastiest control-flow rewrites (WL_COARE, z0tq_LKB).
"""

import jax.numpy as jnp
import numpy as np

from aerobulk_tpu.skin import SkinState, wl_coare
from aerobulk_tpu.thermo import z0tq_lkb

from oracle import HITS, reset_hits
from oracle.phymbl import z0tq_lkb as z0tq_lkb_scalar
from oracle.skin import wl_coare as wl_coare_scalar


def test_wl_coare_branchfree_equivalence():
    rng = np.random.default_rng(123)
    n = 4000
    Qsw = np.where(rng.random(n) < 0.3, 0.0, 900.0 * rng.random(n))
    Qnsol = -250.0 + 300.0 * rng.random(n)
    Tau = 0.3 * rng.random(n)
    sst = 272.0 + 30.0 * rng.random(n)
    lon = 360.0 * rng.random(n) - 90.0
    isd = int(rng.integers(0, 86400))
    dT0 = np.where(rng.random(n) < 0.4, 0.0, 2.0 * rng.random(n))
    Hz0 = 0.05 + 25.0 * rng.random(n)
    qac0 = np.where(rng.random(n) < 0.3, 0.0, 3.0e6 * rng.random(n))
    tac0 = np.where(qac0 == 0.0, 0.0, 500.0 * rng.random(n))

    st = SkinState(dT_wl=jnp.asarray(dT0), Hz_wl=jnp.asarray(Hz0),
                   Qnt_ac=jnp.asarray(qac0), Tau_ac=jnp.asarray(tac0))
    new = wl_coare(jnp.asarray(Qsw), jnp.asarray(Qnsol), jnp.asarray(Tau),
                   jnp.asarray(sst), jnp.asarray(lon), isd, st)

    reset_hits()
    exp = np.array([wl_coare_scalar(Qsw[i], Qnsol[i], Tau[i], sst[i],
                                    lon[i], isd, 0,
                                    (dT0[i], Hz0[i], qac0[i], tac0[i]))
                    for i in range(n)])
    np.testing.assert_allclose(np.asarray(new.dT_wl), exp[:, 0], rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(np.asarray(new.Hz_wl), exp[:, 1], rtol=1e-12)
    np.testing.assert_allclose(np.asarray(new.Qnt_ac), exp[:, 2], rtol=1e-12)
    np.testing.assert_allclose(np.asarray(new.Tau_ac), exp[:, 3], rtol=1e-12)
    # every branch of the cascade exercised
    for key in ("wl_dawn_reset", "wl_never_started", "wl_drained",
                "wl_built", "wl_inner_exit"):
        assert HITS[key] > 0, (key, dict(HITS))


def test_z0tq_lkb_branchfree_equivalence():
    rng = np.random.default_rng(7)
    rer = np.concatenate([
        10.0 ** rng.uniform(-3, 3.2, 2000),
        np.asarray([0.0, 0.11, 0.825, 3.0, 10.0, 30.0, 100.0, 300.0,
                    999.9999, 1000.0, 1500.0, 1e-9]),
    ])
    z0 = 10.0 ** rng.uniform(-6, -2, rer.shape[0])
    reset_hits()
    for iflag in (1, 2):
        got = np.asarray(z0tq_lkb(iflag, jnp.asarray(rer), jnp.asarray(z0)))
        exp = np.array([z0tq_lkb_scalar(iflag, rer[i], z0[i])
                        for i in range(len(rer))])
        np.testing.assert_allclose(got, exp, rtol=1e-12)
    assert HITS["lkb_out_of_range"] > 0
