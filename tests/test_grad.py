"""Differentiability tests.

A capability the Fortran reference cannot offer: the whole flux pipeline
is differentiable, so flux sensitivities (dQ/dSST etc. — the quantities
GCM adjoints and data-assimilation systems need) come from ``jax.grad``.
Verified against finite differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aerobulk_tpu.api import AeroBulkConfig, flux_step


@pytest.mark.parametrize("algo", ["coare3p6", "ncar", "ecmwf"])
def test_flux_gradient_matches_finite_difference(algo):
    cfg = AeroBulkConfig(algo=algo, niter=5,
                         use_skin=(algo != "ncar"))

    def ql_of_sst(sst_scalar):
        sst = jnp.full((1,), sst_scalar)
        kw = {}
        if cfg.use_skin:
            kw = dict(rad_sw=jnp.full((1,), 200.0),
                      rad_lw=jnp.full((1,), 380.0), isecday_utc=43200)
        out, _ = flux_step(cfg, sst, jnp.full((1,), 293.15),
                           jnp.full((1,), 0.012), jnp.full((1,), 6.0),
                           jnp.zeros((1,)), jnp.full((1,), 101000.0), **kw)
        return out.QL[0]

    g = jax.grad(ql_of_sst)(295.15)
    eps = 1e-4
    fd = (ql_of_sst(295.15 + eps) - ql_of_sst(295.15 - eps)) / (2 * eps)
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), float(fd), rtol=2e-4)
    # more evaporation from a warmer ocean: dQL/dSST < 0 (QL is negative
    # and grows in magnitude)
    assert float(g) < 0.0


@pytest.mark.slow
def test_series_gradient_through_scan():
    """Gradients flow through the warm-layer state across time steps."""
    from aerobulk_tpu.api import run_series
    cfg = AeroBulkConfig(algo="coare3p6", niter=2, use_skin=True)
    nt, npts = 3, 2

    def total_ql(sst0):
        forcing = dict(
            sst=jnp.full((nt, npts), sst0),
            t_zt=jnp.full((nt, npts), 298.15),
            hum_zt=jnp.full((nt, npts), 0.015),
            U_zu=jnp.full((nt, npts), 4.0),
            V_zu=jnp.zeros((nt, npts)),
            slp=jnp.full((nt, npts), 101000.0),
            rad_sw=jnp.full((nt, npts), 600.0),
            rad_lw=jnp.full((nt, npts), 400.0))
        outs, _ = run_series(cfg, forcing,
                             isecday_utc=jnp.arange(10, 10 + nt) * 3600)
        return jnp.sum(outs.QL)

    g = jax.jit(jax.grad(total_ql))(300.15)
    assert np.isfinite(float(g)) and float(g) != 0.0


STABLE, UNSTABLE = +2.0, -3.0


@pytest.mark.parametrize("algo", ["coare3p0", "coare3p6", "ncar", "ecmwf",
                                  "andreas"])
@pytest.mark.parametrize("dt_air", [STABLE, UNSTABLE])
@pytest.mark.slow
def test_gradient_finite_both_stability_regimes(algo, dt_air):
    """jax.grad is finite on BOTH sides of neutral for every ocean algo.

    Regression guard for the ``MAX(x,0)**(2/3)`` gustiness clamp whose
    naive form had a NaN gradient at every stably-stratified point
    (thermo.pow23_pos) — i.e. over roughly half the ocean."""
    cfg = AeroBulkConfig(algo=algo, niter=5)

    def total_flux(sst_scalar):
        sst = jnp.full((3,), sst_scalar)
        out, _ = flux_step(cfg, sst, sst + dt_air,
                           jnp.full((3,), 0.010), jnp.full((3,), 7.0),
                           jnp.full((3,), 1.0), jnp.full((3,), 101000.0))
        return jnp.sum(out.QL + out.QH + out.Tau_x)

    g = float(jax.grad(total_flux)(290.0))
    assert np.isfinite(g) and g != 0.0


@pytest.mark.parametrize("algo", ["coare3p6", "ecmwf"])
@pytest.mark.slow
def test_gradient_finite_in_cooling_regime(algo):
    """Nighttime (rad_sw=0, net cooling) gradients are finite with the
    skin schemes on.

    Regression guard for the cool-skin viscous-layer solve
    (thermo.delta_skin_layer_from_coefs): its ``MAX(y, 0)`` clamp is
    active at every cooling point (zQd <= 0), where the naive
    ``sqrt(max(y, 0))`` had a NaN gradient — i.e. jax.grad through any
    skin-enabled solve was NaN over the whole nighttime ocean."""
    cfg = AeroBulkConfig(algo=algo, niter=5, use_skin=True)

    def total_flux(sst_scalar):
        sst = jnp.full((4,), sst_scalar)
        out, _ = flux_step(cfg, sst, sst - 1.5, jnp.full((4,), 0.012),
                           jnp.full((4,), 6.0), jnp.zeros((4,)),
                           jnp.full((4,), 101000.0),
                           rad_sw=jnp.zeros((4,)),          # night
                           rad_lw=jnp.full((4,), 320.0),
                           isecday_utc=3600)
        return jnp.sum(out.QL + out.QH + out.T_s)

    g = float(jax.grad(total_flux)(295.15))
    assert np.isfinite(g) and g != 0.0


@pytest.mark.slow
def test_fused_step_gradient_matches_jit_path():
    """The fused Pallas kernel is differentiable via its custom VJP
    (backward pass = AD of the jit semantics path, kernels/fused.py
    ``_fused_step_ad``); on CPU (interpret mode, fp64) the gradient of a
    nonlinear loss matches jax.grad through ``flux_step`` to fp64
    roundoff, and the primal is unchanged by the wrapping."""
    from aerobulk_tpu.kernels.fused import fused_flux_step

    cfg = AeroBulkConfig(algo="coare3p6", use_skin=True, niter=5)
    ny, nx = 8, 128
    rng = np.random.default_rng(0)
    sst = jnp.asarray(rng.uniform(275.0, 302.0, (ny, nx)))
    t = sst + jnp.asarray(rng.uniform(-3.0, 2.0, (ny, nx)))
    q = jnp.asarray(rng.uniform(0.002, 0.018, (ny, nx)))
    U = jnp.asarray(rng.uniform(1.0, 15.0, (ny, nx)))
    V = jnp.asarray(rng.uniform(-5.0, 5.0, (ny, nx)))
    slp = jnp.full((ny, nx), 101000.0)
    rsw, rlw = jnp.full((ny, nx), 400.0), jnp.full((ny, nx), 350.0)

    def loss_fused(s):
        (QL, QH, Tx, _, _, _), _ = fused_flux_step(
            cfg, s, t, q, U, V, slp, rsw, rlw, isecday_utc=43200,
            interpret=True)
        return jnp.sum(QL ** 2 + QH ** 2 + Tx ** 2) * 1e-6

    def loss_jit(s):
        out, _ = flux_step(cfg, s, t, q, U, V, slp, rad_sw=rsw,
                           rad_lw=rlw, isecday_utc=43200)
        return jnp.sum(out.QL ** 2 + out.QH ** 2 + out.Tau_x ** 2) * 1e-6

    v1, g1 = jax.value_and_grad(loss_fused)(sst)
    v2, g2 = jax.value_and_grad(loss_jit)(sst)
    assert bool(jnp.all(jnp.isfinite(g1)))
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-9)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-10)


def test_psi_gradients_finite_at_branch_knives():
    """Round-5 regression: every psi family computes its masked branch
    for all points, and ``sqrt``/``**frac`` of ``|1 - k*zeta|`` has an
    infinite slope exactly where the argument crosses zero — a zeta that
    always lies in the OTHER (masked) branch, so the forward is fine but
    the backward was ``inf * 0 = NaN``.  fp32 device rounding landed a real
    production point exactly on the 1/15 knife (1 in 1.04e6, caught by
    the on-device grad-parity gate).  All knives now carry the
    double-where guard (stability._pos_or_one/_ge_one); this pins a
    finite gradient AT every knife in both fp32 and fp64."""
    from aerobulk_tpu import stability as sb

    cases = {
        sb.psi_m_coare: (1.0 / 15.0, 1.0 / 10.15),
        sb.psi_h_coare: (1.0 / 15.0, 1.0 / 34.15, -1.5),
        sb.psi_m_ncar: (1.0 / 16.0,),
        sb.psi_h_ncar: (1.0 / 16.0,),
        sb.psi_m_ecmwf: (1.0 / 16.0,),
        sb.psi_h_ecmwf: (1.0 / 16.0, -1.5),
        sb.psi_m_andreas: (1.0 / 16.0, -1.0),
        sb.psi_h_andreas: (1.0 / 16.0,),
        sb.psi_m_ice: (1.0 / 16.0,),
        sb.psi_h_ice: (1.0 / 16.0,),
        sb.psi_m_grachev07: (1.0 / 16.0, -1.0, -1.3),
        sb.psi_h_grachev07: (1.0 / 16.0,),
    }
    for fn, knives in cases.items():
        for dtype in (jnp.float32, jnp.float64):
            # the knife plus representative points of both branches
            z = jnp.asarray(list(knives) + [-2.0, -1e-3, 1e-3, 2.0],
                            dtype)
            val, grad = jax.vmap(jax.value_and_grad(fn))(z)
            assert bool(jnp.all(jnp.isfinite(val))), (fn.__name__, val)
            assert bool(jnp.all(jnp.isfinite(grad))), (fn.__name__,
                                                       dtype, grad)


def test_alpha_sw_gradient_finite_at_clamp():
    """alpha_sw's MAX(.,0)**0.79 clamp pins to zero for sst <= 269.95 K;
    the gradient there must be 0, not NaN (round-5 double-where)."""
    from aerobulk_tpu.thermo import alpha_sw

    sst = jnp.asarray([260.0, 269.95, 269.96, 291.6], jnp.float32)
    val, grad = jax.vmap(jax.value_and_grad(alpha_sw))(sst)
    assert bool(jnp.all(jnp.isfinite(grad))), grad
    assert float(val[0]) == 0.0 and float(grad[0]) == 0.0
    assert float(grad[-1]) > 0.0


def test_cool_skin_gradient_finite_at_ustar_floor():
    """Round-5 regression (found by the on-device grad parity gate, 1
    point in 1.04e6): the cool-skin coefficient ``alpha*rcst_cs/usw^4``
    written as a division had a transpose that squares 1/usw^4 —
    overflow at the ustar clamp floor in fp32, and the clamp's zero
    cotangent turned the inf into NaN (inf*0) in fp32.  The coefficients
    are now products of reciprocals (thermo.skin_layer_coefs); this pins
    finite gradients across the harsh corner (ustar at/below the 1e-4
    floor x strong cooling) in fp32 on every backend."""
    from aerobulk_tpu import constants as c
    from aerobulk_tpu.skin import cs_coare
    from aerobulk_tpu.thermo import alpha_sw

    n = 64
    ustar = jnp.asarray(np.geomspace(1e-6, 0.5, n), jnp.float32)
    Qnsol = jnp.asarray(np.linspace(-400.0, -1.0, n), jnp.float32)
    sst = jnp.full((n,), 291.6, jnp.float32)
    Qsw = jnp.full((n,), (1.0 - c.roce_alb0) * 222.9, jnp.float32)
    Qlat = jnp.full((n,), -50.0, jnp.float32)

    def loss(us):
        return jnp.sum(cs_coare(Qsw, Qnsol, us, sst, Qlat))

    g = jax.grad(loss)(ustar)
    assert bool(jnp.all(jnp.isfinite(g))), np.asarray(g)
    # and d/d(alpha-chain) via sst stays finite too
    g2 = jax.grad(lambda s: jnp.sum(cs_coare(Qsw, Qnsol, ustar, s,
                                             Qlat)))(sst)
    assert bool(jnp.all(jnp.isfinite(g2)))


@pytest.mark.slow
def test_run_series_remat_gradient_matches():
    """``run_series(remat=True)`` (jax.checkpoint on the scan body — O(1)
    residual memory for long-series adjoints) gives the same gradient as
    the default."""
    from aerobulk_tpu.api import run_series
    cfg = AeroBulkConfig(algo="coare3p6", niter=2, use_skin=True)
    nt, npts = 4, 2

    def total_ql(sst0, remat):
        forcing = dict(
            sst=jnp.full((nt, npts), sst0),
            t_zt=jnp.full((nt, npts), 298.15),
            hum_zt=jnp.full((nt, npts), 0.015),
            U_zu=jnp.full((nt, npts), 4.0),
            V_zu=jnp.zeros((nt, npts)),
            slp=jnp.full((nt, npts), 101000.0),
            rad_sw=jnp.full((nt, npts), 600.0),
            rad_lw=jnp.full((nt, npts), 400.0))
        outs, _ = run_series(cfg, forcing, remat=remat,
                             isecday_utc=jnp.arange(10, 10 + nt) * 3600)
        return jnp.sum(outs.QL)

    g_plain = float(jax.grad(lambda s: total_ql(s, False))(300.15))
    g_remat = float(jax.grad(lambda s: total_ql(s, True))(300.15))
    assert np.isfinite(g_plain) and g_plain != 0.0
    np.testing.assert_allclose(g_remat, g_plain, rtol=1e-12)


@pytest.mark.slow
def test_gradient_finite_ice_mixed_and_neutral():
    """Every remaining differentiable surface — the 7 ice algorithms,
    both mixed ocean+ice paths (separate and the LG15_IO simultaneous
    solve), and neutral_10m for all 5 ocean algos — has finite, nonzero
    gradients over a randomized input band (the clamp-NaN sweep that
    found the gustiness and cool-skin issues, frozen as a regression)."""
    from aerobulk_tpu.api import flux_step_ice, flux_step_mixed
    from aerobulk_tpu.algos.neutral_10m import turb_neutral_10m
    from aerobulk_tpu.ice import ICE_ALGOS

    rng = np.random.default_rng(3)
    n = 64
    Ts_i = jnp.asarray(rng.uniform(230.0, 273.15, n))
    t = Ts_i + jnp.asarray(rng.uniform(-6.0, 6.0, n))
    q = jnp.asarray(rng.uniform(0.0001, 0.004, n))
    U = jnp.asarray(rng.uniform(0.3, 25.0, n))
    V = jnp.zeros(n)
    slp = jnp.full(n, 101000.0)
    frice = jnp.asarray(rng.uniform(0.0, 1.0, n))
    sst = jnp.asarray(rng.uniform(271.2, 302.0, n))

    for name in sorted(ICE_ALGOS):
        def loss_ice(ts):
            out, _ = flux_step_ice(name, 2.0, 10.0, ts, t, q, U, V, slp,
                                   frice=frice)
            return jnp.sum(out.QL + out.QH + out.Tau_x)
        g = jax.grad(loss_ice)(Ts_i)
        assert bool(jnp.all(jnp.isfinite(g))), f"{name}: NaN gradient"
        assert float(jnp.abs(g).max()) > 0.0, f"{name}: zero gradient"

    for simul in (False, True):
        def loss_mixed(s):
            net, _, _ = flux_step_mixed(2.0, 10.0, Ts_i, s, t + 20.0, q, U,
                                        V, slp, frice, simultaneous=simul)
            return jnp.sum(net.QL + net.QH)
        g = jax.grad(loss_mixed)(sst)
        assert bool(jnp.all(jnp.isfinite(g))), f"mixed simul={simul}: NaN"

    UN = jnp.asarray(rng.uniform(0.05, 35.0, n))
    for algo in ("coare3p0", "coare3p6", "ecmwf", "ncar", "andreas"):
        def loss_n10(u):
            CdN, ChN, CeN, _ = turb_neutral_10m(algo, u, niter=5)
            return jnp.sum(CdN + ChN + CeN)
        g = jax.grad(loss_n10)(UN)
        assert bool(jnp.all(jnp.isfinite(g))), f"neutral_10m {algo}: NaN"


def _linearize_inputs(n, seed=7):
    rng = np.random.default_rng(seed)
    return dict(
        sst=jnp.asarray(rng.uniform(278.0, 302.0, n)),
        t_zt=jnp.asarray(rng.uniform(275.0, 300.0, n)),
        hum_zt=jnp.asarray(rng.uniform(0.004, 0.018, n)),
        U_zu=jnp.asarray(rng.uniform(1.0, 14.0, n)),
        V_zu=jnp.asarray(rng.uniform(-4.0, 4.0, n)),
        slp=jnp.asarray(rng.uniform(99000.0, 103000.0, n)),
        rad_sw=jnp.asarray(rng.uniform(0.0, 800.0, n)),
        rad_lw=jnp.asarray(rng.uniform(300.0, 420.0, n)))


@pytest.mark.parametrize("wrt,eps", [("sst", 1e-4), ("t_zt", 1e-4),
                                     ("U_zu", 1e-5), ("hum_zt", 1e-8)])
@pytest.mark.slow
def test_linearized_matches_per_point_finite_difference(wrt, eps):
    """flux_step_linearized returns the per-point diagonal Jacobian —
    the implicit-coupling quantity — matching central finite differences
    at every point (fp64 CPU)."""
    from aerobulk_tpu.api import flux_step_linearized
    cfg = AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)
    inp = _linearize_inputs(16)
    kw = dict(isecday_utc=43200)

    out, d_out, _ = flux_step_linearized(cfg, **inp, **kw, wrt=wrt)

    def outputs(v):
        i2 = dict(inp)
        i2[wrt] = v
        o, _ = flux_step(cfg, **i2, **kw)
        return o.QL, o.QH, o.Tau

    x = inp[wrt]
    hi, lo = outputs(x + eps), outputs(x - eps)
    for got, o_hi, o_lo, name in zip((d_out.QL, d_out.QH, d_out.Tau),
                                     hi, lo, ("QL", "QH", "Tau")):
        fd = (np.asarray(o_hi) - np.asarray(o_lo)) / (2 * eps)
        scale = np.maximum(np.abs(fd), 1e-2 * np.abs(fd).max() + 1e-12)
        np.testing.assert_allclose(np.asarray(got) / scale, fd / scale,
                                   atol=2e-3, err_msg=f"{name} d/d{wrt}")
    assert bool(jnp.all(jnp.isfinite(d_out.diag.Cd)))  # diagnostics too


def test_linearized_jacobian_is_diagonal():
    """The pointwise-independence claim behind the one-pass diagonal:
    jacfwd of QL w.r.t. the SST *field* is exactly diagonal."""
    cfg = AeroBulkConfig(algo="ecmwf", niter=4, use_skin=False)
    inp = _linearize_inputs(4)
    inp.pop("rad_sw"), inp.pop("rad_lw")

    J = jax.jacfwd(
        lambda s: flux_step(cfg, s, inp["t_zt"], inp["hum_zt"],
                            inp["U_zu"], inp["V_zu"], inp["slp"])[0].QL
    )(inp["sst"])
    J = np.asarray(J)
    off = J - np.diag(np.diag(J))
    assert np.all(off == 0.0)
    assert np.all(np.diag(J) < 0.0)  # warmer ocean -> more latent loss


@pytest.mark.slow
def test_linearized_signs_and_errors():
    """Physical signs (dTau/dU > 0, d(QL+QH)/dSST < 0 — the negative
    air-sea feedback) and the error paths."""
    from aerobulk_tpu.api import flux_step_linearized
    cfg = AeroBulkConfig(algo="coare3p0", niter=5, use_skin=False)
    inp = _linearize_inputs(8)
    inp.pop("rad_sw"), inp.pop("rad_lw")

    _, d_u, _ = flux_step_linearized(cfg, **inp, wrt="U_zu")
    assert bool(jnp.all(d_u.Tau > 0.0))
    _, d_s, _ = flux_step_linearized(cfg, **inp, wrt="sst")
    assert bool(jnp.all(d_s.QL + d_s.QH < 0.0))

    with pytest.raises(ValueError, match="not one of"):
        flux_step_linearized(cfg, **inp, wrt="bogus")
    with pytest.raises(ValueError, match="not provided"):
        flux_step_linearized(cfg, **inp, wrt="rad_sw")


@pytest.mark.parametrize("ice_algo", ["ice_an05", "ice_lg15"])
@pytest.mark.slow
def test_ice_linearized_matches_per_point_finite_difference(ice_algo):
    """flux_step_ice_linearized(wrt='Ts_i') — the surface energy-balance
    Newton derivative sea-ice thermodynamic solvers need — matches
    central finite differences at every point, and carries the negative
    feedback sign (warmer ice surface -> more turbulent heat loss)."""
    from aerobulk_tpu.api import flux_step_ice, flux_step_ice_linearized
    rng = np.random.default_rng(21)
    n = 12
    Ts_i = jnp.asarray(rng.uniform(240.0, 272.0, n))
    t = Ts_i + jnp.asarray(rng.uniform(-4.0, 4.0, n))
    q = jnp.asarray(rng.uniform(0.0002, 0.003, n))
    U = jnp.asarray(rng.uniform(1.0, 18.0, n))
    V = jnp.zeros(n)
    slp = jnp.full(n, 101000.0)
    frice = jnp.asarray(rng.uniform(0.3, 0.95, n))

    out, d_out, _ = flux_step_ice_linearized(
        ice_algo, 2.0, 10.0, Ts_i, t, q, U, V, slp, frice=frice)

    eps = 1e-4
    hi, _ = flux_step_ice(ice_algo, 2.0, 10.0, Ts_i + eps, t, q, U, V,
                          slp, frice=frice)
    lo, _ = flux_step_ice(ice_algo, 2.0, 10.0, Ts_i - eps, t, q, U, V,
                          slp, frice=frice)
    for got, a, b, name in ((d_out.QL, hi.QL, lo.QL, "QL"),
                            (d_out.QH, hi.QH, lo.QH, "QH"),
                            (d_out.Tau, hi.Tau, lo.Tau, "Tau")):
        fd = (np.asarray(a) - np.asarray(b)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(got), fd, rtol=5e-4,
                                   atol=1e-7, err_msg=f"{name} d/dTs_i")
    assert bool(jnp.all(d_out.QL + d_out.QH < 0.0))

    with pytest.raises(ValueError, match="not one of"):
        flux_step_ice_linearized(ice_algo, 2.0, 10.0, Ts_i, t, q, U, V,
                                 slp, frice=frice, wrt="sst")


@pytest.mark.slow
def test_implicit_coupling_example():
    """examples/implicit_coupling.py (abridged horizon): backward-Euler
    slab coupling on the exact linearized fluxes is stable and accurate
    at a 12 h step where explicit coupling oscillates."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).parent.parent / "examples" / \
        "implicit_coupling.py"
    spec = importlib.util.spec_from_file_location("implicit_coupling", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(days=8.0)   # asserts live inside main()


@pytest.mark.slow
def test_charnock_calibration_recovers_coefficients():
    """End-to-end gradient calibration THROUGH the bulk solve: recover the
    COARE 3.6 Charnock law's (slope, offset) from synthetic flux
    observations (examples/calibrate_charnock.py, abridged)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).parent.parent / "examples" / \
        "calibrate_charnock.py"
    spec = importlib.util.spec_from_file_location("calibrate_charnock", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    obs = mod.make_campaign(n=256, seed=1)
    target = mod.fluxes(obs)
    slope, offset = mod.calibrate(obs, target, steps=250, verbose=False)
    assert abs(slope - mod.TRUE_SLOPE) < 0.05 * mod.TRUE_SLOPE
    assert abs(offset - mod.TRUE_OFFSET) < 1.0e-3
