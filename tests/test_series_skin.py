"""Warm-layer state-carry tests: run_series scan, dawn reset, accumulator
commit semantics (the reference's stateful behavior, SURVEY.md §5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aerobulk_tpu.api import AeroBulkConfig, flux_step, init_skin_state, \
    run_series
from aerobulk_tpu.skin import (HWL_MAX, SkinState, init_skin_state_coare,
                               local_solar_seconds, wl_coare)


def _day_forcing(nt=24, npts=2):
    """A sunny, calm tropical day of hourly records."""
    shape = (nt, npts)
    hours = np.arange(nt)
    sw = np.maximum(0.0, 800.0 * np.sin((hours - 6) / 12 * np.pi))  # day arc
    f = dict(
        sst=np.full(shape, 300.15),
        t_zt=np.full(shape, 299.15),
        hum_zt=np.full(shape, 0.016),
        U_zu=np.full(shape, 3.0),
        V_zu=np.zeros(shape),
        slp=np.full(shape, 101000.0),
        rad_sw=np.tile(sw[:, None], (1, npts)),
        rad_lw=np.full(shape, 420.0),
    )
    return ({k: jnp.asarray(v) for k, v in f.items()},
            jnp.asarray(hours * 3600, jnp.int32))


@pytest.mark.slow
def test_run_series_builds_warm_layer_and_resets_at_dawn():
    forcing, isd = _day_forcing()
    cfg = AeroBulkConfig(algo="coare3p6", niter=10, use_skin=True)
    lon = jnp.zeros((2,))
    outs, final_state = run_series(cfg, forcing, isecday_utc=isd, lon=lon)

    dT_wl = np.asarray(outs.diag.dT_wl)   # (nt, npts)
    # warm layer builds during the sunny afternoon
    assert dT_wl[14, 0] > 0.05, f"no warm layer built: {dT_wl[:, 0]}"
    # monotone growth through late morning (10h->14h)
    assert dT_wl[14, 0] > dT_wl[10, 0]
    # dawn window (solar hours (4, 6.5]) resets the layer
    assert dT_wl[5, 0] == 0.0 and dT_wl[6, 0] == 0.0
    # night (0-4h) with no sun: no warm layer
    assert np.all(dT_wl[0:4, 0] == 0.0)
    # final state is finite and committed
    assert np.all(np.isfinite(np.asarray(final_state.Qnt_ac)))


@pytest.mark.slow
def test_run_series_matches_manual_step_loop():
    forcing, isd = _day_forcing(nt=6)
    cfg = AeroBulkConfig(algo="ecmwf", niter=5, use_skin=True)
    outs, final_state = run_series(cfg, forcing, isecday_utc=isd)

    state = init_skin_state(cfg, (2,))
    for jt in range(6):
        out, state = flux_step(
            cfg, *(forcing[k][jt] for k in
                   ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")),
            rad_sw=forcing["rad_sw"][jt], rad_lw=forcing["rad_lw"][jt],
            isecday_utc=isd[jt], skin_state=state)
    np.testing.assert_allclose(outs.QL[-1], out.QL, rtol=1e-12)
    np.testing.assert_allclose(final_state.dT_wl, state.dT_wl, rtol=1e-12)


def test_local_solar_time():
    # at lon=0, solar time == UTC
    assert float(local_solar_seconds(jnp.array(0.0), 43200)) == 43200.0
    # 90 deg E is 6 hours ahead
    assert float(local_solar_seconds(jnp.array(90.0), 43200)) == \
        (43200 + 6 * 3600) % 86400
    # 150 deg W (Hawaii-ish) is 10 h behind
    assert float(local_solar_seconds(jnp.array(-150.0), 43200)) == \
        (43200 - 10 * 3600) % 86400


def test_wl_coare_night_inert():
    """Night, no preexisting layer, cooling: WL must stay zero
    (the l_exit branch, mod_skin_coare.f90:171-176)."""
    shape = (3,)
    st = init_skin_state_coare(shape)
    new = wl_coare(Qsw=jnp.zeros(shape), Qnsol=jnp.full(shape, -100.0),
                   Tau=jnp.full(shape, 0.05), sst=jnp.full(shape, 298.0),
                   lon=jnp.zeros(shape), isecday_utc=12, state=st)
    np.testing.assert_array_equal(np.asarray(new.dT_wl), 0.0)
    np.testing.assert_array_equal(np.asarray(new.Qnt_ac), 0.0)


def test_wl_coare_dawn_destroys_layer():
    shape = (1,)
    st = SkinState(dT_wl=jnp.full(shape, 0.5), Hz_wl=jnp.full(shape, 5.0),
                   Qnt_ac=jnp.full(shape, 1.0e6),
                   Tau_ac=jnp.full(shape, 100.0))
    # 5h local solar time is inside the (4, 6.5] dawn window
    new = wl_coare(Qsw=jnp.full(shape, 100.0), Qnsol=jnp.full(shape, -50.0),
                   Tau=jnp.full(shape, 0.05), sst=jnp.full(shape, 298.0),
                   lon=jnp.zeros(shape), isecday_utc=5 * 3600, state=st)
    assert float(new.dT_wl[0]) == 0.0
    assert float(new.Hz_wl[0]) == HWL_MAX
    assert float(new.Qnt_ac[0]) == 0.0
    assert float(new.Tau_ac[0]) == 0.0


def test_wl_coare_sunny_noon_builds_layer():
    shape = (1,)
    st = init_skin_state_coare(shape)
    new = wl_coare(Qsw=jnp.full(shape, 800.0), Qnsol=jnp.full(shape, -150.0),
                   Tau=jnp.full(shape, 0.03), sst=jnp.full(shape, 300.0),
                   lon=jnp.zeros(shape), isecday_utc=12 * 3600, state=st)
    assert float(new.dT_wl[0]) > 0.0
    assert float(new.Qnt_ac[0]) > 0.0
    assert 0.1 <= float(new.Hz_wl[0]) <= HWL_MAX


@pytest.mark.slow
def test_skin_state_shards_with_grid():
    """SkinState threads through jit with sharded inputs (8-dev CPU mesh)."""
    from aerobulk_tpu.sharding import make_grid_mesh, shard_grid_inputs
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_grid_mesh(jax.devices()[:8], shape=(2, 4))
    cfg = AeroBulkConfig(algo="coare3p6", niter=3, use_skin=True)
    shape = (4, 8)
    f = dict(sst=jnp.full(shape, 300.0), t=jnp.full(shape, 299.0),
             q=jnp.full(shape, 0.015), u=jnp.full(shape, 5.0),
             v=jnp.zeros(shape), slp=jnp.full(shape, 101000.0),
             rsw=jnp.full(shape, 600.0), rlw=jnp.full(shape, 400.0),
             lon=jnp.zeros(shape))
    f = shard_grid_inputs(mesh, f)
    state = shard_grid_inputs(mesh, init_skin_state(cfg, shape))

    @jax.jit
    def step(f, st):
        out, new = flux_step(cfg, f["sst"], f["t"], f["q"], f["u"], f["v"],
                             f["slp"], rad_sw=f["rsw"], rad_lw=f["rlw"],
                             isecday_utc=43200, lon=f["lon"], skin_state=st)
        return out.QL, new

    ql, new_state = step(f, state)
    # sharded result == unsharded result
    ql_ref, _ = step(jax.tree_util.tree_map(
        lambda x: jax.device_put(np.asarray(x)), f),
        jax.tree_util.tree_map(lambda x: jax.device_put(np.asarray(x)), state))
    np.testing.assert_allclose(np.asarray(ql), np.asarray(ql_ref), rtol=1e-12)

    # Zero-collective property: the flux step is pointwise over the grid,
    # so the partitioned program must contain NO cross-device communication
    # (SURVEY.md §2.4) — which is what makes weak scaling ~100% efficient
    # by construction (no halo, no reduction, nothing crosses the interconnect).
    hlo = step.lower(f, state).compile().as_text()
    for coll in ("all-reduce", "all-gather", "collective-permute",
                 "all-to-all", "reduce-scatter", "send", "recv"):
        assert coll not in hlo, f"unexpected collective {coll!r} in HLO"


@pytest.mark.slow
def test_run_series_batch_records_matches_scan():
    """Stateless series: batch_records=True (one vectorized call) must
    equal the scan path exactly, and reject skin configs."""
    import pytest
    from aerobulk_tpu.api import AeroBulkConfig, run_series

    cfg = AeroBulkConfig(algo="ncar", niter=5, use_skin=False)
    nt, npts = 7, 33
    rng = np.random.default_rng(41)
    forcing = {
        "sst": jnp.asarray(285.0 + 15.0 * rng.random((nt, npts))),
        "t_zt": jnp.asarray(284.0 + 16.0 * rng.random((nt, npts))),
        "hum_zt": jnp.asarray(0.004 + 0.012 * rng.random((nt, npts))),
        "U_zu": jnp.asarray(rng.normal(0, 6, (nt, npts))),
        "V_zu": jnp.asarray(rng.normal(0, 6, (nt, npts))),
        "slp": jnp.asarray(98000 + 4000 * rng.random((nt, npts))),
    }
    out_scan, _ = run_series(cfg, forcing)
    out_batch, _ = run_series(cfg, forcing, batch_records=True)
    for name in ("QL", "QH", "Tau", "Tau_x", "Evap", "T_s"):
        # not bitwise: XLA schedules the (nt, n) batch differently from
        # the per-record scan body (fma contraction order); ~1 ulp level
        np.testing.assert_allclose(
            np.asarray(getattr(out_batch, name)),
            np.asarray(getattr(out_scan, name)), rtol=1e-12, atol=1e-300,
            err_msg=name)

    cfg_skin = AeroBulkConfig(algo="coare3p6", niter=2, use_skin=True)
    with pytest.raises(ValueError, match="stateless"):
        run_series(cfg_skin, forcing, batch_records=True)


def test_warm_layer_clock_is_required_not_defaulted():
    """The reference hardcodes isecday_utc=12 (12 s past midnight) at the
    library level (mod_aerobulk_compute.f90:136) — a known bug that
    silently anchors the warm layer to midnight.  Our API must REFUSE to
    default it for warm-layer configs (VERDICT r2 item 5), accept an
    explicit value, and not demand it where the algorithm never uses it."""
    forcing, isd = _day_forcing(nt=3)
    cfg = AeroBulkConfig(algo="coare3p6", niter=2, use_skin=True)

    with pytest.raises(ValueError, match="isecday_utc"):
        run_series(cfg, forcing)
    with pytest.raises(ValueError, match="mod_aerobulk_compute"):
        flux_step(cfg, *(forcing[k][0] for k in
                         ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")),
                  rad_sw=forcing["rad_sw"][0], rad_lw=forcing["rad_lw"][0])

    # explicit clock: fine (including the ref-compat value 12)
    out, _ = run_series(cfg, forcing, isecday_utc=jnp.full((3,), 12))
    assert np.all(np.isfinite(np.asarray(out.QL)))

    # ECMWF's warm layer has no solar clock: no isecday required
    cfg_e = AeroBulkConfig(algo="ecmwf", niter=2, use_skin=True)
    out_e, _ = run_series(cfg_e, forcing)
    assert np.all(np.isfinite(np.asarray(out_e.QL)))

    # the drop-in compat wrapper keeps the reference's default verbatim
    from aerobulk_tpu.api import aerobulk_model
    import inspect
    assert inspect.signature(aerobulk_model).parameters[
        "isecday_utc"].default == 12
