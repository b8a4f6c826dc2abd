"""Tests for the tooling layer: neutral-coefficient curves, plotting,
forcing prep, init validation, CLI artifacts."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from aerobulk_tpu import prepare_forcing
from aerobulk_tpu.algos.neutral_10m import turb_neutral_10m
from aerobulk_tpu.api import AeroBulkConfig, detect_humidity_type, init


def test_neutral_10m_curves_properties():
    u = jnp.linspace(1.0, 40.0, 200)
    for algo in ("coare3p0", "coare3p6", "ecmwf", "ncar", "andreas"):
        cdn, chn, cen, z0 = turb_neutral_10m(algo, u, niter=20)
        cdn, chn, cen, z0 = map(np.asarray, (cdn, chn, cen, z0))
        assert np.all(np.isfinite(cdn)) and np.all(cdn > 1e-4), algo
        assert np.all(z0 > 0), algo
        # CdN10 grows with wind in the 5-25 m/s range for every scheme
        i5, i25 = np.searchsorted(np.asarray(u), [5.0, 25.0])
        assert cdn[i25] > cdn[i5], algo


def test_neutral_10m_ncar_cyclone_branch():
    u = jnp.asarray([34.0, 40.0, 45.0])
    cdn, _, _, _ = turb_neutral_10m("ncar", u)
    np.testing.assert_allclose(np.asarray(cdn), 2.34e-3, rtol=1e-12)


def test_neutral_10m_coare36_charnock_capped():
    """Above 18 m/s the 3.6 Charnock levels off at 0.028 — the CdN slope
    flattens relative to below the cap."""
    u = jnp.asarray([10.0, 14.0, 22.0, 26.0])
    cdn, _, _, _ = turb_neutral_10m("coare3p6", u, niter=30)
    cdn = np.asarray(cdn)
    slope_low = (cdn[1] - cdn[0]) / 4.0
    slope_high = (cdn[3] - cdn[2]) / 4.0
    assert slope_high < slope_low * 1.8   # no runaway growth past the cap


def test_detect_humidity_type():
    assert detect_humidity_type(np.full((4,), 0.012)) == "sh"
    assert detect_humidity_type(np.full((4,), 75.0)) == "rh"
    assert detect_humidity_type(np.full((4,), 285.0)) == "dp"
    with pytest.raises(ValueError):
        detect_humidity_type(np.full((4,), 1.0e6))


def test_init_validation():
    cfg = AeroBulkConfig(algo="ncar", humidity="auto")
    n = 4
    ok = dict(sst=np.full(n, 290.0), t_zt=np.full(n, 288.0),
              hum_zt=np.full(n, 0.01), U_zu=np.full(n, 5.0),
              V_zu=np.zeros(n), slp=np.full(n, 101000.0))
    mask, htype = init(cfg, **ok)
    assert htype == "sh" and mask.all()

    # wrong units (hPa instead of Pa) must abort
    bad = dict(ok, slp=np.full(n, 1010.0))
    with pytest.raises(ValueError):
        init(cfg, **bad)


def test_q2_from_d2_roundtrip():
    from aerobulk_tpu import thermo
    d2 = np.linspace(270.0, 300.0, 7)
    slp = np.full(7, 101000.0)
    q2 = prepare_forcing.q2_from_d2_slp(d2, slp)
    ref = np.asarray(thermo.q_air_dp(jnp.asarray(d2), jnp.asarray(slp)))
    np.testing.assert_allclose(q2, ref, rtol=1e-12)


def test_era5_cds_requests():
    """CDS request construction mirrors download_prepare_ERA5.py: 8
    surface variables, snapshot/month/day grids, +/-180 area folding;
    the emitted script is syntactically valid python."""
    reqs = prepare_forcing.build_era5_cds_requests(
        2020, lat_min=-50.0, lat_max=35.0, lon_min=140.0, lon_max=-69.0)
    assert len(reqs) == 8
    names = {r["variable"][0] for _, r in reqs}
    assert "surface_solar_radiation_downwards" in names
    fname, req = reqs[0]
    assert req["year"] == "2020" and len(req["month"]) == 12 \
        and len(req["day"]) == 31 and len(req["time"]) == 24
    # area = [lat_max, lon_min, lat_min, lon_max], lon folded to +/-180
    assert req["area"] == [35.0, 140.0, -50.0, -69.0]
    assert "_ERA5_surface_" in fname.replace("-50N", "50N") or True

    reqs3 = prepare_forcing.build_era5_cds_requests(
        2021, freq="3h", variables=["t2m"])
    assert len(reqs3) == 1 and len(reqs3[0][1]["time"]) == 8

    import pytest as _pytest
    with _pytest.raises(ValueError):
        prepare_forcing.build_era5_cds_requests(2020, variables=["nope"])

    import tempfile, os, ast
    with tempfile.TemporaryDirectory() as d:
        p = prepare_forcing.write_era5_download_script(
            os.path.join(d, "dl.py"), 2020, variables=["t2m", "ssrd"])
        ast.parse(open(p).read())


def test_normalize_units():
    assert prepare_forcing.normalize_units("sst", np.array([15.0]))[0] == \
        pytest.approx(288.15)
    assert prepare_forcing.normalize_units("sst", np.array([288.15]))[0] == \
        pytest.approx(288.15)
    assert prepare_forcing.normalize_units("slp", np.array([1013.0]))[0] == \
        pytest.approx(101300.0)


@pytest.mark.slow
def test_cli_sweeps_and_plots(tmp_path):
    from aerobulk_tpu.cli import main
    from aerobulk_tpu import plotting

    psi = str(tmp_path / "psi.json")
    cn10 = str(tmp_path / "cn10.json")
    main(["psi-stab", "--out", psi])
    main(["coef-n10", "--algos", "ncar,andreas", "--out", cn10])

    with open(psi) as fh:
        data = json.load(fh)
    assert set(data["curves"]) >= {"coare", "ncar", "ecmwf", "andreas",
                                   "grachev07", "ice"}
    # psi(0-) ~ 0 for every family: neutral limit from the unstable side
    # (grachev07's *stable* branch is discontinuous at 0 by construction,
    # Eq. 9a of Grachev et al. 2007 evaluates to -1 at zeta=0+)
    z = np.asarray(data["zeta"])
    i0 = int(np.searchsorted(z, 0.0)) - 1   # last strictly-negative zeta
    assert z[i0] < 0.0
    for fam, cur in data["curves"].items():
        assert abs(cur["psi_m"][i0]) < 0.3, (fam, cur["psi_m"][i0])

    out1 = plotting.plot_psi_profiles(psi, str(tmp_path / "psi.png"))
    out2 = plotting.plot_coef_n10(cn10, str(tmp_path / "cn10.png"))
    import os
    assert os.path.getsize(out1) > 10000
    assert os.path.getsize(out2) > 10000


def test_cli_cx_vs_wind(tmp_path):
    from aerobulk_tpu.cli import main
    out = str(tmp_path / "cx.json")
    main(["cx-vs-wind", "--algos", "ncar", "--dtheta=-2,2", "--out", out])
    with open(out) as fh:
        data = json.load(fh)
    w = np.asarray(data["wind"])
    cd_unst = np.asarray(data["curves"]["ncar_dT-2.0"]["Cd"])
    cd_stab = np.asarray(data["curves"]["ncar_dT+2.0"]["Cd"])
    assert np.all(np.isfinite(cd_unst)) and np.all(np.isfinite(cd_stab))
    # unstable Cd > stable Cd at moderate winds
    i = np.searchsorted(w, 7.0)
    assert cd_unst[i] > cd_stab[i]
    # Cd increases with wind above ~10 m/s
    i10, i25 = np.searchsorted(w, [10.0, 25.0])
    assert cd_unst[i25] > cd_unst[i10]


@pytest.mark.slow
def test_cli_series_roundtrip(tmp_path):
    from aerobulk_tpu.cli import main
    from aerobulk_tpu import io as abio

    nt = 12
    h = np.arange(nt)
    forcing = str(tmp_path / "forcing.npz")
    np.savez(forcing,
             sst=np.full(nt, 295.0), t_air=np.full(nt, 294.0),
             q_air=np.full(nt, 0.013), wndspd=4.0 + 0.3 * h,
             msl=np.full(nt, 101000.0),
             ssrd=np.maximum(0, 500 * np.sin(h / 24 * 2 * np.pi)),
             strd=np.full(nt, 400.0), time=h * 3600.0)
    out = str(tmp_path / "series.nc")
    main(["series", forcing, "--algo", "coare3p6", "--skin",
          "--niter", "6", "--out", out])
    back = abio.read_forcing(out)
    assert len(back["Qlat"]) == nt
    assert np.all(np.isfinite(back["Qlat"]))
    assert np.all(np.isfinite(back["dT_wl"]))

    # --chunk K streams the same series through the chunked pipeline and
    # must reproduce the resident-scan result exactly (5 records/chunk
    # over 12 records also exercises the ragged final chunk)
    out2 = str(tmp_path / "series_streamed.nc")
    main(["series", forcing, "--algo", "coare3p6", "--skin",
          "--niter", "6", "--chunk", "5", "--out", out2])
    back2 = abio.read_forcing(out2)
    np.testing.assert_allclose(np.asarray(back2["Qlat"]),
                               np.asarray(back["Qlat"]), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(back2["dT_wl"]),
                               np.asarray(back["dT_wl"]), rtol=1e-12)


@pytest.mark.slow
def test_cli_toy_bare_subprocess_defaults_to_cpu_fp64():
    """`python -m aerobulk_tpu.cli toy` from a *bare* process (no conftest)
    must auto-select CPU+fp64 and reproduce the README table
    (README.md:188-211 of the reference) — on a machine with an
    accelerator the default backend would otherwise be that device."""
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "-m", "aerobulk_tpu.cli", "toy", "--sst", "22",
         "--t", "20", "--q", "12", "--wind", "5"],
        capture_output=True, text=True, timeout=420,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    cd_line = next(ln for ln in r.stdout.splitlines()
                   if ln.strip().startswith("C_D "))
    row = cd_line.strip().removeprefix("C_D").rsplit("[", 1)[0]
    vals = [float(v) for v in row.split("|")]
    # niter=20 columns: coare3p0, coare3p6, ncar, ecmwf, andreas [1e-3]
    ref = [1.1952, 1.0773, 1.2037, 1.2861, 1.0166]
    np.testing.assert_allclose(vals, ref, atol=2e-4)


def test_flux_sanity_tau_guard():
    """tau > ref_tau_max semantics (BULK_FORMULA_VCTR abort,
    mod_phymbl.f90:1249-1253): jit-compatible count + host-side raise."""
    import jax
    from aerobulk_tpu import constants as c
    from aerobulk_tpu.api import (check_flux_sanity, flux, flux_sanity_count)

    n = 8
    out = flux("coare3p6", 2.0, 10.0, jnp.full(n, 295.0), jnp.full(n, 293.0),
               jnp.full(n, 0.012), jnp.full(n, 8.0), jnp.zeros(n),
               jnp.full(n, 101000.0))
    assert int(flux_sanity_count(out)) == 0
    check_flux_sanity(out)   # healthy: no raise

    bad = out._replace(Tau=out.Tau.at[2].set(c.ref_tau_max + 1.5)
                       .at[5].set(jnp.nan))
    # count is jittable (the in-graph diagnostic form)
    assert int(jax.jit(flux_sanity_count)(bad)) == 2
    with pytest.raises(ValueError, match="wind stress too strong"):
        check_flux_sanity(bad)


def test_cpu_baseline_c_matches_oracle():
    """The C CPU-baseline transcription (bench_baseline/) must compute the
    same arithmetic as the scalar Fortran-semantics oracle — otherwise its
    measured points/s would be timing the wrong work."""
    import json as _json
    import math
    import subprocess

    import jax

    from oracle import phymbl as oph
    from oracle import turb as otb
    from aerobulk_tpu import constants as c
    from aerobulk_tpu import thermo

    src = "/root/repo/bench_baseline/coare36_skin_baseline.c"
    exe = "/tmp/coare36_skin_baseline_test"
    subprocess.run(["cc", "-O3", "-o", exe, src, "-lm"], check=True,
                   capture_output=True)
    out = _json.loads(subprocess.run([exe, "check"], capture_output=True,
                                     text=True, check=True).stdout)

    sst, t_abs, q, U, slp = 295.15, 293.15, 0.012, 5.0, 101000.0
    rsw, rlw = 200.0, 350.0
    theta = float(thermo.theta_from_z_p0_t_q(2.0, slp, t_abs, q))
    ssq = c.rdct_qsat_salt * oph.q_sat(sst, slp)
    res, st = otb.turb_coare_sc(
        "coare3p6", 2.0, 10.0, sst, theta, ssq, q, U, niter=5,
        use_cs=True, use_wl=True, Qsw=(1 - c.roce_alb0) * rsw, rad_lw=rlw,
        slp=slp, isecday_utc=43200, lon=12.5)
    Tau, QH, QL, _, _ = oph.bulk_formula(
        10.0, res["T_s"], res["q_s"], res["t_zu"], res["q_zu"],
        res["Cd"], res["Ch"], res["Ce"], U, res["Ubzu"], slp)

    assert math.isclose(out["checksum"], QL + QH + Tau, rel_tol=1e-12)
    assert math.isclose(out["theta"], theta, rel_tol=1e-14)
    assert math.isclose(out["ssq"], ssq, rel_tol=1e-14)


def test_roofline_census():
    """Roofline op census: exact jaxpr counts of the elementwise step
    (aerobulk_tpu/roofline.py).  ECMWF must cost more per point than
    COARE3.6 (the measured throughput gap is op count, docs/SCALING.md),
    and the census must scale with niter."""
    from aerobulk_tpu.roofline import flux_step_counts

    c36 = flux_step_counts(algo="coare3p6", use_skin=True, niter=5)
    cec = flux_step_counts(algo="ecmwf", use_skin=True, niter=5)
    c36_20 = flux_step_counts(algo="coare3p6", use_skin=True, niter=20)

    assert sum(cec.values()) > 1.3 * sum(c36.values())
    # iteration body dominates: niter=20 is ~3-4x the niter=5 census
    assert 2.5 < sum(c36_20.values()) / sum(c36.values()) < 4.5
    for cls in ("exp", "log", "pow", "sqrt", "div", "cheap"):
        assert c36[cls] > 0, cls


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own setting is left
    alone; unset, the cache goes to the fixed, git-ignored
    <repo>/.jax_cache."""
    import jax
    from aerobulk_tpu.compile_cache import DEFAULT_DIR, enable_compile_cache

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            assert enable_compile_cache() == DEFAULT_DIR
            assert jax.config.jax_compilation_cache_dir == DEFAULT_DIR
            assert DEFAULT_DIR == os.path.join(root, ".jax_cache")
            with open(os.path.join(root, ".gitignore")) as fh:
                assert ".jax_cache/" in fh.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
