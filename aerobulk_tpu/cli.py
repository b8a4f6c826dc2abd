"""Command-line tools — the reference test-executable equivalents.

  aerobulk-tpu toy          -> aerobulk_toy.x      (single-point, all algos)
  aerobulk-tpu ice-toy      -> test_aerobulk_ice.x (single-point, ice algos)
  aerobulk-tpu series       -> test_aerobulk_buoy_series_oce.x (forcing file)
  aerobulk-tpu cx-vs-wind   -> test_cx_vs_wind.x   (wind/stability sweeps)
  aerobulk-tpu coef-n10     -> test_coef_n10.x     (neutral-coef curves)
  aerobulk-tpu psi-stab     -> test_psi_stab.x     (psi profiles)
  aerobulk-tpu bench        -> per-chip benchmark

Run via ``python -m aerobulk_tpu.cli <subcommand> [options]``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _jnp():
    import jax.numpy as jnp
    return jnp


def cmd_toy(args):
    """Single-point comparison of all ocean algorithms
    (aerobulk_toy.F90 behaviour; nb_iter=20, slp default 1010 hPa)."""
    import jax.numpy as jnp
    from . import thermo, constants as c
    from .api import AeroBulkConfig, flux_step

    shape = (1,)
    sst = jnp.full(shape, args.sst + c.rt0)
    U = jnp.full(shape, args.wind)
    V = jnp.zeros(shape)
    slp = jnp.full(shape, args.slp * 100.0)

    if args.neutral:
        # -N mode of aerobulk_toy.F90:205-216: find the air temperature at
        # zt (with the given RH) that makes the virtual potential
        # temperature profile perfectly neutral
        ssq = c.rdct_qsat_salt * thermo.q_sat(sst, slp)
        t_zt = sst
        for _ in range(10):
            q_zt = thermo.q_air_rh(jnp.full(shape, args.rh), t_zt, slp)
            t_zt = (thermo.virt_temp(sst, ssq) / (1.0 + c.rctv0 * q_zt)
                    - c.rgamma_dry * args.zt)
        q_zt = thermo.q_air_rh(jnp.full(shape, args.rh), t_zt, slp)
        print(f" forced neutral: t_zt = {float(t_zt[0]) - c.rt0:.4f} C, "
              f"q_zt = {float(q_zt[0]) * 1e3:.4f} g/kg (RH={args.rh}%)")
    else:
        t_zt = jnp.full(shape, args.t + c.rt0)
        if args.hum_rh is not None:       # the reference toy's -r mode
            q_zt = thermo.q_air_rh(jnp.full(shape, args.hum_rh), t_zt, slp)
            print(f" humidity from RH={args.hum_rh}%: "
                  f"q_zt = {float(q_zt[0]) * 1e3:.4f} g/kg")
        elif args.hum_dp is not None:     # the -d (dew point) mode
            q_zt = thermo.q_air_dp(jnp.full(shape, args.hum_dp + c.rt0), slp)
            print(f" humidity from dew point {args.hum_dp} C: "
                  f"q_zt = {float(q_zt[0]) * 1e3:.4f} g/kg")
        else:
            q_zt = jnp.full(shape, args.q * 1e-3)

    theta = thermo.theta_from_z_p0_t_q(args.zt, slp, t_zt, q_zt)
    print(f"\n zu={args.zu} m, zt={args.zt} m, SST={args.sst} C, "
          f"t_zt={args.t} C, q_zt={args.q} g/kg, U={args.wind} m/s, "
          f"slp={args.slp} hPa, niter={args.niter}")
    print(f" theta_zt = {float(theta[0]) - c.rt0:.5f} C\n")

    algos = ["coare3p0", "coare3p6", "ncar", "ecmwf", "andreas"]
    rows = {k: [] for k in ("C_D", "C_E", "C_H", "z_0", "u*", "L", "UN10",
                            "C_D_N", "C_E_N", "C_H_N", "Tau", "Evap",
                            "QL", "QH")}
    for algo in algos:
        cfg = AeroBulkConfig(algo=algo, zt=args.zt, zu=args.zu,
                             niter=args.niter)
        out, _ = flux_step(cfg, sst, t_zt, q_zt, U, V, slp)
        d = out.diag
        rows["C_D"].append(float(d.Cd[0]) * 1e3)
        rows["C_E"].append(float(d.Ce[0]) * 1e3)
        rows["C_H"].append(float(d.Ch[0]) * 1e3)
        rows["z_0"].append(float(d.z0[0]))
        rows["u*"].append(float(d.u_star[0]))
        rows["L"].append(float(d.L[0]))
        rows["UN10"].append(float(d.UN10[0]))
        rows["C_D_N"].append(float(d.CdN[0]) * 1e3)
        rows["C_E_N"].append(float(d.CeN[0]) * 1e3)
        rows["C_H_N"].append(float(d.ChN[0]) * 1e3)
        rows["Tau"].append(float(out.Tau[0]) * 1e3)
        rows["Evap"].append(float(out.Evap[0]) * 86400.0)
        rows["QL"].append(float(out.QL[0]))
        rows["QH"].append(float(out.QH[0]))

    hdr = "   Algorithm:   " + " | ".join(f"{a:>10s}" for a in algos)
    print("=" * len(hdr))
    print(hdr)
    print("=" * len(hdr))
    units = {"C_D": "[10^-3]", "C_E": "[10^-3]", "C_H": "[10^-3]",
             "z_0": "[m]", "u*": "[m/s]", "L": "[m]", "UN10": "[m/s]",
             "C_D_N": "[10^-3]", "C_E_N": "[10^-3]", "C_H_N": "[10^-3]",
             "Tau": "[mN/m^2]", "Evap": "[mm/day]", "QL": "[W/m^2]",
             "QH": "[W/m^2]"}
    for k, vals in rows.items():
        cells = " | ".join(f"{v:10.5g}" for v in vals)
        print(f"   {k:<10s}  {cells}   {units[k]}")
    print("=" * len(hdr))


def cmd_ice_toy(args):
    """Single-point comparison of the ice algorithms
    (test_aerobulk_ice.f90 behaviour)."""
    import jax.numpy as jnp
    from . import thermo, constants as c
    from .api import flux_step_ice
    from .ice import ICE_ALGOS

    shape = (1,)
    Ts_i = jnp.full(shape, args.ts + c.rt0)
    t_zt = jnp.full(shape, args.t + c.rt0)
    slp = jnp.full(shape, args.slp * 100.0)
    q_zt = args.rh / 100.0 * thermo.q_sat(t_zt, slp, l_ice=True)
    U = jnp.full(shape, args.wind)
    V = jnp.zeros(shape)
    frice = jnp.full(shape, args.frice)

    print(f"\n zu={args.zu} m, zt={args.zt} m, Ts_ice={args.ts} C, "
          f"t_zt={args.t} C, RH={args.rh}%, U={args.wind} m/s, "
          f"A={args.frice}\n")
    print(f" {'algo':>10s} {'Cd[e-3]':>9s} {'Ch[e-3]':>9s} {'Ce[e-3]':>9s}"
          f" {'QH[W/m2]':>10s} {'QL[W/m2]':>10s} {'Tau[mN/m2]':>11s}")
    for algo in ICE_ALGOS:
        out, d = flux_step_ice(algo, args.zt, args.zu, Ts_i, t_zt, q_zt,
                               U, V, slp, frice=frice, niter=args.niter)
        print(f" {algo:>10s} {float(d.Cd[0])*1e3:9.4f} "
              f"{float(d.Ch[0])*1e3:9.4f} {float(d.Ce[0])*1e3:9.4f} "
              f"{float(out.QH[0]):10.3f} {float(out.QL[0]):10.3f} "
              f"{float(out.Tau[0])*1e3:11.4f}")


def cmd_oce_ice_toy(args):
    """Single-point mixed ocean+ice cell comparison
    (test_aerobulk_oce+ice.f90 behaviour): ECMWF over the leads + each of
    the ice algorithms over the ice fraction, plus the LG15_IO
    simultaneous ice+water solve."""
    import jax.numpy as jnp
    from . import thermo, constants as c
    from .api import flux_step_mixed

    shape = (1,)
    Ts_i = jnp.full(shape, args.ts + c.rt0)
    sst = jnp.full(shape, args.sst + c.rt0)
    t_zt = jnp.full(shape, args.t + c.rt0)
    slp = jnp.full(shape, args.slp * 100.0)
    q_zt = args.rh / 100.0 * thermo.q_sat(t_zt, slp)
    U = jnp.full(shape, args.wind)
    V = jnp.zeros(shape)
    frice = jnp.full(shape, args.frice)

    print(f"\n zu={args.zu} m, zt={args.zt} m, Ts_ice={args.ts} C, "
          f"SST={args.sst} C, t_zt={args.t} C, RH={args.rh}%, "
          f"U={args.wind} m/s, A={args.frice}\n")
    print(f" {'ice algo':>12s} {'QH_net':>9s} {'QL_net':>9s} "
          f"{'Tau_net':>9s} {'QH_ice':>9s} {'QH_oce':>9s}  [W/m2, N/m2]")

    for algo in ("ice_nemo", "ice_an05", "ice_lg15"):
        net, oi, ow = flux_step_mixed(args.zt, args.zu, Ts_i, sst, t_zt,
                                      q_zt, U, V, slp, frice,
                                      ice_algo=algo, niter=args.niter)
        print(f" {algo:>12s} {float(net.QH[0]):9.3f} "
              f"{float(net.QL[0]):9.3f} {float(net.Tau[0]):9.5f} "
              f"{float(oi.QH[0]):9.3f} {float(ow.QH[0]):9.3f}")

    net, oi, ow = flux_step_mixed(args.zt, args.zu, Ts_i, sst, t_zt, q_zt,
                                  U, V, slp, frice, simultaneous=True,
                                  niter=args.niter)
    print(f" {'lg15_io(sim)':>12s} {float(net.QH[0]):9.3f} "
          f"{float(net.QL[0]):9.3f} {float(net.Tau[0]):9.5f} "
          f"{float(oi.QH[0]):9.3f} {float(ow.QH[0]):9.3f}")


def cmd_series(args):
    """Time-series run over a forcing file: ocean algorithms via the
    lax.scan driver (test_aerobulk_buoy_series_oce.x analogue) or, with
    ``--ice``, the ice algorithm family over ice-station forcing
    (test_aerobulk_buoy_series_ice.x analogue)."""
    import jax.numpy as jnp
    from . import io as abio
    from . import thermo, constants as c
    from .api import AeroBulkConfig, run_series

    if args.algo.startswith("ice_"):
        return _series_ice(args)

    f = abio.read_forcing(args.file)
    nt = len(f["sst"])

    def col(name, *alts, default=None):
        for n in (name,) + alts:
            if n in f:
                return np.atleast_1d(np.asarray(f[n], np.float64)).reshape(nt, -1)
        if default is not None:
            return np.full((nt, 1), default)
        raise KeyError(f"forcing variable {name!r} not found in {args.file}")

    sst = col("sst")
    sst = sst + c.rt0 if sst.mean() < 200.0 else sst
    t_air = col("t_air", "t2m")
    t_air = t_air + c.rt0 if t_air.mean() < 200.0 else t_air
    hum = col("q_air", "q2m", "rh_air", "dp_air")
    slp = col("slp", "msl", default=101000.0)
    if "wndspd" in f:
        wnd = col("wndspd")
        u, v = wnd, np.zeros_like(wnd)
    else:
        u, v = col("u_wnd", "u10"), col("v_wnd", "v10")

    forcing_np = dict(sst=sst, t_zt=t_air, hum_zt=hum, U_zu=u, V_zu=v,
                      slp=slp)
    use_skin = args.skin
    if use_skin:
        forcing_np["rad_sw"] = col("rad_sw", "ssrd", default=0.0)
        forcing_np["rad_lw"] = col("rad_lw", "strd", default=350.0)

    if "time" in f:
        epoch = np.asarray(f["time"], np.float64)
        isd = jnp.asarray(abio.seconds_of_day(epoch), jnp.int32)
        time = epoch
    else:
        # no time column: synthesize an hourly axis starting at 00h UTC
        # and derive the warm layer's seconds-of-day from it (the library
        # refuses a silent default — see api.flux_step on the reference's
        # hardcoded isecday_utc=12 bug)
        time = np.arange(nt, dtype=np.float64) * 3600.0
        isd = jnp.asarray(time % 86400.0, jnp.int32)

    cfg = AeroBulkConfig(algo=args.algo, zt=args.zt, zu=args.zu,
                         niter=args.niter, use_skin=use_skin)
    backend = getattr(args, "backend", "jit")
    chunk = getattr(args, "chunk", 0)
    if chunk:
        # streamed driver (run_series_pipelined chunked mode): records are
        # fed host->device chunk by chunk with the compute of chunk k
        # overlapping the transfer of chunk k+1 — the production shape
        # when the forcing does not fit in device memory.  Records stream
        # from the HOST copy of the forcing; nothing goes
        # device->host->device.
        import jax
        from .pipeline import run_series_pipelined

        isd_np = np.asarray(isd)

        def records():
            for jt in range(nt):
                rec = {k: v[jt] for k, v in forcing_np.items()}
                rec["isecday_utc"] = np.int32(isd_np[jt])
                yield rec

        chunks, _ = run_series_pipelined(cfg, records(), chunk=chunk,
                                         backend=backend,
                                         collect=lambda o: o)
        outs = jax.tree_util.tree_map(
            lambda *xs: np.concatenate(xs), *chunks)
    else:
        forcing = {k: jnp.asarray(v) for k, v in forcing_np.items()}
        outs, _ = run_series(cfg, forcing, isecday_utc=isd, backend=backend)

    def first_col(x):
        return np.asarray(x).reshape(nt, -1)[:, 0]

    variables = {
        "Qlat": first_col(outs.QL), "Qsen": first_col(outs.QH),
        "Evap": first_col(outs.Evap), "T_s": first_col(outs.T_s),
    }
    if outs.Tau is not None:
        variables["Tau"] = first_col(outs.Tau)
        variables["rho_a"] = first_col(outs.rho_a)
    else:   # fused backend: reduced output set
        variables["Tau"] = first_col(
            np.hypot(np.asarray(outs.Tau_x), np.asarray(outs.Tau_y)))
    if outs.diag is not None:
        variables.update({
            "Cd": first_col(outs.diag.Cd), "Ch": first_col(outs.diag.Ch),
            "Ce": first_col(outs.diag.Ce),
            "u_star": first_col(outs.diag.u_star),
            "dT_cs": first_col(outs.diag.dT_cs),
            "dT_wl": first_col(outs.diag.dT_wl),
            "Hz_wl": first_col(outs.diag.Hz_wl),
        })
    abio.write_series(args.out, time, variables)
    print(f"wrote {len(variables)} series of {nt} records to {args.out}")


def _series_ice(args):
    """Ice-algorithm time series (no cross-step state -> plain loop over
    jitted steps; forcing must provide Ts_i as `sst` or `ts_i`, and
    optionally `frice`)."""
    import jax
    import jax.numpy as jnp
    from . import io as abio
    from . import constants as c
    from .api import flux_step_ice

    f = abio.read_forcing(args.file)
    key_ts = "ts_i" if "ts_i" in f else "sst"
    nt = len(f[key_ts])

    def col(name, *alts, default=None):
        for n in (name,) + alts:
            if n in f:
                return np.atleast_1d(np.asarray(f[n], np.float64)).reshape(nt, -1)
        if default is not None:
            return np.full((nt, 1), default)
        raise KeyError(f"forcing variable {name!r} not found")

    Ts = col(key_ts)
    Ts = Ts + c.rt0 if Ts.mean() < 200.0 else Ts
    t_air = col("t_air", "t2m")
    t_air = t_air + c.rt0 if t_air.mean() < 200.0 else t_air
    hum = col("q_air", "q2m")
    slp = col("slp", "msl", default=101000.0)
    if "wndspd" in f:
        u, v = col("wndspd"), np.zeros((nt, 1))
    else:
        u, v = col("u_wnd", "u10"), col("v_wnd", "v10")
    frice = col("frice", "siconc", "at_i", default=1.0)

    @jax.jit
    def step(Ts, t, q, u, v, slp, A):
        out, diag = flux_step_ice(args.algo, args.zt, args.zu, Ts, t, q,
                                  u, v, slp, frice=A, niter=args.niter)
        return out.QL, out.QH, out.Tau, out.Evap, diag.Cd, diag.Ch

    rows = [step(*(jnp.asarray(x[jt]) for x in (Ts, t_air, hum, u, v, slp,
                                                frice)))
            for jt in range(nt)]
    series = [np.stack([np.asarray(r[i])[0] for r in rows]) for i in range(6)]
    time = np.asarray(f.get("time", np.arange(nt) * 3600.0), np.float64)
    abio.write_series(args.out, time, dict(
        Qlat=series[0], Qsen=series[1], Tau=series[2], Evap=series[3],
        Cd=series[4], Ch=series[5]))
    print(f"wrote ice series ({args.algo}) of {nt} records to {args.out}")


def cmd_cdnf(args):
    """Neutral form-drag coefficient variants vs ice concentration
    (test_aerobulk_cdnf_series.x analogue)."""
    import jax.numpy as jnp
    from .ice import form_drag as fd

    A = jnp.linspace(0.0, 1.0, args.n)
    z0w = jnp.full_like(A, 3.27e-4)
    z0i = jnp.full_like(A, 4.54e-4)
    out = {
        "frice": np.asarray(A).tolist(),
        "CdN10_f_LU12": np.asarray(fd.cdn10_f_lu12(A, z0w)).tolist(),
        "CdN_f_LU12_eq36": np.asarray(fd.cdn_f_lu12_eq36(args.zu, A)).tolist(),
        "CdN10_f_LU13": np.asarray(fd.cdn10_f_lu13(A)).tolist(),
        "CdN_f_LG15": np.asarray(fd.cdn_f_lg15(args.zu, A, z0i)).tolist(),
        "CdN_f_LG15_light": np.asarray(
            fd.cdn_f_lg15_light(args.zu, A, z0w)).tolist(),
    }
    with open(args.out, "w") as fh:
        json.dump(out, fh)
    print(f"wrote form-drag curves to {args.out}")


def cmd_cx_vs_wind(args):
    """Cd/Ch/Ce (+z0, u*, L, UN10) vs wind for a range of air-sea
    stability states (test_cx_vs_wind.f90 sweep; nb_iter=20)."""
    import jax.numpy as jnp
    from . import thermo, constants as c
    from .api import AeroBulkConfig, flux_step

    # non-uniform wind grid: dense at low winds (reference :98-107 spirit)
    w = np.concatenate([np.linspace(0.1, 5.0, 200, endpoint=False),
                        np.linspace(5.0, 20.0, 400, endpoint=False),
                        np.linspace(20.0, 50.0, 200)])
    dthetas = np.asarray([float(x) for x in args.dtheta.split(",")])

    result = {"wind": w.tolist(), "curves": {}}
    for algo in args.algos.split(","):
        cfg = AeroBulkConfig(algo=algo, zt=args.zt, zu=args.zu, niter=20)
        for dth in dthetas:
            sst = jnp.full(w.shape, 273.15 + 15.0)
            t_zt = sst + dth
            slp = jnp.full(w.shape, 101000.0)
            q_zt = args.rh / 100.0 * thermo.q_sat(t_zt, slp)
            out, _ = flux_step(cfg, sst, t_zt, q_zt, jnp.asarray(w),
                               jnp.zeros_like(sst), slp)
            d = out.diag
            result["curves"][f"{algo}_dT{dth:+.1f}"] = {
                "Cd": np.asarray(d.Cd).tolist(),
                "Ch": np.asarray(d.Ch).tolist(),
                "Ce": np.asarray(d.Ce).tolist(),
                "z0": np.asarray(d.z0).tolist(),
                "u_star": np.asarray(d.u_star).tolist(),
                "UN10": np.asarray(d.UN10).tolist(),
            }
    with open(args.out, "w") as fh:
        json.dump(result, fh)
    print(f"wrote {len(result['curves'])} curve sets to {args.out}")


def cmd_coef_n10(args):
    """Neutral-coefficient curves CxN10(UN10) (test_coef_n10.f90;
    nb_iter=50)."""
    import jax.numpy as jnp
    from .algos.neutral_10m import turb_neutral_10m

    un10 = np.linspace(0.5, 40.0, 396)
    result = {"UN10": un10.tolist(), "curves": {}}
    for algo in args.algos.split(","):
        cdn, chn, cen, z0 = turb_neutral_10m(algo, jnp.asarray(un10),
                                             niter=50)
        result["curves"][algo] = {
            "CdN10": np.asarray(cdn).tolist(),
            "ChN10": np.asarray(chn).tolist(),
            "CeN10": np.asarray(cen).tolist(),
            "z0": np.asarray(z0).tolist(),
        }
    with open(args.out, "w") as fh:
        json.dump(result, fh)
    print(f"wrote neutral-coefficient curves to {args.out}")


def cmd_psi_stab(args):
    """psi_m / psi_h profiles on zeta in [-15, 15] (test_psi_stab.f90)."""
    import jax.numpy as jnp
    from . import stability as st

    zeta = np.linspace(-15.0, 15.0, 1001)
    z = jnp.asarray(zeta)
    fams = {
        "coare": (st.psi_m_coare, st.psi_h_coare),
        "ncar": (st.psi_m_ncar, st.psi_h_ncar),
        "ecmwf": (st.psi_m_ecmwf, st.psi_h_ecmwf),
        "andreas": (st.psi_m_andreas, st.psi_h_andreas),
        "grachev07": (st.psi_m_grachev07, st.psi_h_grachev07),
        "ice": (st.psi_m_ice, st.psi_h_ice),
    }
    result = {"zeta": zeta.tolist(), "curves": {}}
    for name, (pm, ph) in fams.items():
        result["curves"][name] = {"psi_m": np.asarray(pm(z)).tolist(),
                                  "psi_h": np.asarray(ph(z)).tolist()}
    with open(args.out, "w") as fh:
        json.dump(result, fh)
    print(f"wrote psi profiles to {args.out}")


def cmd_bench(args):
    import bench
    bench._device_fields()     # exits unless there is a GPU
    bench.main()


# Subcommands that reproduce reference fp64 tables/curves: these default
# to the CPU backend with x64 enabled (the reference is -fdefault-real-8
# Fortran, and a handful of single points gains nothing from a device
# launch).  ``bench`` and ``series`` keep the default platform.
_CPU_FP64_CMDS = ("toy", "ice-toy", "oce-ice-toy", "cdnf", "cx-vs-wind",
                  "coef-n10", "psi-stab")


def _select_device(device: str):
    import jax
    if device == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    elif device == "gpu":
        jax.config.update("jax_platforms", "cuda")
    # "auto": per-subcommand default already applied by main()


def main(argv=None):
    p = argparse.ArgumentParser(prog="aerobulk-tpu", description=__doc__)
    p.add_argument("--device", default="auto", choices=("auto", "cpu", "gpu"),
                   help="backend: 'cpu' forces CPU+fp64 (parity with the "
                        "fp64 reference), 'gpu' requires the GPU, "
                        "'auto' picks CPU+fp64 for the table/curve tools "
                        "and the default platform for bench/series")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("toy", help="single-point all-algo comparison")
    t.add_argument("--zu", type=float, default=10.0)
    t.add_argument("--zt", type=float, default=2.0)
    t.add_argument("--sst", type=float, default=22.0, help="SST [C]")
    t.add_argument("--t", type=float, default=20.0, help="air temp [C]")
    t.add_argument("--q", type=float, default=12.0, help="spec hum [g/kg]")
    t.add_argument("--hum-rh", type=float, default=None,
                   help="give humidity as relative humidity [%%] instead "
                        "of --q (the reference toy's -r mode)")
    t.add_argument("--hum-dp", type=float, default=None,
                   help="give humidity as dew point [C] instead of --q "
                        "(the reference toy's -d mode)")
    t.add_argument("--wind", type=float, default=5.0, help="wind [m/s]")
    t.add_argument("--slp", type=float, default=1010.0, help="slp [hPa]")
    t.add_argument("--niter", type=int, default=20)
    t.add_argument("--neutral", action="store_true",
                   help="force neutral-stability air temp (the -N mode)")
    t.add_argument("--rh", type=float, default=80.0,
                   help="relative humidity for --neutral [%%]")
    t.set_defaults(fn=cmd_toy)

    it = sub.add_parser("ice-toy", help="single-point ice-algo comparison")
    it.add_argument("--zu", type=float, default=10.0)
    it.add_argument("--zt", type=float, default=2.0)
    it.add_argument("--ts", type=float, default=-10.0, help="ice temp [C]")
    it.add_argument("--t", type=float, default=-12.0, help="air temp [C]")
    it.add_argument("--rh", type=float, default=80.0, help="rel hum [%]")
    it.add_argument("--wind", type=float, default=7.0)
    it.add_argument("--slp", type=float, default=1000.0)
    it.add_argument("--frice", type=float, default=0.8)
    it.add_argument("--niter", type=int, default=8)
    it.set_defaults(fn=cmd_ice_toy)

    oi = sub.add_parser("oce-ice-toy",
                        help="single-point mixed ocean+ice cell "
                             "(test_aerobulk_oce+ice.x analogue)")
    oi.add_argument("--zu", type=float, default=10.0)
    oi.add_argument("--zt", type=float, default=2.0)
    oi.add_argument("--ts", type=float, default=-5.0, help="ice temp [C]")
    oi.add_argument("--sst", type=float, default=-1.0, help="lead SST [C]")
    oi.add_argument("--t", type=float, default=-4.0, help="air temp [C]")
    oi.add_argument("--rh", type=float, default=85.0, help="rel hum [%]")
    oi.add_argument("--wind", type=float, default=7.0)
    oi.add_argument("--slp", type=float, default=1000.0)
    oi.add_argument("--frice", type=float, default=0.7)
    oi.add_argument("--niter", type=int, default=8)
    oi.set_defaults(fn=cmd_oce_ice_toy)

    s = sub.add_parser("series", help="time-series run over a forcing file")
    s.add_argument("file", help="forcing file (.nc NetCDF3/4 or .npz)")
    s.add_argument("--algo", default="coare3p6")
    s.add_argument("--zt", type=float, default=2.0)
    s.add_argument("--zu", type=float, default=10.0)
    s.add_argument("--niter", type=int, default=20)
    s.add_argument("--skin", action="store_true")
    s.add_argument("--backend", default="jit", choices=("jit", "fused"),
                   help="per-step implementation: plain XLA (default) or "
                        "the fused GPU kernel (needs --skin and a GPU)")
    s.add_argument("--chunk", type=int, default=0, metavar="K",
                   help="stream the series host->device K records at a "
                        "time (overlapped chunked pipeline) instead of "
                        "keeping it device-resident")
    s.add_argument("--out", default="aerobulk_series.nc")
    s.set_defaults(fn=cmd_series)

    cf = sub.add_parser("cdnf", help="ice form-drag curves vs concentration")
    cf.add_argument("--zu", type=float, default=10.0)
    cf.add_argument("--n", type=int, default=101)
    cf.add_argument("--out", default="cdnf_curves.json")
    cf.set_defaults(fn=cmd_cdnf)

    cx = sub.add_parser("cx-vs-wind", help="transfer-coef vs wind sweeps")
    cx.add_argument("--algos", default="coare3p0,coare3p6,ncar,ecmwf,andreas")
    cx.add_argument("--dtheta", default="-5,-2,0,2,5",
                    help="air-sea potential temp differences [K]")
    cx.add_argument("--rh", type=float, default=80.0)
    cx.add_argument("--zt", type=float, default=10.0)
    cx.add_argument("--zu", type=float, default=10.0)
    cx.add_argument("--out", default="cx_vs_wind.json")
    cx.set_defaults(fn=cmd_cx_vs_wind)

    cn = sub.add_parser("coef-n10", help="neutral coefficient curves")
    cn.add_argument("--algos", default="coare3p0,coare3p6,ncar,ecmwf,andreas")
    cn.add_argument("--out", default="coef_n10.json")
    cn.set_defaults(fn=cmd_coef_n10)

    ps = sub.add_parser("psi-stab", help="stability-function profiles")
    ps.add_argument("--out", default="psi_stab.json")
    ps.set_defaults(fn=cmd_psi_stab)

    b = sub.add_parser("bench", help="per-chip benchmark")
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    if args.device == "auto" and args.cmd in _CPU_FP64_CMDS:
        _select_device("cpu")
    else:
        _select_device(args.device)
    from .compile_cache import enable_compile_cache
    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
