#!/usr/bin/env python3
"""Smoke test of the flux step on the GPU, checked against the references.

Runs, in one process and in order:

  (a) device     — requires a GPU; prints its kind, the device count and
                   the card's name and power limit;
  (b) goldens    — fp64 ``flux_step`` for the five ocean algorithms on the
                   doc/ex_ab.dat inputs, against the goldens
                   (tests/test_golden_ocean.py) and the CPU fp64 path;
  (c) main path  — COARE3.6 + cool-skin/warm-layer, fp32, niter=5, on the
                   0.25-degree grid: 24 hourly records through ``run_series``
                   (forcing resident on the device) and host-fed through
                   ``run_series_pipelined(chunk=8)``, both on the fused
                   kernel; streamed against resident, and a 64x128 slice
                   against the CPU fp64 jit path;
  (d) kernels    — each fused kernel compiled at 721x1440, its memory
                   analysis, parity against the jit path on the card and
                   warmed per-step times of both.

``--four`` runs instead the sharded path on four GPUs
(``sharded_run_series`` and ``run_series_pipelined(sharding=...)`` on a
1x4 mesh over ``gx``) and the one-GPU run it is compared with.

The last line of standard output is one JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed; otherwise the exit code is 1.

Usage:  python3 chip_smoke.py [--four]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

GRID = (721, 1440)     # 0.25-degree global grid
NT = 24                # one day of hourly records
CHUNK = 8
SLICE = (64, 128)      # the part checked against the CPU fp64 path
NAMES = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")


def _smi():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def phase_device(n=1):
    """Require ``n`` GPUs as JAX's default devices; print what they are."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's default platform is "
                           f"{devs[0].platform!r}")
    if len(devs) < n:
        raise RuntimeError(f"need {n} GPUs, JAX sees {len(devs)}")
    print(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
          f"count={len(devs)}")
    print(f"nvidia-smi: {_smi()}", flush=True)
    return devs


def phase_goldens(device):
    """fp64 goldens of the five ocean algorithms on ``device``, and the
    same step on the CPU at rtol 1e-8."""
    import jax
    import jax.numpy as jnp

    import importlib.util

    from aerobulk_tpu.api import AeroBulkConfig, flux_step

    # by path: another installed package may also be called ``tests``
    spec = importlib.util.spec_from_file_location(
        "test_golden_ocean", os.path.join(ROOT, "tests",
                                          "test_golden_ocean.py"))
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True):
        for algo, exp in sorted(g.EX_AB.items()):
            cfg = AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=50,
                                 use_skin=exp["skin"])

            def step(dev, cfg=cfg):
                # eager, op by op: niter=50 unrolled is a long compile
                with jax.default_device(dev):
                    a = [jnp.asarray(x, jnp.float64) for x in (
                        g.SST, g.T_ZT, g.Q_ZT, g.U, g.V, g.SLP, g.RSW,
                        g.RLW)]
                    out, _ = flux_step(cfg, *a[:6], rad_sw=a[6],
                                       rad_lw=a[7], isecday_utc=12)
                    return [np.asarray(x) for x in (
                        out.QH, out.QL, out.Evap, out.Tau_x, out.T_s)]

            got, ref = step(device), step(cpu)
            assert got[0].dtype == np.float64
            QH, QL, E, Tx, Ts = got
            np.testing.assert_allclose(QH, exp["QH"], rtol=1e-5)
            np.testing.assert_allclose(QL, exp["QL"], rtol=1e-5)
            np.testing.assert_allclose(E * 86400.0, exp["E"], rtol=1e-5)
            np.testing.assert_allclose(Tx, exp["Tx"], rtol=1e-5)
            if exp["Ts"] is not None:
                np.testing.assert_allclose(Ts - 273.15, exp["Ts"], atol=2e-5)
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-300)
            worst = max(float(np.max(np.abs(a - b) / np.abs(b)))
                        for a, b in zip(got, ref))
            print(f"goldens {algo}: ok (QH {QH[0]:.6f} {QH[1]:.6f}; "
                  f"max rel vs CPU {worst:.3g})", flush=True)


def forcing(shape=GRID, nt=NT, seed=42):
    """Synthetic hourly forcing ``(nt, *shape)`` float32 on the host, made
    from ``seed``: random base fields, a slow SST ramp, a diurnal
    air-temperature wobble and a diurnal shortwave cycle.  Returns
    ``(fields, lon, isecday_utc)``."""
    rng = np.random.default_rng(seed)
    base = {
        "sst": 285.0 + 15.0 * rng.random(shape),
        "t_zt": 283.0 + 17.0 * rng.random(shape),
        "hum_zt": 0.004 + 0.012 * rng.random(shape),
        "U_zu": rng.normal(0.0, 6.0, shape),
        "V_zu": rng.normal(0.0, 6.0, shape),
        "slp": 98000.0 + 4000.0 * rng.random(shape),
        "rad_sw": 500.0 * rng.random(shape),
        "rad_lw": 250.0 + 150.0 * rng.random(shape),
    }
    base = {k: v.astype(np.float32) for k, v in base.items()}
    jt = np.arange(nt).reshape((nt,) + (1,) * len(shape))
    fields = {k: np.broadcast_to(v, (nt,) + shape) for k, v in base.items()}
    fields["sst"] = base["sst"] + (0.01 * jt).astype(np.float32)
    fields["t_zt"] = base["t_zt"] + (
        0.3 * np.sin(2 * np.pi * jt / 24.0)).astype(np.float32)
    fields["rad_sw"] = base["rad_sw"] * np.clip(
        np.sin(2 * np.pi * (jt - 6) / 24.0), 0.0, 1.0).astype(np.float32)
    fields = {k: np.ascontiguousarray(v, np.float32)
              for k, v in fields.items()}
    lon = (360.0 * rng.random(shape)).astype(np.float32)
    isd = (np.arange(nt, dtype=np.int32) * 3600) % 86400
    return fields, lon, isd


def _records(fields, isd):
    for j in range(len(isd)):
        rec = {k: v[j] for k, v in fields.items()}
        rec["isecday_utc"] = np.int32(isd[j])
        yield rec


def _cat(chunks, name):
    return np.concatenate([np.asarray(c[name]) for c in chunks])


def _gate(label, pf, median, sig, p99=None):
    ok = (pf["parity_median_rel"] < median
          and pf["parity_worst_frac_abs_gt_10pct_median"] < sig
          and (p99 is None or pf["parity_p99_rel"] < p99))
    print(f"{label}: median rel {pf['parity_median_rel']:.3g} "
          f"(< {median:g}), p99 rel {pf['parity_p99_rel']:.3g}"
          + (f" (< {p99:g})" if p99 is not None else "")
          + f", significant fraction "
          f"{pf['parity_worst_frac_abs_gt_10pct_median']:.3g} (< {sig:g})"
          f" -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: outside its gate")


def phase_main_path(shape=GRID, nt=NT, chunk=CHUNK, check=SLICE,
                    interpret=False):
    """The headline configuration through ``run_series`` (resident) and
    ``run_series_pipelined`` (host-fed), both on the fused kernel."""
    import jax
    import jax.numpy as jnp

    from aerobulk_tpu.api import AeroBulkConfig, run_series
    from aerobulk_tpu.pipeline import run_series_pipelined
    from bench import _parity_fields

    cfg = AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=5,
                         use_skin=True)
    fields, lon, isd = forcing(shape, nt)
    npts = nt * int(np.prod(shape))

    t0 = time.perf_counter()
    dev = {k: jax.device_put(v) for k, v in fields.items()}
    lon_d, isd_d = jax.device_put(lon), jax.device_put(isd)
    resident = jax.jit(lambda f, i, lo: run_series(
        cfg, f, isecday_utc=i, lon=lo, backend="fused",
        fused_interpret=interpret))
    out, st = jax.block_until_ready(resident(dev, isd_d, lon_d))
    print(f"run_series: compiled and ran in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    out, st = jax.block_until_ready(resident(dev, isd_d, lon_d))
    dt = time.perf_counter() - t0
    print(f"run_series (resident, fused): {nt} records in {dt:.4f} s = "
          f"{npts / dt:.4g} points/s", flush=True)
    res = {n: np.asarray(getattr(out, n)) for n in NAMES}
    for n, v in res.items():
        assert v.shape == (nt,) + tuple(shape), (n, v.shape)
        assert np.isfinite(v).all(), f"non-finite {n}"

    kw = dict(chunk=chunk, backend="fused", fused_interpret=interpret,
              lon=lon, collect=lambda o: {n: getattr(o, n) for n in NAMES})
    run_series_pipelined(cfg, _records({k: v[:chunk] for k, v in
                                        fields.items()}, isd[:chunk]), **kw)
    t0 = time.perf_counter()
    chunks, st_s = run_series_pipelined(cfg, _records(fields, isd), **kw)
    np.asarray(st_s.dT_wl)
    dt = time.perf_counter() - t0
    print(f"run_series_pipelined (host-fed, chunk={chunk}, fused): {nt} "
          f"records in {dt:.4f} s = {npts / dt:.4g} points/s", flush=True)
    got = [_cat(chunks, n) for n in NAMES]
    _gate("streamed vs resident", _parity_fields(
        NAMES, got, [res[n] for n in NAMES]), median=1e-6, sig=1e-5)

    # a slice against the CPU fp64 jit path on the same fp32 inputs
    cpu = jax.devices("cpu")[0]
    sl = (slice(None),) + tuple(slice(0, s) for s in check)
    with jax.enable_x64(True), jax.default_device(cpu):
        ref_out, _ = jax.jit(lambda f, i, lo: run_series(
            cfg, f, isecday_utc=i, lon=lo))(
            {k: jnp.asarray(v[sl], jnp.float64) for k, v in fields.items()},
            jnp.asarray(isd), jnp.asarray(lon[sl[1:]], jnp.float64))
        ref = [np.asarray(getattr(ref_out, n)) for n in NAMES]
    _gate(f"fp32 device vs fp64 CPU on a {check[0]}x{check[1]} slice",
          _parity_fields(NAMES, [res[n][sl] for n in NAMES], ref),
          median=1e-4, sig=1e-4)


def _memory(compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        return "not reported"
    return ", ".join(f"{k}={getattr(ma, k)}" for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes") if hasattr(ma, k))


def phase_kernels(shape=GRID, interpret=False, reps=10):
    """Each fused kernel at ``shape``: memory analysis, parity against the
    jit path on the same device, and warmed per-step times of both."""
    import jax
    import jax.numpy as jnp

    from aerobulk_tpu.api import (AeroBulkConfig, flux_step, flux_step_ice,
                                  flux_step_mixed, init_skin_state)
    from aerobulk_tpu.kernels import fused
    from aerobulk_tpu.profiling import device_time
    from bench import _parity_fields

    skin = AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=5,
                          use_skin=True)
    bulk = AeroBulkConfig(algo="coare3p0", zt=2.0, zu=10.0, niter=5,
                          use_skin=False)
    fields, lon, _ = forcing(shape, 1)
    f = {k: jax.device_put(v[0]) for k, v in fields.items()}
    f["lon"] = jax.device_put(lon)
    f["frice"] = jnp.clip(f["U_zu"] / 12.0 + 0.5, 0.0, 1.0)
    f["Ts_i"] = jnp.minimum(f["sst"] - 15.0, 271.0)
    st = init_skin_state(skin, shape, jnp.float32)
    ocean = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")
    ice = ("Ts_i", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "frice")
    six = lambda o: (o.QL, o.QH, o.Tau_x, o.Tau_y, o.Evap, o.T_s)  # noqa

    cases = (
        ("fused_skin_step", NAMES,
         lambda f, s: fused._jit_equiv(skin, (
             *(f[k] for k in ocean + ("rad_sw", "rad_lw", "lon")), 43200,
             s)),
         lambda f, s: fused.fused_flux_step(
             skin, *(f[k] for k in ocean + ("rad_sw", "rad_lw")),
             lon=f["lon"], isecday_utc=43200, skin_state=s,
             interpret=interpret)),
        ("fused_bulk_step", NAMES,
         lambda f, s: six(flux_step(bulk, *(f[k] for k in ocean))[0]),
         lambda f, s: fused.fused_bulk_step(
             bulk, *(f[k] for k in ocean), interpret=interpret)),
        ("fused_mixed_step", ("QL", "QH", "Tau", "Evap", "T_s"),
         lambda f, s: (lambda n: (n.QL, n.QH, n.Tau, n.Evap, n.T_s))(
             flux_step_mixed(2.0, 10.0, f["Ts_i"], *(f[k] for k in ocean),
                             f["frice"])[0]),
         lambda f, s: fused.fused_mixed_step(
             2.0, 10.0, f["Ts_i"], *(f[k] for k in ocean), f["frice"],
             interpret=interpret)),
        ("fused_ice_step", NAMES,
         lambda f, s: six(flux_step_ice(
             "ice_lg15", 2.0, 10.0, *(f[k] for k in ice[:6]),
             frice=f["frice"])[0]),
         lambda f, s: fused.fused_ice_step(
             "ice_lg15", 2.0, 10.0, *(f[k] for k in ice[:6]),
             frice=f["frice"], interpret=interpret)),
    )
    for name, names, xla, kernel in cases:
        compiled = {}
        for impl, fn in (("xla", xla), (name, kernel)):
            t0 = time.perf_counter()
            c = jax.jit(fn).lower(f, st).compile()
            print(f"{impl}: compiled in {time.perf_counter() - t0:.1f} s; "
                  f"memory: {_memory(c)}", flush=True)
            compiled[impl] = c
        ref = jax.tree_util.tree_leaves(compiled["xla"](f, st))
        got = jax.tree_util.tree_leaves(compiled[name](f, st))
        # the six/five fluxes are gated; the carried skin state is reported
        _gate(f"{name} vs jit path, same device",
              _parity_fields(names, got[:len(names)], ref[:len(names)]),
              median=2e-4, sig=1e-4, p99=2e-2)
        if len(got) > len(names):
            print(f"{name}: carried state max abs diff "
                  + ", ".join(f"{k}={float(jnp.max(jnp.abs(a - b))):.3g}"
                              for k, a, b in zip(
                                  ("dT_wl", "Hz_wl", "Qnt_ac", "Tau_ac"),
                                  got[len(names):], ref[len(names):])))
        for impl, c in compiled.items():
            dt = device_time(c, f, st, reps=reps)
            print(f"{name} [{impl}]: {dt * 1e3:.4f} ms per step at "
                  f"{shape[0]}x{shape[1]} = {np.prod(shape) / dt:.4g} "
                  "points/s", flush=True)


def phase_four(shape=GRID, nt=NT, chunk=CHUNK, n=4, interpret=False):
    """The sharded path on ``n`` devices against the one-device run."""
    import jax

    from aerobulk_tpu.api import AeroBulkConfig, run_series
    from aerobulk_tpu.pipeline import run_series_pipelined
    from aerobulk_tpu.sharding import (grid_sharding, make_grid_mesh,
                                       sharded_run_series)

    cfg = AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=5,
                         use_skin=True)
    fields, lon, isd = forcing(shape, nt)
    mesh = make_grid_mesh(jax.devices()[:n])
    d0 = jax.devices()[0]

    ref_out, ref_st = jax.jit(lambda f, i, lo: run_series(
        cfg, f, isecday_utc=i, lon=lo, backend="fused",
        fused_interpret=interpret))(
        {k: jax.device_put(v, d0) for k, v in fields.items()},
        jax.device_put(isd, d0), jax.device_put(lon, d0))
    ref = {k: np.asarray(getattr(ref_out, k)) for k in NAMES}

    sh = grid_sharding(mesh, 3)
    t0 = time.perf_counter()
    out, st = sharded_run_series(
        mesh, cfg, {k: jax.device_put(v, sh) for k, v in fields.items()},
        isecday_utc=isd, lon=jax.device_put(lon, grid_sharding(mesh)),
        backend="fused", interpret=interpret)
    jax.block_until_ready(out)
    print(f"sharded_run_series on {n} devices: {time.perf_counter() - t0:.1f}"
          f" s incl. compile; QL on "
          f"{len(out.QL.sharding.device_set)} devices", flush=True)
    assert len(out.QL.sharding.device_set) == n
    for k in NAMES:
        np.testing.assert_allclose(np.asarray(getattr(out, k)), ref[k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(np.asarray(st.dT_wl),
                               np.asarray(ref_st.dT_wl), rtol=1e-5,
                               atol=1e-7)
    print("sharded_run_series vs one device: ok (rtol 1e-5)", flush=True)

    t0 = time.perf_counter()
    chunks, st_s = run_series_pipelined(
        cfg, _records(fields, isd), chunk=chunk, backend="fused",
        fused_interpret=interpret, lon=lon, sharding=grid_sharding(mesh),
        collect=lambda o: {k: getattr(o, k) for k in NAMES})
    np.asarray(st_s.dT_wl)
    print(f"run_series_pipelined on {n} devices: "
          f"{time.perf_counter() - t0:.1f} s incl. compile", flush=True)
    for k in NAMES:
        np.testing.assert_allclose(_cat(chunks, k), ref[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(np.asarray(st_s.dT_wl),
                               np.asarray(ref_st.dT_wl), rtol=1e-5,
                               atol=1e-7)
    print("run_series_pipelined(sharding) vs one device: ok (rtol 1e-5)",
          flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    from aerobulk_tpu.compile_cache import enable_compile_cache

    devs = phase_device(4 if four else 1)
    enable_compile_cache()
    d = devs[0]
    if four:
        phases = (("four", phase_four),)
    else:
        phases = (("goldens", lambda: phase_goldens(d)),
                  ("main path", phase_main_path),
                  ("kernels", phase_kernels))
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        print(f"== phase {name}", flush=True)
        try:
            fn()
        except Exception:   # noqa: BLE001 — report and run the next phase
            traceback.print_exc()
            failed.append(name)
        print(f"== phase {name}: {'FAILED' if name in failed else 'ok'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"nvidia-smi: {_smi()}")
    if failed:
        print(f"FAILED phases: {', '.join(failed)}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
