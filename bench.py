"""Benchmark: fused COARE3.6 + cool-skin/warm-layer on a 0.25-degree global
grid — grid-points per second per GPU (the BASELINE.json headline metric).

Prints ONE JSON line per measured cell:
  {"metric": ..., "value": N, "unit": "points/s", "vs_baseline": N,
   "platform": "gpu", "device_kind": ..., "device_count": N,
   "gpu_name": ..., "power_limit": ..., ...}

Runs on a GPU only: with no GPU it exits with an error and prints no
line.  The per-step path is the fused Triton kernel of each cell
(aerobulk_tpu/kernels/fused.py), kept because it beat the plain XLA path
on an H100 in that cell (PERF.md, "Kernel decisions"); every speed line
carries its on-device parity fields against the jit path.

The reference publishes no performance numbers (BASELINE.md), so
``vs_baseline`` is reported against a MEASURED single-core CPU baseline:
bench_baseline/coare36_skin_baseline.c, a C transcription of the
reference's per-point COARE3.6+skin arithmetic (hot loop
mod_blk_coare3p6.f90:302-383 + CS/WL + BULK_FORMULA), compiled and run on
a CPU (see BASELINE_CPU_POINTS_S below).  The true published baseline
remains "none".

Timing: every timed function is compiled and warmed first, and each
timed call ends in ``jax.block_until_ready`` (``profiling.device_time``,
the median of several calls).  A skin cell's call is a scan over REPS
records, so its per-step time is that over REPS.
"""

import json
import subprocess
import sys

import numpy as np

from aerobulk_tpu.profiling import device_time


# MEASURED single-core CPU throughput of the reference's COARE3.6+skin
# point loop (bench_baseline/coare36_skin_baseline.c — a C transcription
# of the Fortran arithmetic).  On an Intel Xeon @ 2.10 GHz (a CPU number,
# not the GPU's):
#   cc -O3                       (the reference's own flag set): ~1.28e5
#   cc -O3 -march=native                                       : ~1.19e5
#   cc -O3 -march=native -ffast-math  (semantics-changing)     : ~1.75e5
# points/s at nb_iter=5 (median of 3, idle host; libm pow/log/atan chain
# dominates — ~500 libm calls per point).  We take the BEST observed
# (fast-math) number as the baseline so vs_baseline is conservative.
# Reproduce: cd bench_baseline && cc -O3 -march=native -ffast-math \
#   -o b coare36_skin_baseline.c -lm && ./b 200000 5
BASELINE_CPU_POINTS_S = 1.75e5

NY, NX = 721, 1440          # 0.25-degree global grid
NITER = 5                   # reference default nb_iter
REPS = 20


def _device_fields():
    """Which device the numbers come from; exits unless it is a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX's default platform is "
                 f"{devs[0].platform!r}); the benchmark measures the GPU")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
        name, limit = (x.strip() for x in smi.split(",", 1))
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        name = limit = "not reported"
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "gpu_name": name,
            "power_limit": limit}


def _emit(record):
    record = dict(record, **_device_fields())
    if "value" in record:
        record["vs_baseline"] = round(record["value"]
                                      / BASELINE_CPU_POINTS_S, 2)
    print(json.dumps(record), flush=True)


def parity_check(cfg, args, state):
    """On-device numeric parity gate: run the fused kernel and the
    plain-XLA jit path on the SAME inputs on the live device and report
    max / median / p99 relative error over the flux outputs.

    Returns a dict of parity fields for the bench JSON line."""
    import jax
    from aerobulk_tpu.kernels.fused import _jit_equiv, fused_flux_step

    sst, t, q, u, v, slp, rsw, rlw, lon = args
    ref, _ = jax.jit(lambda st: _jit_equiv(
        cfg, (*args[:8], lon, 43200, st)))(state)
    got, _ = jax.jit(lambda st: fused_flux_step(
        cfg, sst, t, q, u, v, slp, rsw, rlw, lon=lon, isecday_utc=43200,
        skin_state=st))(state)
    return _parity_fields(("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s"),
                          got, ref)


def _parity_fields(names, got, ref):
    """Fused-vs-jit deviation statistics + the gate (shared by the
    headline parity_check and the per-workload gates in --all)."""
    import numpy as np
    rels = []
    per_var = {}
    frac_by_var = {}
    sig_fracs = []
    for name, a, b in zip(names, got, ref):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        med = float(np.median(np.abs(b)) + 1e-30)
        d = np.abs(a - b)
        if med < 1e-20:
            # DEGENERATE field: the reference path says (essentially)
            # zero everywhere — e.g. ice-scheme Evap, identically ~0 —
            # so "abs error vs 10% of the field median" divides by
            # nothing and any 1e-8 of kernel rounding reads as 100%
            # significant.  The honest statement is absolute: both
            # paths must agree the field is zero to a machine-noise
            # floor (1e-6 in SI units — orders below any physical
            # flux/stress/evap signal).
            frac_by_var[name] = {
                "degenerate_zero_field": True,
                "abs_gt_1e6_floor": float(np.mean(d > 1e-6)),
                "max_abs": float(np.max(d)),
                "median_abs_of_field": med,
            }
            per_var[name] = float(np.max(d))
            sig_fracs.append(frac_by_var[name]["abs_gt_1e6_floor"])
            continue
        scale = np.maximum(np.abs(b), 1e-3 * med)
        r = np.abs(a - b) / scale
        # tail accounting.  Two views:
        #  * pointwise-relative (r): ill-conditioned where the flux
        #    crosses zero (QH's stable/unstable contour) — a 0.03 W/m^2
        #    wobble at a |QH|=0.005 W/m^2 point reads as rel~6;
        #  * SIGNIFICANT divergence: abs error above 1% / 10% of the
        #    field's median magnitude — the physically meaningful tail
        #    (root-caused in docs/PARITY.md: warm-layer regime-boundary
        #    flips at the Qabs<=0 terminator / drain / dawn thresholds).
        frac_by_var[name] = {
            "rel_gt_1e2": float(np.mean(r > 1e-2)),
            "abs_gt_1pct_median": float(np.mean(d > 0.01 * med)),
            "abs_gt_10pct_median": float(np.mean(d > 0.1 * med)),
            "max_abs": float(np.max(d)),
            "median_abs_of_field": med,
        }
        per_var[name] = float(np.max(r))
        sig_fracs.append(frac_by_var[name]["abs_gt_10pct_median"])
        rels.append(r.ravel())
    rel = np.concatenate(rels)
    frac_sig = float(np.max(sig_fracs))
    fields = {
        "parity_median_rel": float(np.median(rel)),
        "parity_p99_rel": float(np.percentile(rel, 99)),
        "parity_max_rel": float(np.max(rel)),
        "parity_max_by_var": {k: round(v, 8) for k, v in per_var.items()},
        "parity_frac_by_var": frac_by_var,
        "parity_worst_frac_abs_gt_10pct_median": frac_sig,
        # fp32 gate: the bulk must sit at fp32-roundoff scale and the
        # SIGNIFICANT tail (abs > 10% of the field median) must stay a
        # vanishing fraction (1e-4).  The pointwise-relative max is
        # reported but not gated — it measures denominator conditioning,
        # not kernel correctness (docs/PARITY.md "fp32 tail").
        "parity_ok": bool(np.median(rel) < 2e-4
                          and np.percentile(rel, 99) < 2e-2
                          and frac_sig < 1e-4),
    }
    return fields


def _arg_int(name, default):
    for i, a in enumerate(sys.argv):
        if a == name and i + 1 < len(sys.argv):
            return int(sys.argv[i + 1])
        if a.startswith(name + "="):
            return int(a.split("=", 1)[1])
    return default


def _arg_niter():
    """--niter N overrides the default iteration count (the reference's
    converged test settings are 20 for series/toy and 50 for ex_ab)."""
    return _arg_int("--niter", NITER)


def _timeit_scan(step_fn, carry, reps):
    """Seconds per step: one call is a ``reps``-step scan of ``step_fn``
    over the carry, so no step is dead code."""
    import jax

    @jax.jit
    def run(c):
        c, _ = jax.lax.scan(lambda c, _: (step_fn(c), None), c, None,
                            length=reps)
        return c

    return device_time(run, carry) / reps


def _mk_inputs(shape, dtype, seed=42, cold=False):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    base = 250.0 if cold else 285.0
    spread = 25.0 if cold else 15.0
    sst = base + spread * rng.random(shape)
    return {
        "sst": jnp.asarray(sst, dtype),
        "t": jnp.asarray(sst + rng.normal(0.0, 2.0, shape), dtype),
        "q": jnp.asarray(0.0005 + 0.012 * rng.random(shape), dtype),
        "u": jnp.asarray(rng.normal(0.0, 6.0, shape), dtype),
        "v": jnp.asarray(rng.normal(0.0, 6.0, shape), dtype),
        "slp": jnp.asarray(98000.0 + 4000.0 * rng.random(shape), dtype),
        "rsw": jnp.asarray(500.0 * rng.random(shape), dtype),
        "rlw": jnp.asarray(250.0 + 150.0 * rng.random(shape), dtype),
        "lon": jnp.asarray(360.0 * rng.random(shape), dtype),
        "frice": jnp.asarray(rng.random(shape), dtype),
    }


def skin_cell(name, algo, shape=(NY, NX), niter=NITER, reps=REPS):
    """A skin-enabled ocean step scanned over ``reps`` records with the
    skin state as carry (the production shape), fused kernel."""
    import jax.numpy as jnp
    from aerobulk_tpu.api import AeroBulkConfig, init_skin_state
    from aerobulk_tpu.kernels.fused import fused_flux_step

    f = _mk_inputs(shape, jnp.float32)
    cfg = AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=niter,
                         use_skin=True)
    state0 = init_skin_state(cfg, shape, jnp.float32)
    args = (f["sst"], f["t"], f["q"], f["u"], f["v"], f["slp"], f["rsw"],
            f["rlw"], f["lon"])

    def step(carry):
        st, acc = carry
        outs, ns = fused_flux_step(cfg, *args[:8], lon=args[8],
                                   isecday_utc=43200, skin_state=st)
        return ns, acc + outs[0] + outs[1] + outs[2]

    dt = _timeit_scan(step, (state0, jnp.zeros(shape, jnp.float32)), reps)
    rec = {"metric": name, "value": round(np.prod(shape) / dt, 1),
           "unit": "points/s", "niter": niter, "backend": "fused",
           "baseline_cpu_points_per_s": BASELINE_CPU_POINTS_S}
    if "--no-check" not in sys.argv:
        rec.update(parity_check(cfg, args, state0))
    _emit(rec)


def main():
    skin_cell("coare3p6_skin_0p25deg_grid_points_per_s_per_chip",
              "coare3p6", niter=_arg_niter())


def main_all():
    """The BASELINE.json workload configs, one JSON line each."""
    import jax
    import jax.numpy as jnp
    from aerobulk_tpu.api import (AeroBulkConfig, flux_step_ice,
                                  flux_step_mixed, run_series)
    from aerobulk_tpu.kernels.fused import fused_ice_step, fused_mixed_step

    dtype = jnp.float32
    check = "--no-check" not in sys.argv

    # Stateless algorithms -> the production path is batch_records=True:
    # the whole record batch is one vectorized call, not an nt-step scan
    # (run_series docstring), solved by the stateless fused kernel.
    def stateless_batched(name, algo, nt, shape):
        f2 = _mk_inputs((nt,) + shape, dtype, seed=7)
        forcing = {k: f2[n] for k, n in
                   (("sst", "sst"), ("t_zt", "t"), ("hum_zt", "q"),
                    ("U_zu", "u"), ("V_zu", "v"), ("slp", "slp"))}
        cfg = AeroBulkConfig(algo=algo, niter=NITER, use_skin=False)

        def run(fc, backend):
            out, _ = run_series(cfg, fc, batch_records=True, backend=backend)
            return (out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap, out.T_s)

        fused = jax.jit(lambda fc: run(fc, "fused"))
        dt = device_time(fused, forcing)
        rec = {"metric": name, "value": round(nt * np.prod(shape) / dt, 1),
               "unit": "points/s", "backend": "fused"}
        if check:
            rec.update(_parity_fields(
                ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s"),
                fused(forcing), jax.jit(lambda fc: run(fc, "jit"))(forcing)))
        _emit(rec)

    stateless_batched("ncar_small_grid_points_per_s", "ncar", 512, (32, 128))
    stateless_batched("coare3p0_bulk_1deg_points_per_s", "coare3p0",
                      32, (181, 360))
    skin_cell("coare3p6_skin_0p25deg_points_per_s", "coare3p6")
    skin_cell("ecmwf_skin_0p25deg_points_per_s", "ecmwf")

    # mixed ocean+ice cells (LG15 ice + ECMWF leads) and the ice-only
    # step (LG15 + concentration-dependent form drag), 0.25-degree.  The
    # scanned step must depend on the carry, otherwise XLA hoists the
    # loop-invariant flux computation out of the scan.
    f = _mk_inputs((NY, NX), dtype, cold=True)
    Ts_i = jnp.minimum(f["sst"], 271.0)
    mixed_args = (Ts_i, f["sst"], f["t"], f["q"], f["u"], f["v"], f["slp"],
                  f["frice"])
    ice_args = (Ts_i, f["t"], f["q"], f["u"], f["v"], f["slp"])

    def mixed_step(c):
        QL, QH, Tau, E, Ts = fused_mixed_step(
            2.0, 10.0, Ts_i, f["sst"] + c * 1e-30, *mixed_args[2:],
            niter=NITER)
        return c + QL + Tau

    def ice_step(c):
        QL, QH, Tau_x, Tau_y, E, Ts = fused_ice_step(
            "ice_lg15", 2.0, 10.0, Ts_i, f["t"], f["q"], f["u"] + c * 1e-30,
            f["v"], f["slp"], frice=f["frice"], niter=NITER)
        return c + QL + Tau_x

    for name, step, names, jit_fn, fused_fn in (
            ("mixed_ice_ocean_0p25deg_points_per_s", mixed_step,
             ("QL", "QH", "Tau", "Evap", "T_s"),
             lambda: (lambda n: (n.QL, n.QH, n.Tau, n.Evap, n.T_s))(
                 flux_step_mixed(2.0, 10.0, *mixed_args, niter=NITER)[0]),
             lambda: fused_mixed_step(2.0, 10.0, *mixed_args,
                                      niter=NITER)),
            ("ice_lg15_0p25deg_points_per_s", ice_step,
             ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s"),
             lambda: (lambda o: (o.QL, o.QH, o.Tau_x, o.Tau_y, o.Evap,
                                 o.T_s))(flux_step_ice(
                 "ice_lg15", 2.0, 10.0, *ice_args, frice=f["frice"],
                 niter=NITER)[0]),
             lambda: fused_ice_step("ice_lg15", 2.0, 10.0, *ice_args,
                                    frice=f["frice"], niter=NITER))):
        dt = _timeit_scan(step, jnp.zeros((NY, NX), dtype), 10)
        rec = {"metric": name, "value": round(NY * NX / dt, 1),
               "unit": "points/s", "backend": "fused"}
        if check:
            rec.update(_parity_fields(names, jax.jit(fused_fn)(),
                                      jax.jit(jit_fn)()))
        _emit(rec)


def main_bf16():
    """bf16 speed path for the stateless workloads (BASELINE's "fp32/bf16
    speed paths measured separately") + the precision budget vs fp32.

    bf16 is only offered for the *stateless* algorithms: the skin schemes
    integrate O(1e6 J/m^2) accumulators across time steps, which bf16's
    8-bit mantissa cannot carry (documented budget, docs/SCALING.md)."""
    import jax
    import jax.numpy as jnp
    from aerobulk_tpu.api import AeroBulkConfig, run_series

    for name, algo, nt, shape in (
            ("ncar_small_grid_bf16_points_per_s", "ncar", 512, (32, 128)),
            ("coare3p0_bulk_1deg_bf16_points_per_s", "coare3p0", 32,
             (181, 360))):
        f32 = _mk_inputs((nt,) + shape, jnp.float32, seed=7)
        names = (("sst", "sst"), ("t_zt", "t"), ("hum_zt", "q"),
                 ("U_zu", "u"), ("V_zu", "v"), ("slp", "slp"))
        cfg = AeroBulkConfig(algo=algo, niter=NITER, use_skin=False)

        @jax.jit
        def outputs(fc):
            out, _ = run_series(cfg, fc, batch_records=True)
            return out.QL, out.QH, out.Tau_x

        fc16 = {k: f32[n].astype(jnp.bfloat16) for k, n in names}
        fc32 = {k: f32[n] for k, n in names}
        # precision budget: bf16 vs fp32 relative error on the fluxes
        a = [np.asarray(x, np.float64) for x in outputs(fc16)]
        b = [np.asarray(x, np.float64) for x in outputs(fc32)]
        rel = np.concatenate([
            (np.abs(x - y)
             / np.maximum(np.abs(y), 1e-3 * np.median(np.abs(y)))).ravel()
            for x, y in zip(a, b)])
        nan_frac = float(np.mean(~np.isfinite(rel)))
        rel = rel[np.isfinite(rel)]   # NaNs counted separately (the Goff
        #                               10**x chain overflows bf16)
        dt = device_time(outputs, fc16)
        _emit({
            "metric": name, "value": round(nt * np.prod(shape) / dt, 1),
            "unit": "points/s", "backend": "jit",
            "bf16_vs_fp32_median_rel": float(np.median(rel)),
            "bf16_vs_fp32_p99_rel": float(np.percentile(rel, 99)),
            "bf16_nonfinite_frac": nan_frac,
        })


def main_grad():
    """Adjoint throughput: one value+gradient evaluation of a scalar flux
    loss (sum QL+QH) through the full skin-enabled step, d/dSST on the
    0.25-degree grid.  Two rows: the fused primal with its custom VJP
    (backward pass = AD of the jit path, kernels/fused.py
    ``_fused_step_ad``) and pure jit-path AD.  ``points/s`` counts grid
    points per complete value+grad evaluation — the speed a
    data-assimilation / calibration loop sees per iteration."""
    import jax
    import jax.numpy as jnp
    from aerobulk_tpu.api import AeroBulkConfig, init_skin_state
    from aerobulk_tpu.kernels.fused import _jit_equiv, fused_flux_step

    niter = _arg_niter()
    shape = (NY, NX)
    In = _mk_inputs(shape, jnp.float32)
    cfg = AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=niter,
                         use_skin=True)
    state = init_skin_state(cfg, shape, jnp.float32)
    rest = (In["t"], In["q"], In["u"], In["v"], In["slp"], In["rsw"],
            In["rlw"])

    def loss_fused(sst):
        outs, _ = fused_flux_step(cfg, sst, *rest, lon=In["lon"],
                                  isecday_utc=43200, skin_state=state)
        return jnp.sum(outs[0] + outs[1])

    def loss_jit(sst):
        (QL, QH, *_), _ = _jit_equiv(cfg, (sst, *rest, In["lon"], 43200,
                                           state))
        return jnp.sum(QL + QH)

    record = {
        "metric": "coare3p6_skin_0p25deg_value_and_grad_points_per_s",
        "unit": "points/s", "niter": niter,
        "note": ("one complete value+gradient (d sum(QL+QH) / d SST) per "
                 "'evaluation'; fused = fused primal + custom-VJP "
                 "(jit-path AD) backward"),
    }
    grads = {}
    for name, loss in (("fused", loss_fused), ("jit", loss_jit)):
        fn = jax.jit(jax.value_and_grad(loss))
        dt = device_time(fn, In["sst"])
        record[f"{name}_points_per_s"] = round(NY * NX / dt, 1)
        grads[name] = np.asarray(fn(In["sst"])[1], np.float64)

    if "--no-check" not in sys.argv:
        # ON-DEVICE grad correctness: the fused custom-VJP gradient vs
        # pure jit-path AD on the same inputs, on the live device
        g_jit, g_fused = grads["jit"], grads["fused"]
        med = float(np.median(np.abs(g_jit)) + 1e-30)
        rel = np.abs(g_fused - g_jit) / np.maximum(np.abs(g_jit), 1e-3 * med)
        nonfinite = float(np.mean(~np.isfinite(g_fused)))
        record.update({
            "grad_parity_median_rel": float(np.median(rel)),
            "grad_parity_p99_rel": float(np.percentile(rel, 99)),
            "grad_parity_max_rel": float(np.max(rel)),
            "grad_nonfinite_frac": nonfinite,
            # the max is denominator conditioning like the forward tail
            # (docs/PARITY.md) and is not gated
            "grad_parity_ok": bool(np.median(rel) < 1e-3
                                   and np.percentile(rel, 99) < 5e-2
                                   and nonfinite == 0.0),
        })
    # headline = the faster of the two complete evaluations
    best = max(("fused", "jit"), key=lambda n: record[f"{n}_points_per_s"])
    record["value"] = record[f"{best}_points_per_s"]
    record["headline_variant"] = best
    _emit(record)


def _link_bandwidth(nbytes=256 << 20):
    """Host->device and device->host bandwidth of this host's link [B/s]:
    the best of three timed copies of ``nbytes``, each ending when the
    copy is complete (``block_until_ready`` / the host array exists)."""
    import time

    import jax

    x = np.ones(nbytes // 4, np.float32)
    h2d = []
    for _ in range(3):
        t0 = time.perf_counter()
        d = jax.device_put(x).block_until_ready()
        h2d.append(time.perf_counter() - t0)
    d2h = []
    for i in range(3):
        y = (d + np.float32(i)).block_until_ready()   # a fresh array
        t0 = time.perf_counter()
        np.asarray(y)
        d2h.append(time.perf_counter() - t0)
    return nbytes / min(h2d), nbytes / min(d2h)


def main_streamed():
    """End-to-end STREAMED production run: sustained points/s INCLUDING
    the host->device feed of every record and the device->host collection
    of the fluxes, for >= 24 records of the 0.25-degree fp32
    COARE3.6+skin workload — the reference's flagship IO-fed stateful
    time loop (test_aerobulk_buoy_series_oce.f90:364-537) at production
    scale.  Streams through run_series_pipelined's chunked fused mode
    (one H2D transfer + one fused-scan dispatch per `chunk` records,
    outputs collected asynchronously `inflight` chunks behind).

    Alongside the streamed number the SAME program is timed compute-only
    (device-resident forcing) and the H2D/D2H bandwidth is measured, so
    the gap is attributed: overlap_efficiency is streamed / compute-only,
    and overlap_efficiency_vs_bound divides by the best-case rate any
    pipeline could reach given the measured link (min of compute rate and
    transfer-bound rate).
    """
    import time

    import jax
    import jax.numpy as jnp
    from aerobulk_tpu.api import AeroBulkConfig, init_skin_state, run_series
    from aerobulk_tpu.pipeline import run_series_pipelined

    niter = _arg_niter()
    nrec = _arg_int("--nrec", 48)
    chunk = _arg_int("--chunk", 8)
    nrec = max(chunk, nrec - nrec % chunk)   # whole chunks only
    wire = ("i8d" if "--wire-i8d" in sys.argv
            else "i16" if "--wire-i16" in sys.argv else "f32")
    collect_wire = "i16" if "--collect-i16" in sys.argv else "f32"
    dtype = jnp.float32
    shape = (NY, NX)
    cfg = AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=niter,
                         use_skin=True)

    rng = np.random.default_rng(42)
    base = {
        "sst": (285.0 + 15.0 * rng.random(shape)).astype(np.float32),
        "t_zt": (283.0 + 17.0 * rng.random(shape)).astype(np.float32),
        "hum_zt": (0.004 + 0.012 * rng.random(shape)).astype(np.float32),
        "U_zu": rng.normal(0.0, 6.0, shape).astype(np.float32),
        "V_zu": rng.normal(0.0, 6.0, shape).astype(np.float32),
        "slp": (98000.0 + 4000.0 * rng.random(shape)).astype(np.float32),
        "rad_sw": (500.0 * rng.random(shape)).astype(np.float32),
        "rad_lw": (250.0 + 150.0 * rng.random(shape)).astype(np.float32),
    }
    lon = jnp.asarray(360.0 * rng.random(shape), dtype)

    # per-record evolution factors, precomputed fp32 so the streamed run
    # and the on-device reference apply BITWISE-identical arithmetic:
    # slow SST ramp, diurnal air-temperature wobble, and a full diurnal
    # shortwave cycle (the hard case for the i8d delta wire — dawn/dusk
    # records change rad_sw by a large fraction of its span)
    jts = np.arange(nrec)
    sst_off = (0.01 * jts).astype(np.float32)
    t_off = (0.3 * np.sin(2 * np.pi * jts / 24.0)).astype(np.float32)
    r_fac = np.clip(np.sin(2 * np.pi * jts / 24.0), 0.0,
                    1.0).astype(np.float32)

    def records(n):
        # sst/t_zt/rad_sw vary per record (fresh bytes); the other
        # fields are re-sent each record exactly as a real forcing
        # stream would be
        for jt in range(n):
            rec = dict(base)
            rec["sst"] = base["sst"] + sst_off[jt]
            rec["t_zt"] = base["t_zt"] + t_off[jt]
            rec["rad_sw"] = base["rad_sw"] * r_fac[jt]
            rec["isecday_utc"] = np.int32((jt * 3600) % 86400)
            yield rec

    run_kw = dict(chunk=chunk, backend="fused", lon=lon, inflight=2,
                  wire=wire, collect_wire=collect_wire)

    # warmup: compiles the chunked fused scan (+ materializes collection)
    run_series_pipelined(cfg, records(chunk), **run_kw)

    t0 = time.perf_counter()
    results, state = run_series_pipelined(cfg, records(nrec), **run_kw)
    np.asarray(state.dT_wl)                       # final sync
    streamed_s = time.perf_counter() - t0
    assert len(results) == nrec // chunk
    streamed_pts = nrec * NY * NX / streamed_s

    # compute-only: the same chunked fused-scan program, forcing resident
    # on device, same number of dispatches
    forcing_dev = {k: jax.device_put(
        np.broadcast_to(v, (chunk,) + shape).copy()) for k, v in
        base.items()}
    isd_dev = jax.device_put(
        np.arange(chunk, dtype=np.int32) * 3600 % 86400)

    @jax.jit
    def chunk_scan(fc, isd, st):
        return run_series(cfg, fc, skin_state=st, isecday_utc=isd,
                          lon=lon, backend="fused")

    state0 = init_skin_state(cfg, shape, dtype)
    jax.block_until_ready(chunk_scan(forcing_dev, isd_dev, state0))
    t0 = time.perf_counter()
    st = state0
    for _ in range(nrec // chunk):
        _, st = chunk_scan(forcing_dev, isd_dev, st)
    jax.block_until_ready(st)
    compute_s = time.perf_counter() - t0
    compute_pts = nrec * NY * NX / compute_s

    h2d, d2h = _link_bandwidth()
    # bytes per value on the wire: i8d ships one int16 base + (chunk-1)
    # int8 deltas per chunk
    in_width = {"f32": 4.0, "i16": 2.0,
                "i8d": (chunk + 1) / chunk}[wire]
    out_width = 2 if collect_wire == "i16" else 4
    bytes_in = int(8 * in_width * NY * NX)  # 8 forcing fields per record
    bytes_out = 4 * out_width * NY * NX     # QL/QH/Tau/Evap collected
    # best case any pipeline could do on this link: compute and the two
    # transfer directions fully overlapped, each record still must move
    transfer_bound = 1.0 / (bytes_in / h2d + bytes_out / d2h)  # rec/s
    bound_pts = min(compute_pts, transfer_bound * NY * NX)

    check_fields = {}
    if "--no-check" not in sys.argv:
        # ON-DEVICE output-correctness check: the streamed run's
        # COLLECTED outputs (including any packed wire's quantize-on-host
        # / reconstruct-on-device leg and the packed read-back) are
        # compared against a device-resident run_series over the
        # identical forcing, built on the device.
        ncheck = min(2 * chunk, nrec)
        isd_chk = jnp.arange(ncheck, dtype=jnp.int32) * 3600 % 86400
        base_dev = {k: jax.device_put(v) for k, v in base.items()}

        sst_off_d = jnp.asarray(sst_off[:ncheck])[:, None, None]
        t_off_d = jnp.asarray(t_off[:ncheck])[:, None, None]
        r_fac_d = jnp.asarray(r_fac[:ncheck])[:, None, None]

        @jax.jit
        def ref_run():
            fc = {k: jnp.broadcast_to(v, (ncheck,) + shape)
                  for k, v in base_dev.items()}
            fc["sst"] = base_dev["sst"][None] + sst_off_d
            fc["t_zt"] = base_dev["t_zt"][None] + t_off_d
            fc["rad_sw"] = base_dev["rad_sw"][None] * r_fac_d
            out, _ = run_series(cfg, fc, isecday_utc=isd_chk, lon=lon,
                                backend="fused")
            return out.QL, out.QH, jnp.hypot(out.Tau_x, out.Tau_y), out.Evap

        ref = [np.asarray(x) for x in ref_run()]
        got = [np.concatenate([np.asarray(r[k])
                               for r in results[:ncheck // chunk]])
               for k in ("QL", "QH", "Tau", "Evap")]
        pf = _parity_fields(("QL", "QH", "Tau", "Evap"), got, ref)
        # wire-dependent gate: the exact-f32 stream runs the SAME chunked
        # fused-scan program as the reference (state carry across chunk
        # boundaries is exact) so it must sit at roundoff; the i16 wire
        # carries the documented (max-min)/131068 input quantization —
        # gated at 1e-3; packed read-back adds span/65534 on the outputs.
        quantized = (wire != "f32") or (collect_wire == "i16")
        med_gate, sig_gate = (1e-3, 1e-3) if quantized else (1e-6, 1e-5)
        check_fields = {
            "streamed_check_records": ncheck,
            "streamed_check_median_rel": pf["parity_median_rel"],
            "streamed_check_p99_rel": pf["parity_p99_rel"],
            "streamed_check_worst_frac_abs_gt_10pct_median":
                pf["parity_worst_frac_abs_gt_10pct_median"],
            "streamed_check_max_by_var": pf["parity_max_by_var"],
            "streamed_check_ok": bool(
                pf["parity_median_rel"] < med_gate
                and pf["parity_worst_frac_abs_gt_10pct_median"] < sig_gate),
        }

    record = {
        "metric": "coare3p6_skin_0p25deg_streamed_points_per_s"
                  + ({"i16": "_i16wire", "i8d": "_i8dwire"}.get(wire, ""))
                  + ("_i16out" if collect_wire == "i16" else ""),
        "unit": "points/s", "niter": niter, "nrec": nrec, "chunk": chunk,
        "backend": "fused", "wire": wire, "collect_wire": collect_wire,
        "value": round(streamed_pts, 1),
        "streamed_wall_s": round(streamed_s, 3),
        "records_per_s": round(nrec / streamed_s, 3),
        "compute_only_points_per_s": round(compute_pts, 1),
        "overlap_efficiency": round(streamed_pts / compute_pts, 4),
        "h2d_gbps": round(h2d / 1e9, 3),
        "d2h_gbps": round(d2h / 1e9, 3),
        "bytes_h2d_per_record": bytes_in,
        "bytes_d2h_per_record": bytes_out,
        "bound_points_per_s": round(bound_pts, 1),
        "overlap_efficiency_vs_bound": round(streamed_pts / bound_pts, 4),
    }
    record.update(check_fields)
    _emit(record)


if __name__ == "__main__":
    from aerobulk_tpu.compile_cache import enable_compile_cache

    _device_fields()          # no GPU: exit before any set-up
    enable_compile_cache()
    if "--all" in sys.argv:
        main_all()
    elif "--bf16" in sys.argv:
        main_bf16()
    elif "--grad" in sys.argv:
        main_grad()
    elif "--streamed" in sys.argv:
        main_streamed()
    else:
        main()
