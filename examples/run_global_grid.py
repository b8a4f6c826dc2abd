#!/usr/bin/env python3
"""Production demo at full scale: COARE 3.6 + cool-skin/warm-layer over
the REAL 0.25-degree global grid (721 x 1440, fp32) on the GPU, one
synthetic day of hourly records streamed host->device through the chunked
pipeline (one H2D transfer + one scan dispatch per chunk, the fused
kernel per step, fluxes collected asynchronously), with NetCDF
diagnostics written through io.write_series — "this is how a GCM would
use it".

The analogue of the reference's flagship workload
(test_aerobulk_buoy_series_oce.f90:364-537: NetCDF-fed stateful time loop
-> PT_SERIES diagnostics), at 1M grid points per record instead of one
buoy.  Prints the measured sustained throughput (including all H2D/D2H),
comparable to `python bench.py --streamed`.

Usage:
    python examples/run_global_grid.py [--ny N] [--nx N] [--nt N]
        [--chunk K] [--out FILE.nc]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax
import jax.numpy as jnp

from aerobulk_tpu import AeroBulkConfig
from aerobulk_tpu.io import write_series
from aerobulk_tpu.pipeline import run_series_pipelined


def _arg(name, default):
    for i, a in enumerate(sys.argv):
        if a == name and i + 1 < len(sys.argv):
            return type(default)(sys.argv[i + 1])
    return default


NY, NX = _arg("--ny", 721), _arg("--nx", 1440)   # 0.25-degree global
NT = _arg("--nt", 24)                            # one day, hourly
CHUNK = _arg("--chunk", 8)
OUT = _arg("--out", "global_day_fluxes.nc")
WIRE = _arg("--wire", "f32")                     # 'i16' halves feed bytes


def synthetic_day(nt):
    """One day of hourly forcing records (synthetic but physically
    shaped: diurnal shortwave cycle, drifting SST, noisy winds)."""
    rng = np.random.default_rng(0)
    sst = (285.0 + 15.0 * rng.random((NY, NX))).astype(np.float32)
    t0 = sst + rng.normal(0, 2, (NY, NX)).astype(np.float32)
    q = (0.004 + 0.012 * rng.random((NY, NX))).astype(np.float32)
    u = rng.normal(0, 6, (NY, NX)).astype(np.float32)
    v = rng.normal(0, 6, (NY, NX)).astype(np.float32)
    slp = np.full((NY, NX), 101000.0, np.float32)
    rlw = np.full((NY, NX), 380.0, np.float32)
    for jt in range(nt):
        diurnal = 700.0 * max(0.0, np.sin((jt - 6) / 12 * np.pi))
        yield {
            "sst": sst + np.float32(0.02 * jt),
            "t_zt": t0,
            "hum_zt": q,
            "U_zu": u,
            "V_zu": v,
            "slp": slp,
            "rad_sw": np.full((NY, NX), diurnal, np.float32),
            "rad_lw": rlw,
            "isecday_utc": np.int32(jt * 3600 % 86400),
        }


def main():
    dev = jax.devices()[0]
    on_gpu = dev.platform == "gpu"
    cfg = AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)
    # longitude grid anchors each point's warm-layer solar clock
    lon = jnp.asarray(
        np.broadcast_to(np.linspace(0.0, 360.0, NX, endpoint=False,
                                    dtype=np.float32), (NY, NX)))

    kw = dict(chunk=CHUNK, backend="fused" if on_gpu else "jit", lon=lon,
              inflight=2, wire=WIRE,
              collect=lambda out: {"QL": out.QL, "QH": out.QH,
                                   "Tau_x": out.Tau_x, "Evap": out.Evap,
                                   "T_s": out.T_s})

    # warm-up chunk: pays the one-off compile so the measured run reflects
    # the sustained streaming rate
    run_series_pipelined(cfg, synthetic_day(CHUNK), **kw)

    t0 = time.perf_counter()
    results, final_state = run_series_pipelined(cfg, synthetic_day(NT), **kw)
    np.asarray(final_state.dT_wl)
    wall = time.perf_counter() - t0

    pts = NT * NY * NX / wall
    print(f"device: {dev.platform}  grid: {NY}x{NX}  records: {NT} "
          f"(chunks of {CHUNK})")
    print(f"streamed wall time: {wall:.2f} s  ->  {pts:.3e} points/s "
          "(incl. all H2D + D2H)")

    QL = np.concatenate([r["QL"] for r in results])
    QH = np.concatenate([r["QH"] for r in results])
    Tau_x = np.concatenate([r["Tau_x"] for r in results])
    Evap = np.concatenate([r["Evap"] for r in results])
    T_s = np.concatenate([r["T_s"] for r in results])
    assert np.isfinite(QL).all() and np.isfinite(T_s).all()

    # NetCDF diagnostics (PT_SERIES analogue): daily mean + final record
    # of each flux — full (nt, ny, nx) dumps are available the same way,
    # this keeps the demo artifact small.
    tm = np.asarray([0.0, (NT - 1) * 3600.0])
    write_series(OUT, tm, {
        "QL": np.stack([QL.mean(0), QL[-1]]),
        "QH": np.stack([QH.mean(0), QH[-1]]),
        "Tau_x": np.stack([Tau_x.mean(0), Tau_x[-1]]),
        "Evap": np.stack([Evap.mean(0), Evap[-1]]),
        "T_s": np.stack([T_s.mean(0), T_s[-1]]),
        "dT_wl": np.stack([np.asarray(final_state.dT_wl)] * 2),
    }, units={"QL": "W/m^2", "QH": "W/m^2", "Tau_x": "N/m^2",
              "Evap": "kg/m^2/s", "T_s": "K", "dT_wl": "K"})
    print(f"wrote {OUT}: daily-mean + final-record QL/QH/Tau_x/Evap/T_s "
          f"and the final warm-layer state")
    print(f"daily-mean global-mean QL = {QL.mean():.2f} W/m^2, "
          f"max warm-layer dT = {float(np.max(np.asarray(final_state.dT_wl))):.3f} K")


if __name__ == "__main__":
    main()
