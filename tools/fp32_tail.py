"""Root-cause the fused-kernel fp32 parity tail (VERDICT r2 item 1).

The on-device parity gate (bench.py) shows a handful of points that
diverge by O(1) relative while the bulk sits at fp32 roundoff.
Hypothesis: those are REGIME-BOUNDARY points — the warm-layer scheme's
physical branch conditions (the dawn-reset window ``4 < rhr_sol <= 6.5``,
the ``Qabs <= 0`` inertness test, the accumulator drain ``qac + Qabs*rdt
<= 0``, mod_skin_coare.f90:159-185) are knife-edge comparisons, and the
fused kernel's fp32 rounding (op ordering, fma contraction) can
land an input's comparison operand on the other side of the threshold
from the XLA jit path's.  Both answers are then *self-consistent
evaluations of the same physics* with the branch resolved differently.

This script reproduces the bench parity inputs (seed 42), runs both paths
on the live device, extracts every point with rel > 1e-2 on any flux, and
classifies each against the branch-boundary distances computed in fp64.
Output: a JSON classification summary (printed; feeds docs/PARITY.md).

Run on the GPU:  python tools/fp32_tail.py
CPU sanity mode: python tools/fp32_tail.py --cpu  (interpret kernel: tail
                 should be EMPTY — no kernel rounding to flip branches)
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

CPU = "--cpu" in sys.argv
if CPU:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

NY, NX = 721, 1440
NITER = 5
ISD = 43200


def bench_inputs():
    """Bit-identical to bench.py's input construction (seed 42, fp32)."""
    dtype = jnp.float32
    shape = (NY, NX)
    rng = np.random.default_rng(42)
    sst = jnp.asarray(285.0 + 15.0 * rng.random(shape), dtype)
    t = jnp.asarray(np.asarray(sst) + rng.normal(0.0, 2.0, shape), dtype)
    q = jnp.asarray(0.004 + 0.012 * rng.random(shape), dtype)
    u = jnp.asarray(rng.normal(0.0, 6.0, shape), dtype)
    v = jnp.asarray(rng.normal(0.0, 6.0, shape), dtype)
    slp = jnp.asarray(98000.0 + 4000.0 * rng.random(shape), dtype)
    rsw = jnp.asarray(500.0 * rng.random(shape), dtype)
    rlw = jnp.asarray(250.0 + 150.0 * rng.random(shape), dtype)
    lon = jnp.asarray(360.0 * rng.random(shape), dtype)
    return (sst, t, q, u, v, slp, rsw, rlw, lon)


def main():
    from aerobulk_tpu.api import AeroBulkConfig, flux_step, init_skin_state
    from aerobulk_tpu.kernels.fused import fused_flux_step
    from aerobulk_tpu.skin import local_solar_seconds

    args = bench_inputs()
    sst, t, q, u, v, slp, rsw, rlw, lon = args
    cfg = AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=NITER,
                         use_skin=True)
    state = init_skin_state(cfg, (NY, NX), jnp.float32)

    @jax.jit
    def run_jit(st):
        out, ns = flux_step(cfg, sst, t, q, u, v, slp, rad_sw=rsw,
                            rad_lw=rlw, isecday_utc=ISD, lon=lon,
                            skin_state=st)
        return (out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap,
                out.T_s), ns

    @jax.jit
    def run_fused(st):
        return fused_flux_step(cfg, sst, t, q, u, v, slp, rsw, rlw,
                               lon=lon, isecday_utc=ISD, skin_state=st,
                               interpret=CPU)

    print("running jit path...", flush=True)
    ref, ns_j = run_jit(state)
    ref = [np.asarray(x, np.float64) for x in ref]
    print("running fused path...", flush=True)
    got, ns_f = run_fused(state)
    got = [np.asarray(x, np.float64) for x in got]

    names = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")
    bad = np.zeros((NY, NX), bool)
    rel_by = {}
    abs_by = {}
    for name, a, b in zip(names, got, ref):
        scale = np.maximum(np.abs(b), 1e-3 * float(np.median(np.abs(b))))
        r = np.abs(a - b) / scale
        rel_by[name] = r
        abs_by[name] = np.abs(a - b)
        bad |= r > 1e-2

    iy, ix = np.nonzero(bad)
    n_bad = iy.size
    print(f"divergent points (rel > 1e-2 on any flux): {n_bad} "
          f"of {NY * NX} ({n_bad / NY / NX:.2e})", flush=True)

    # --- classify against the physical branch boundaries (fp64 calc) ----
    lon64 = np.asarray(lon, np.float64)[iy, ix]
    rhr = np.asarray(local_solar_seconds(jnp.asarray(lon64), ISD)) / 3600.0

    # warm-layer state divergence: did the two paths commit different
    # warm layers / accumulators at these points?
    d_dTwl = np.abs(np.asarray(ns_f.dT_wl, np.float64)
                    - np.asarray(ns_j.dT_wl, np.float64))[iy, ix]
    d_qac = np.abs(np.asarray(ns_f.Qnt_ac, np.float64)
                   - np.asarray(ns_j.Qnt_ac, np.float64))[iy, ix]

    # distance to the dawn-window edges (hours): 4.0 and 6.5
    d_dawn = np.minimum(np.abs(rhr - 4.0), np.abs(rhr - 6.5))

    # T_s divergence (the skin temperature carries any branch flip into
    # every flux through q_sat/dt/dq)
    d_Ts = np.abs(got[5] - ref[5])[iy, ix]

    summary = {
        "platform": jax.devices()[0].platform,
        "n_points": int(NY * NX),
        "n_divergent_gt_1e2": int(n_bad),
        "frac_divergent": float(n_bad / NY / NX),
        "max_rel_by_var": {k: float(np.max(v)) for k, v in rel_by.items()},
        "median_rel": float(np.median(
            np.concatenate([v.ravel() for v in rel_by.values()]))),
    }
    if n_bad:
        state_flip = (d_dTwl > 1e-4) | (d_qac > 1.0)
        # is the "tail" actually an ill-conditioned DENOMINATOR?  A point
        # whose reference flux is near zero turns an ordinary fp32
        # absolute wobble into a huge relative number.
        med_abs = {k: float(np.median(np.abs(r)))
                   for k, r in zip(names, ref)}
        near_zero = {}
        for name, b in zip(names, ref):
            nz = np.abs(b)[iy, ix] < 0.05 * med_abs[name]
            big = rel_by[name][iy, ix] > 1e-2
            near_zero[name] = {
                "divergent_on_this_var": int(np.sum(big)),
                "of_which_ref_below_5pct_of_median": int(np.sum(big & nz)),
                "max_ABS_diff_at_divergent": float(
                    np.max(abs_by[name][iy, ix] * big, initial=0.0)),
                "median_abs_of_var": med_abs[name],
            }
        summary.update({
            "near_zero_denominator_analysis": near_zero,
            "divergent_with_warm_layer_state_flip": int(np.sum(state_flip)),
            "divergent_near_dawn_window_lt_0p01h": int(
                np.sum(d_dawn < 0.01)),
            "divergent_near_dawn_window_lt_0p1h": int(np.sum(d_dawn < 0.1)),
            "max_T_s_divergence_K": float(np.max(d_Ts)),
            "max_dT_wl_divergence_K": float(np.max(d_dTwl)),
            "worst_points": [
                {"iy": int(iy[k]), "ix": int(ix[k]),
                 "rel_QH": float(rel_by["QH"][iy[k], ix[k]]),
                 "abs_QH_diff_W_m2": float(abs_by["QH"][iy[k], ix[k]]),
                 "QH_ref_W_m2": float(ref[1][iy[k], ix[k]]),
                 "d_dawn_h": float(d_dawn[k]),
                 "d_dT_wl_K": float(d_dTwl[k]),
                 "d_Ts_K": float(d_Ts[k])}
                for k in np.argsort(
                    -rel_by["QH"][iy, ix])[:10].tolist()],
        })
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
