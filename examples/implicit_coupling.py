#!/usr/bin/env python3
"""Implicit air-sea coupling with linearized bulk fluxes.

The use case behind :func:`aerobulk_tpu.flux_step_linearized`: a coupled
model stepping a thin ocean mixed layer with a coupling interval longer
than the layer's flux-feedback timescale must treat the turbulent fluxes
implicitly — Q(T⁺) ≈ Q(T) + (dQ/dT)·(T⁺ − T) — or the explicit update
amplifies (|1 + Δt·λ| > 1 with λ = (dQ/dT)/(ρ·cp·h) < 0).

GCMs coupled to the Fortran reference must hand-derive that dQ/dT from
the bulk formulae at fixed transfer coefficients (an approximation: the
coefficients themselves depend on stability, hence on T).  Here the
EXACT per-point derivative through the whole COARE solve — transfer
coefficients, stability functions, gustiness and all — is one
forward-mode pass (the Jacobian is diagonal because the solve is
pointwise; see flux_step_linearized's docstring).

The demo: a 0.2 m slab (a diurnal warm layer) under fixed forcing,
coupled every 12 h.  Explicit coupling oscillates and diverges;
implicit coupling converges monotonically to the same equilibrium a
finely-resolved explicit integration reaches.

Run: python examples/implicit_coupling.py    (~20 s CPU)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax                        # noqa: E402

# a single-point toy: run on CPU/fp64 (each of the ~800 coupling steps
# is 1 point of work, less than one device launch costs).
# AEROBULK_DEMO_PLATFORM=gpu runs it on the GPU, in fp64 there too.
if os.environ.get("AEROBULK_DEMO_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp           # noqa: E402
import numpy as np                # noqa: E402

from aerobulk_tpu.api import (AeroBulkConfig, flux_step,   # noqa: E402
                              flux_step_linearized)
from aerobulk_tpu import constants as c                    # noqa: E402

# slab + forcing (single point; everything broadcasts to grids unchanged)
H_SLAB = 0.2                      # m — diurnal-warm-layer depth
CAP = c.rho0_w * c.rCp0_w * H_SLAB   # J/m^2/K heat capacity
T_AIR, Q_AIR, WIND = 288.15, 0.008, 7.0
SLP, RAD_LW, QSOL = 101000.0, 340.0, 120.0   # absorbed solar [W/m^2]
EMIS, SIGMA = c.emiss_w, c.stefan
CFG = AeroBulkConfig(algo="coare3p6", niter=5, use_skin=False)

ARGS = (jnp.full((1,), T_AIR), jnp.full((1,), Q_AIR),
        jnp.full((1,), WIND), jnp.zeros((1,)), jnp.full((1,), SLP))


def q_net(T):
    """Net surface heat flux [W/m^2] into the slab at SST ``T`` (turbulent
    via the full bulk solve + net longwave + absorbed solar)."""
    out, _ = flux_step(CFG, T, *ARGS)
    lw = EMIS * (RAD_LW - SIGMA * T ** 4)
    return out.QL + out.QH + lw + QSOL


@jax.jit
def step_explicit(T, dt):
    return T + dt * q_net(T) / CAP


@jax.jit
def step_implicit(T, dt):
    """Backward Euler on the linearized flux: solve
    T⁺ = T + Δt·(Q(T) + Q'(T)·(T⁺ − T))/C  →  closed form in T⁺.
    Q' is EXACT through the bulk solve via one jvp (wrt='sst'),
    plus the analytic −4εσT³ of the longwave term."""
    out, d_out, _ = flux_step_linearized(CFG, T, *ARGS, wrt="sst")
    lw = EMIS * (RAD_LW - SIGMA * T ** 4)
    q = out.QL + out.QH + lw + QSOL
    dq = d_out.QL + d_out.QH - 4.0 * EMIS * SIGMA * T ** 3
    return T + dt * q / (CAP - dt * dq)


def integrate(stepper, T0, dt, t_end):
    T = jnp.full((1,), T0)
    traj = [float(T[0])]
    for _ in range(int(round(t_end / dt))):
        T = stepper(T, dt)
        traj.append(float(T[0]))
    return np.array(traj)


def main(days=30.0):
    T0, DT, T_END = 295.15, 43200.0, days * 86400.0   # 12 h coupling

    # feedback timescale from the exact derivative at T0
    _, d0, _ = flux_step_linearized(CFG, jnp.full((1,), T0), *ARGS,
                                    wrt="sst")
    lam = (float(d0.QL[0] + d0.QH[0]) - 4 * EMIS * SIGMA * T0 ** 3) / CAP
    print(f"dQ/dT at T0 = {lam * CAP:+.1f} W/m^2/K  ->  explicit stability "
          f"limit 2/|lambda| = {2 / abs(lam) / 3600:.1f} h; coupling step "
          f"= {DT / 3600:.0f} h")

    ref = integrate(step_explicit, T0, 3600.0, T_END)     # resolved truth
    exp = integrate(step_explicit, T0, DT, T_END)
    imp = integrate(step_implicit, T0, DT, T_END)

    print(f"equilibrium (resolved explicit, dt=1h): {ref[-1]:.4f} K")
    print(f"explicit  dt=12h: final {exp[-1]:.4f} K,  max |T| excursion "
          f"{np.abs(exp - ref[-1]).max():.2f} K  "
          f"{'(DIVERGED/OSCILLATING)' if np.abs(exp - ref[-1]).max() > 5 else ''}")
    print(f"implicit  dt=12h: final {imp[-1]:.4f} K,  max overshoot past "
          f"equilibrium {max(0.0, (ref[-1] - imp).max() if imp[0] > ref[-1] else (imp - ref[-1]).max()):.4f} K")

    assert abs(imp[-1] - ref[-1]) < 0.05, "implicit should hit equilibrium"
    assert np.abs(exp - ref[-1]).max() > np.abs(imp - ref[-1]).max(), \
        "explicit should be the unstable one"
    print("OK: implicit coupling stable and accurate at 12 h; explicit is not")
    return ref, exp, imp


if __name__ == "__main__":
    main()
