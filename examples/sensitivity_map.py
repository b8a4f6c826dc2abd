#!/usr/bin/env python3
"""Adjoint sensitivity maps — d(net heat flux)/d(SST) and d/d(wind)
over a global grid, via one reverse-mode sweep each.

A data-assimilation / coupling staple the Fortran reference cannot
produce: the sensitivity of the net turbulent heat flux Q = QL + QH to
every input field simultaneously, at every grid point, from ONE
``jax.grad`` evaluation per input (not 2*N finite-difference solves).
The jit path runs in fp64 on either platform: the CPU and the GPU both
have native fp64.

Physically, dQ/dSST is the local air-sea feedback strength (W/m^2/K,
negative: a warmer ocean loses more heat) whose spatial structure —
strongest over warm, windy regions — falls out of the adjoint directly.

Run: python examples/sensitivity_map.py [out.png]   (~30 s CPU)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax                       # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp          # noqa: E402
import numpy as np               # noqa: E402

from aerobulk_tpu.api import AeroBulkConfig, flux_step  # noqa: E402

NY, NX = 90, 180    # 2-degree demo grid; the adjoint scales like the primal


def synthetic_climatology():
    """Smooth, geographically structured fields (zonal SST gradient,
    mid-latitude westerlies) so the sensitivity map has real structure."""
    lat = np.linspace(-89, 89, NY)[:, None] * np.ones((1, NX))
    lon = np.ones((NY, 1)) * np.linspace(0, 358, NX)[None, :]
    sst = 302.0 - 27.0 * (np.abs(lat) / 90.0) ** 1.7 \
        + 1.5 * np.sin(np.radians(3 * lon))
    t_zt = sst - 1.0 + 0.5 * np.cos(np.radians(2 * lat))
    U = 4.0 + 8.0 * np.sin(np.radians(2 * np.abs(lat))) ** 2
    q_zt = 0.8 * 0.012 * np.exp((sst - 302.0) / 18.0)
    return (jnp.asarray(sst), jnp.asarray(t_zt), jnp.asarray(q_zt),
            jnp.asarray(U), lat[:, 0], lon[0])


def main(out_png="sensitivity_map.png"):
    platform = jax.devices()[0].platform
    dtype = jnp.float64
    sst, t_zt, q_zt, U, lat, lon = (x.astype(dtype) if hasattr(x, "astype")
                                    else x
                                    for x in synthetic_climatology())
    slp = jnp.full((NY, NX), 101000.0, dtype)
    rsw = jnp.full((NY, NX), 250.0, dtype)
    rlw = jnp.full((NY, NX), 370.0, dtype)
    cfg = AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)

    def qnet(sst, U):
        out, _ = flux_step(cfg, sst, t_zt, q_zt, U, jnp.zeros_like(U), slp,
                           rad_sw=rsw, rad_lw=rlw, isecday_utc=43200)
        return jnp.sum(out.QL + out.QH)

    # one reverse sweep per input field: full-grid sensitivity maps
    dq_dsst, dq_du = jax.jit(jax.grad(qnet, argnums=(0, 1)))(sst, U)
    dq_dsst, dq_du = np.asarray(dq_dsst), np.asarray(dq_du)

    print(f"platform={platform}  dQ/dSST [W/m^2/K]: "
          f"min {dq_dsst.min():+.1f}  median {np.median(dq_dsst):+.1f}  "
          f"max {dq_dsst.max():+.1f}")
    print(f"                  dQ/dU [W/m^2 per m/s]: "
          f"min {dq_du.min():+.1f}  median {np.median(dq_du):+.1f}  "
          f"max {dq_du.max():+.1f}")
    assert np.isfinite(dq_dsst).all() and np.isfinite(dq_du).all()

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(2, 1, figsize=(9, 8), constrained_layout=True)
    for ax, field, title, unit in (
            (axes[0], dq_dsst, "dQ/dSST (air-sea feedback strength)",
             "W m$^{-2}$ K$^{-1}$"),
            (axes[1], dq_du, "dQ/dU$_{10}$", "W m$^{-2}$ (m/s)$^{-1}$")):
        lim = np.percentile(np.abs(field), 99)
        im = ax.pcolormesh(lon, lat, field, cmap="RdBu_r",
                           vmin=-lim, vmax=lim, shading="auto")
        ax.set_title(title)
        ax.set_xlabel("lon")
        ax.set_ylabel("lat")
        fig.colorbar(im, ax=ax, label=unit)
    fig.suptitle("Adjoint sensitivities of net turbulent heat flux "
                 "(COARE 3.6 + skin, one reverse sweep per field)")
    fig.savefig(out_png, dpi=110)
    print(f"wrote {out_png}")


if __name__ == "__main__":
    main(*sys.argv[1:2])
