"""fp32 speed-path sanity: single-precision results track the fp64 gates.

Production runs on the GPU are fp32; the parity gates all run fp64.  This bounds the fp32 drift: bulk statistics must stay within
~0.1% of fp64 away from branch thresholds (individual points near wind
floors / z0t switches can legitimately diverge further).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from aerobulk_tpu.api import AeroBulkConfig, flux_step


@pytest.mark.parametrize("algo", ["coare3p6", "ecmwf", "ncar", "andreas"])
def test_fp32_tracks_fp64(algo):
    rng = np.random.default_rng(21)
    n = 5000
    sst = 278.0 + 22.0 * rng.random(n)
    t = sst + rng.normal(0, 2.0, n)
    q = 0.003 + 0.012 * rng.random(n)
    u = 1.0 + 14.0 * rng.random(n)          # keep off the low-wind floors
    v = rng.normal(0, 3.0, n)
    slp = 99000.0 + 3000.0 * rng.random(n)
    rsw = 500.0 * rng.random(n)
    rlw = 300.0 + 120.0 * rng.random(n)

    skin = algo in ("coare3p6", "ecmwf")
    cfg = AeroBulkConfig(algo=algo, niter=5, use_skin=skin)

    def run(dtype):
        a = [jnp.asarray(x, dtype) for x in (sst, t, q, u, v, slp)]
        kw = {}
        if skin:
            kw = dict(rad_sw=jnp.asarray(rsw, dtype),
                      rad_lw=jnp.asarray(rlw, dtype),
                      isecday_utc=43200)
        out, _ = flux_step(cfg, *a, **kw)
        return (np.asarray(out.QL, np.float64),
                np.asarray(out.Tau, np.float64))

    ql64, tau64 = run(jnp.float64)
    ql32, tau32 = run(jnp.float32)

    for a64, a32, name in ((ql64, ql32, "QL"), (tau64, tau32, "Tau")):
        scale = np.percentile(np.abs(a64), 95)
        rel = np.abs(a64 - a32) / scale
        assert np.median(rel) < 2e-4, (algo, name, np.median(rel))
        assert np.percentile(rel, 99) < 5e-3, (algo, name)
