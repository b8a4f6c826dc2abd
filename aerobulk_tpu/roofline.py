"""Op census of the flux step, the operation side of a roofline.

:func:`count_primitives` traces a flux step and counts XLA primitives in
the jaxpr.  The computation is purely elementwise (no reductions, no
matmuls), so one equation is one op per grid point: the jaxpr gives an
*exact* per-point op census, split into transcendental classes
(exp/log/pow/sqrt/rsqrt/atan/div) and cheap ops (add/mul/select/...).
The census is chip-independent; dividing it by a device's peak rates is
the benchmark's job.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["count_primitives", "flux_step_counts"]

#: primitive-name -> cost class
TRANSCENDENTAL = {
    "exp": "exp", "exp2": "exp", "log": "log", "log1p": "log",
    "pow": "pow", "integer_pow": "cheap",  # int powers lower to mults
    "sqrt": "sqrt", "rsqrt": "sqrt", "cbrt": "pow",
    "atan": "atan", "atan2": "atan", "tanh": "exp", "erf": "exp",
    "sin": "atan", "cos": "atan",
    "div": "div",
}
_SKIP = {"broadcast_in_dim", "convert_element_type", "reshape", "squeeze",
         "transpose", "copy", "stop_gradient", "slice", "concatenate",
         "iota", "pad", "bitcast_convert_type"}


def _walk(jx, counts: Counter, mult: int = 1):
    for eqn in jx.eqns:
        name = eqn.primitive.name
        if name == "scan":
            _walk(eqn.params["jaxpr"].jaxpr, counts,
                  mult * eqn.params["length"])
            continue
        if name in ("cond", "while", "switch"):
            # the census's exactness claim relies on straight-line code
            # (+ scan with a static trip count); a data-dependent branch
            # would make "ops per point" ill-defined.  Fail loudly rather
            # than silently over/under-count.
            raise ValueError(
                f"roofline census: data-dependent control flow "
                f"({name!r}) entered the flux step — the exact per-point "
                "op count is no longer well-defined; extend _walk with "
                "an explicit policy for it")
        nested = False
        for p in eqn.params.values():
            inner = getattr(p, "jaxpr", None)
            if inner is not None:
                _walk(inner, counts, mult)
                nested = True
        if nested or name in _SKIP:
            continue
        counts[TRANSCENDENTAL.get(name, "cheap")] += mult


def count_primitives(fn: Callable, *args, **kw) -> Counter:
    """Exact per-point op census of an elementwise function (via jaxpr)."""
    jaxpr = jax.make_jaxpr(fn)(*args, **kw)
    counts: Counter = Counter()
    _walk(jaxpr.jaxpr, counts)
    return counts


def flux_step_counts(cfg=None, algo="coare3p6", niter=5,
                     use_skin=True) -> Counter:
    """Per-point op census of one full flux step (tiny 2-D trace)."""
    from .api import AeroBulkConfig, flux_step, init_skin_state

    if cfg is None:
        cfg = AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=niter,
                             use_skin=use_skin)
    shape = (1, 1)
    z = jnp.zeros(shape, jnp.float32)
    state = init_skin_state(cfg, shape, jnp.float32)

    def fn(sst, t, q, u, v, slp, rsw, rlw, lon, st):
        kw = dict(rad_sw=rsw, rad_lw=rlw, isecday_utc=43200,
                  lon=lon) if cfg.use_skin else {}
        out, ns = flux_step(cfg, sst, t, q, u, v, slp, skin_state=st, **kw)
        return out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap, out.T_s, ns

    return count_primitives(fn, z + 290.0, z + 289.0, z + 0.01, z + 5.0,
                            z, z + 1.01e5, z + 200.0, z + 350.0, z, state)
