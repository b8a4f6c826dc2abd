"""Cool-skin / warm-layer schemes as pure functions over an explicit state.

The reference keeps the warm-layer memory in mutable module arrays
(``mod_skin_coare.f90:31-36``, ``mod_skin_ecmwf.f90:52-55``) allocated at
``kt==nit000`` and carried across calls.  Here that hidden global becomes an
explicit, shardable :class:`SkinState` pytree threaded through the algorithm
step and ``lax.scan`` — checkpoint/resume is then trivial, and the COARE /
ECMWF symbol-name collision of the reference disappears.

All data-dependent early exits of ``WL_COARE`` (``l_exit``,
``l_destroy_wl``, the inner ``EXIT`` on ``zqac<=0``) are rewritten as masked
branch-free math so the whole scheme stays inside one fused kernel.

Functions cite the reference as ``mod_skin_{coare,ecmwf}.f90:LINE``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from . import constants as c
from .thermo import (alpha_sw, delta_skin_layer_from_coefs, fsign,
                     skin_layer_coefs, step)

__all__ = [
    "SkinState", "init_skin_state_coare", "init_skin_state_ecmwf",
    "save_skin_state", "load_skin_state",
    "save_skin_state_sharded", "load_skin_state_sharded",
    "cs_coare", "wl_coare", "cs_ecmwf", "wl_ecmwf",
    "HWL_MAX", "RD0_ECMWF",
]

HWL_MAX = 20.0     # max warm-layer depth [m]          (mod_skin_coare.f90:38)
RICH0 = 0.65       # critical Richardson number        (mod_skin_coare.f90:40)
RD0_ECMWF = 3.0    # fixed ECMWF warm-layer depth [m]  (mod_skin_ecmwf.f90:57)
_RNUWL0 = 0.5      # temp-profile exponent Nu          (mod_skin_ecmwf.f90:60)


class SkinState(NamedTuple):
    """Warm-layer memory, one value per grid point.

    COARE uses all four fields; ECMWF uses only ``dT_wl`` (and a constant
    ``Hz_wl``).  Keeping one pytree for both makes the algorithm dispatch
    uniform and the state trivially shardable alongside the inputs.
    """
    dT_wl: jnp.ndarray    # warm-layer temperature increment [K]
    Hz_wl: jnp.ndarray    # warm-layer depth [m]
    Qnt_ac: jnp.ndarray   # accumulated heat [J/m^2]   (COARE only)
    Tau_ac: jnp.ndarray   # accumulated momentum [N.s/m^2] (COARE only)


def init_skin_state_coare(shape, dtype=jnp.float64):
    """COARE warm-layer init (mod_blk_coare3p6.f90:80-88)."""
    z = jnp.zeros(shape, dtype)
    return SkinState(dT_wl=z, Hz_wl=jnp.full(shape, HWL_MAX, dtype),
                     Qnt_ac=z, Tau_ac=z)


def init_skin_state_ecmwf(shape, dtype=jnp.float64):
    """ECMWF warm-layer init: fixed depth rd0=3 m (mod_blk_ecmwf.f90:399-405)."""
    z = jnp.zeros(shape, dtype)
    return SkinState(dT_wl=z, Hz_wl=jnp.full(shape, RD0_ECMWF, dtype),
                     Qnt_ac=z, Tau_ac=z)


def save_skin_state(path: str, state: SkinState):
    """Checkpoint the warm-layer state to disk (.npz).

    The reference has no checkpointing at all — a GCM restart silently
    loses the warm layer (SURVEY.md §5).  With the explicit pytree this is
    a one-liner, enabling exact time-series resume."""
    import numpy as np
    np.savez(path, **{k: np.asarray(v) for k, v in state._asdict().items()})


def load_skin_state(path: str, dtype=None) -> SkinState:
    """Restore a warm-layer state checkpoint written by save_skin_state."""
    import numpy as np
    with np.load(path) as z:
        arrs = {k: jnp.asarray(z[k], dtype) for k in
                ("dT_wl", "Hz_wl", "Qnt_ac", "Tau_ac")}
    return SkinState(**arrs)


def save_skin_state_sharded(path: str, state: SkinState):
    """Checkpoint a (possibly sharded, possibly multi-host) warm-layer
    state with Orbax — each host writes only its addressable shards, no
    device->host gather of the global array (``save_skin_state``'s
    ``np.asarray`` would fail on a non-fully-addressable array).

    ``path`` must be a directory path (Orbax checkpoint format).  Blocks
    until the checkpoint is durable.  An existing checkpoint at ``path``
    is overwritten (``force=True``), matching :func:`save_skin_state`'s
    np.savez semantics — periodic checkpointing to a fixed resume path
    just works.
    """
    import os

    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path), state._asdict(), force=True)
    ckptr.wait_until_finished()
    ckptr.close()


def load_skin_state_sharded(path: str, like: SkinState) -> SkinState:
    """Restore a checkpoint written by :func:`save_skin_state_sharded`,
    placing each field with the sharding/dtype/shape of the matching
    field of ``like`` (e.g. a freshly built ``init_skin_state`` already
    ``device_put`` onto the mesh) — each host reads only its shards.

    Every field of ``like`` must be a ``jax.Array`` carrying a sharding;
    a numpy ``like`` would silently fall back to Orbax's
    restore-sharding-from-file path, which is unsafe across topologies.
    """
    import os

    import jax
    import orbax.checkpoint as ocp

    def spec(name, a):
        sh = getattr(a, "sharding", None)
        if sh is None:
            raise TypeError(
                f"load_skin_state_sharded: like.{name} has no .sharding "
                f"(got {type(a).__name__}); pass jax.Arrays (e.g. an "
                "init_skin_state device_put onto the mesh) so each field "
                "restores with a known placement — or use load_skin_state "
                "for host-local npz checkpoints")
        return jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=sh)

    abstract = {k: spec(k, a) for k, a in like._asdict().items()}
    ckptr = ocp.StandardCheckpointer()
    restored = ckptr.restore(os.path.abspath(path), abstract)
    ckptr.close()
    return SkinState(**restored)


# ---------------------------------------------------------------------------
# cool skin
# ---------------------------------------------------------------------------

def _cs_generic(Qsw, Qnsol, ustar, sst, fr0, Qlat=None):
    """Shared cool-skin solve: 4 implicit iterations on the viscous-layer
    thickness delta (mod_skin_coare.f90:48-93, mod_skin_ecmwf.f90:68-110).

    COARE uses fr0=0.137 and feeds Qlat into the Saunders-constant term;
    ECMWF (Zeng & Beljaars) uses fr0=0.065 and no Qlat term.

    The delta solve's Qd-independent coefficients (u*_w powers, the Qlat
    correction) are hoisted out of the 4-iteration loop via
    ``skin_layer_coefs`` — bitwise-identical, ~25% fewer ops for the
    scheme (the per-iteration jaxpr would otherwise re-derive them 5x).
    """
    alpha = alpha_sw(sst)
    coefs = skin_layer_coefs(alpha, ustar, Qlat=Qlat)
    Qabs = Qnsol
    delta = delta_skin_layer_from_coefs(coefs, Qabs)
    for _ in range(4):
        fr = jnp.maximum(
            fr0 + 11.0 * delta
            - 6.6e-5 / delta * (1.0 - jnp.exp(delta * (-1.0 / 8.0e-4))),
            0.01)
        Qabs = Qnsol + fr * Qsw
        delta = delta_skin_layer_from_coefs(coefs, Qabs)
    return Qabs * delta * (1.0 / c.rk0_w)


def cs_coare(Qsw, Qnsol, ustar, sst, Qlat):
    """COARE cool-skin dT (Fairall et al. 1996/2019) (mod_skin_coare.f90:48-93)."""
    return _cs_generic(Qsw, Qnsol, ustar, sst, 0.137, Qlat=Qlat)


def cs_ecmwf(Qsw, Qnsol, ustar, sst):
    """ECMWF cool-skin dT (Zeng & Beljaars 2005) (mod_skin_ecmwf.f90:68-110)."""
    return _cs_generic(Qsw, Qnsol, ustar, sst, 0.065)


# ---------------------------------------------------------------------------
# warm layer — COARE 3.6 (Fairall et al. 2019)
# ---------------------------------------------------------------------------

def _wl_coare_absorption(Hwl):
    """Fraction of solar flux absorbed in a warm layer of depth ``Hwl``
    (mod_skin_coare.f90:167-168).  ``exp(-H/d)`` -> ``exp(H * (-1/d))``:
    one constant multiply instead of a divide per band (<=1 ulp,
    1e-12 oracle-gated); the trailing ``/Hwl`` is a true divide."""
    return 1.0 - (0.28 * 0.014 * (1.0 - jnp.exp(Hwl * (-1.0 / 0.014)))
                  + 0.27 * 0.357 * (1.0 - jnp.exp(Hwl * (-1.0 / 0.357)))
                  + 0.45 * 12.82 * (1.0 - jnp.exp(Hwl * (-1.0 / 12.82)))) \
        / Hwl


def local_solar_seconds(lon, isecday_utc):
    """Local solar time [s since local solar midnight] from longitude and
    UTC seconds-of-day (mod_skin_coare.f90:146-150)."""
    rlag = -jnp.mod((360.0 - jnp.mod(lon, 360.0)) / 15.0, 24.0)
    rlag = -fsign(jnp.minimum(jnp.abs(rlag), jnp.abs(jnp.mod(rlag, 24.0))),
                  rlag + 12.0)
    ilag_s = jnp.trunc(rlag * 3600.0)          # Fortran INT(): toward zero
    return jnp.mod(isecday_utc + ilag_s, 24.0 * 3600.0)


def wl_coare(Qsw, Qnsol, Tau, sst, lon, isecday_utc, state: SkinState,
             rdt=3600.0, gdept=1.0) -> SkinState:
    """COARE 3.6 warm layer (mod_skin_coare.f90:97-250), branch-free.

    Returns the *committed* new state; the caller decides on which bulk
    iteration to commit (the reference's ``iwait`` flag,
    mod_blk_coare3p6.f90:370).
    """
    dTwl0 = state.dT_wl
    Hwl0 = jnp.maximum(jnp.minimum(state.Hz_wl, HWL_MAX), 0.1)
    qac0 = state.Qnt_ac
    tac0 = state.Tau_ac

    rhr_sol = local_solar_seconds(lon, isecday_utc) / 3600.0

    alpha = alpha_sw(sst)
    cd1 = jnp.sqrt(2.0 * RICH0 * c.rCp0_w / (alpha * c.grav * c.rho0_w))
    cd2 = (jnp.sqrt(2.0 * alpha * c.grav / (RICH0 * c.rho0_w))
           / c.rCp0_w ** 1.5)

    # --- early-exit cascade as masks (mod_skin_coare.f90:159-185) ---------
    dawn = (rhr_sol > 4.0) & (rhr_sol <= 6.5)          # daily reset window
    destroy = dawn

    fr = _wl_coare_absorption(Hwl0)
    Qabs = fr * Qsw + Qnsol
    no_wl_yet = (~dawn) & (jnp.abs(dTwl0) < 1.0e-6) & (Qabs <= 0.0)
    exited = dawn | no_wl_yet

    qac_first = qac0 + Qabs * rdt
    drained = (~exited) & (qac_first <= 0.0)
    destroy = destroy | drained
    active = ~(exited | drained)

    # --- main branch (mod_skin_coare.f90:188-227) -------------------------
    tac = tac0 + jnp.maximum(0.002, Tau) * rdt
    qac = qac0
    Hwl = Hwl0
    live = active
    for k in range(5):   # implicit depth solve with masked early-exit
        if k == 0:
            # first pass evaluates the absorption at the incoming depth
            # Hwl0 — bitwise the Qabs/qac already computed for the
            # drain test above; reuse instead of re-deriving (3 exp +
            # a divide per point saved)
            qac_i = qac_first
        else:
            fr_i = _wl_coare_absorption(Hwl)
            qac_i = qac0 + (fr_i * Qsw + Qnsol) * rdt
        qac = jnp.where(live, qac_i, qac)
        cont = qac_i > 0.0
        Hwl_i = jnp.maximum(jnp.minimum(
            HWL_MAX, cd1 * tac / jnp.sqrt(jnp.maximum(qac_i, 1.0e-30))), 0.1)
        Hwl = jnp.where(live & cont, Hwl_i, Hwl)
        live = live & cont

    ran_dry = active & (qac <= 0.0)
    destroy = destroy | ran_dry
    built = active & (qac > 0.0)

    qac_pos = jnp.maximum(qac, 1.0e-30)
    dTwl_new = cd2 * (qac_pos * jnp.sqrt(qac_pos)) / tac   # qac**1.5
    flg = step(gdept - Hwl)          # depth correction to the bulk-SST depth
    dTwl_new = dTwl_new * (flg + (1.0 - flg) * gdept / Hwl)

    # --- merge the three outcomes ----------------------------------------
    dT_out = jnp.where(destroy, 0.0, jnp.where(built, dTwl_new, dTwl0))
    Hz_out = jnp.where(destroy, HWL_MAX, jnp.where(built, Hwl, Hwl0))
    qac_out = jnp.where(destroy, 0.0, jnp.where(built, qac, qac0))
    tac_out = jnp.where(destroy, 0.0, jnp.where(built, tac, tac0))

    return SkinState(dT_wl=dT_out, Hz_wl=Hz_out, Qnt_ac=qac_out,
                     Tau_ac=tac_out)


# ---------------------------------------------------------------------------
# warm layer — ECMWF (Zeng & Beljaars 2005 + Takaya et al. 2010)
# ---------------------------------------------------------------------------

def _phi_takaya(zeta):
    """Stability function, Takaya et al. 2010 Eq. 5 (mod_skin_ecmwf.f90:233-253)."""
    zt2 = zeta * zeta
    tf = step(zeta)
    return (tf * (1.0 + (5.0 * zeta + 4.0 * zt2)
                  / (1.0 + 3.0 * zeta + 0.25 * zt2))
            + (1.0 - tf) / jnp.sqrt(1.0 - 16.0 * (-jnp.abs(zeta))))


def wl_ecmwf(Qsw, Qnsol, ustar, sst, state: SkinState,
             rdt=3600.0, gdept=1.0, ustk=None) -> SkinState:
    """ECMWF prognostic warm layer, 10-iteration semi-implicit solve
    (mod_skin_ecmwf.f90:113-230).  Commits every call (no ``iwait``)."""
    Hwl = state.Hz_wl      # constant rd0 = 3 m in this scheme

    flg = step(gdept - Hwl)
    tcorr = flg + (1.0 - flg) * gdept / Hwl
    dTwl_b = jnp.maximum(state.dT_wl / tcorr, 0.0)

    alpha = alpha_sw(sst)
    fr = (1.0 - 0.28 * jnp.exp(-71.5 * Hwl) - 0.27 * jnp.exp(-2.8 * Hwl)
          - 0.45 * jnp.exp(-0.07 * Hwl))            # IFS Eq. 8.157
    Qabs = fr * Qsw + Qnsol

    usw = jnp.maximum(ustar, 1.0e-4) * c.sq_radrw
    usw2 = usw * usw

    if ustk is not None:
        La = jnp.sqrt(usw / jnp.maximum(ustk, 1.0e-6))
    else:
        La = 0.3
    fLa = jnp.maximum(La ** (-2.0 / 3.0), 1.0)       # Langmuir factor, Eq. 6

    wf = step(Qabs)
    rhocp_w = c.rho0_w * c.rCp0_w
    cst1 = c.vkarmn * c.grav * alpha
    L2 = cst1 * Qabs / (rhocp_w * usw2 * usw)        # 1/L when Qabs > 0
    cst2 = cst1 / (5.0 * Hwl * usw2)
    cst0 = rdt * (_RNUWL0 + 1.0) / Hwl
    zA = cst0 * Qabs / (_RNUWL0 * rhocp_w)
    cst3 = -cst0 * c.vkarmn * usw * fLa

    dTwl_n = dTwl_b
    for _ in range(10):
        dTwl_n = 0.5 * (dTwl_n + dTwl_b)             # semi-implicit
        # 1/L when dTwl>0, Qabs<0.  The where-guard keeps the value
        # identical (sqrt(0)=0) but blocks the infinite d(sqrt)/dx at 0
        # from poisoning gradients through the unused branch (0*inf=NaN).
        pos = dTwl_n * cst2 > 0.0
        L1 = jnp.where(pos,
                       jnp.sqrt(jnp.where(pos, dTwl_n * cst2, 1.0)), 0.0)
        zeta = (1.0 - wf) * Hwl * L1 + wf * Hwl * L2
        zB = cst3 / _phi_takaya(zeta)
        dTwl_n = jnp.maximum(dTwl_b + zA + zB * dTwl_n, 0.0)

    return state._replace(dT_wl=dTwl_n * tcorr)
