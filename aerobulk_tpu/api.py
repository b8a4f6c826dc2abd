"""User-facing API: config, validation, single-step flux, time series.

This layer replaces the reference's driver stack — ``AEROBULK_INIT`` /
``AEROBULK_MODEL`` / ``AEROBULK_BYE`` (mod_aerobulk.f90:24-268) and
``aerobulk_compute`` (mod_aerobulk_compute.f90:22-213) — with:

  * :class:`AeroBulkConfig` — a frozen dataclass instead of mutable module
    globals (``nb_iter``, ``ctype_humidity``, ``rdt``, ``gdept_1d``,
    ``l_use_skin_schemes``);
  * :func:`init` — host-side validation / masking / humidity detection
    (the AEROBULK_INIT semantics), outside jit;
  * :func:`flux_step` — one time record, pure & jittable, explicit
    :class:`SkinState` in/out (no hidden allocate/save/deallocate);
  * :func:`run_series` — ``lax.scan`` over the time axis, carrying the
    warm-layer state exactly as the reference's time loop does;
  * :func:`flux` — one-shot convenience wrapper.

Unlike the reference, the sea-ice algorithm family is reachable from the
same dispatcher (the reference never wired ice algos into AEROBULK_MODEL —
SURVEY.md §1), via ``ice_*`` algorithm names.

Known reference bugs deliberately NOT replicated (SURVEY.md §4): the
library-level warm layer hardcoding ``isecday_utc=12``, ``plong=0``
(mod_aerobulk_compute.f90:126-136) — here solar time is a REQUIRED input
whenever the warm layer needs it (no silent midnight anchor; only the
drop-in :func:`aerobulk_model` wrapper keeps the reference value as its
default, loudly documented); and ``AEROBULK_INIT`` being fed ``rad_lw``
as ``prsw`` (mod_aerobulk.f90:248).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as c
from . import thermo
from .algos import OCEAN_ALGOS, FluxResult
from .skin import SkinState, init_skin_state_coare, init_skin_state_ecmwf


@dataclasses.dataclass(frozen=True)
class AeroBulkConfig:
    """Static configuration of a flux computation (hashable, jit-friendly)."""
    algo: str = "coare3p6"     # one of OCEAN_ALGOS
    zt: float = 2.0            # height of t/q measurements [m]
    zu: float = 10.0           # height of wind measurement [m]
    niter: int = 5             # bulk iterations (reference default nb_iter=5)
    use_skin: bool = False     # cool-skin + warm-layer (COARE*/ECMWF only)
    humidity: str = "sh"       # 'sh' [kg/kg] | 'rh' [%] | 'dp' [K]
    rdt: float = 3600.0        # warm-layer accumulation timestep [s]
    gdept: float = 1.0         # depth of bulk-SST measurement [m]

    def __post_init__(self):
        if self.algo not in OCEAN_ALGOS:
            raise ValueError(
                f"unknown algorithm {self.algo!r}; available: "
                f"{sorted(OCEAN_ALGOS)}")
        if self.humidity not in ("sh", "rh", "dp", "auto"):
            raise ValueError(f"unknown humidity type {self.humidity!r}")
        if self.use_skin and not OCEAN_ALGOS[self.algo][1]:
            raise ValueError(
                f"algorithm {self.algo!r} does not support skin schemes "
                "(only coare3p0/coare3p6/ecmwf do)")


class FluxOutput(NamedTuple):
    """Fluxes + full diagnostics for one time record."""
    QL: jnp.ndarray      # latent heat flux [W/m^2]
    QH: jnp.ndarray      # sensible heat flux [W/m^2]
    Tau: jnp.ndarray     # wind stress module [N/m^2]
    Tau_x: jnp.ndarray   # zonal wind stress [N/m^2]
    Tau_y: jnp.ndarray   # meridional wind stress [N/m^2]
    Evap: jnp.ndarray    # evaporation [kg/m^2/s] (<0: ocean loses water)
    T_s: jnp.ndarray     # surface (skin if enabled, else bulk) temp [K]
    rho_a: jnp.ndarray   # air density at zu [kg/m^3]
    diag: FluxResult     # full per-algorithm diagnostics


def init_skin_state(cfg: AeroBulkConfig, shape, dtype=jnp.float64) -> SkinState:
    """Fresh warm-layer state appropriate to the configured algorithm."""
    if cfg.algo == "ecmwf":
        return init_skin_state_ecmwf(shape, dtype)
    return init_skin_state_coare(shape, dtype)


# ---------------------------------------------------------------------------
# host-side validation (AEROBULK_INIT semantics) — numpy, outside jit
# ---------------------------------------------------------------------------

def detect_humidity_type(hum, mask=None) -> str:
    """Guess humidity kind ('sh'/'dp'/'rh') from value ranges
    (mod_phymbl.f90:1957-2007)."""
    h = np.asarray(hum, dtype=np.float64)
    if mask is None:
        mask = np.ones_like(h, dtype=bool)
    else:
        mask = np.asarray(mask, dtype=bool)
    vals = h[mask]
    mean, vmin, vmax = vals.mean(), vals.min(), vals.max()

    def in_range(lo, hi, hi_inc=False):
        top_ok = (mean <= hi and vmax <= hi) if hi_inc else (mean < hi and vmax < hi)
        return lo <= mean and lo <= vmin and top_ok

    if in_range(c.ref_sha_min, c.ref_sha_max):
        return "sh"
    if in_range(c.ref_dpt_min, c.ref_dpt_max):
        return "dp"
    if in_range(c.ref_rlh_min, c.ref_rlh_max, hi_inc=True):
        return "rh"
    raise ValueError(
        f"cannot identify humidity type: mean={mean:.4g} min={vmin:.4g} "
        f"max={vmax:.4g}")


_UNIT_RANGES = {
    "sst": (c.ref_sst_min, c.ref_sst_max, "K"),
    "t_air": (c.ref_taa_min, c.ref_taa_max, "K"),
    "q_air": (c.ref_sha_min, c.ref_sha_max, "kg/kg"),
    "rh_air": (c.ref_rlh_min, c.ref_rlh_max, "%"),
    "dp_air": (c.ref_dpt_min, c.ref_dpt_max, "K"),
    "slp": (c.ref_slp_min, c.ref_slp_max, "Pa"),
    "u10": (-c.ref_wnd_max, c.ref_wnd_max, "m/s"),
    "v10": (-c.ref_wnd_max, c.ref_wnd_max, "m/s"),
    "wnd": (c.ref_wnd_min, c.ref_wnd_max, "m/s"),
    "rad_sw": (c.ref_rsw_min, c.ref_rsw_max, "W/m^2"),
    "rad_lw": (c.ref_rlw_min, c.ref_rlw_max, "W/m^2"),
}


def check_unit_consistency(field: str, x, mask=None):
    """Abort if a field is outside its physical range — wrong units
    (mod_phymbl.f90:1851-1954)."""
    lo, hi, unit = _UNIT_RANGES[field]
    x = np.asarray(x, dtype=np.float64)
    m = np.ones_like(x, dtype=bool) if mask is None else np.asarray(mask, bool)
    vals = x[m]
    if vals.max() > hi or vals.min() < lo or not (lo <= vals.mean() <= hi):
        raise ValueError(
            f"field {field!r} does not seem to be in [{unit}]: "
            f"min={vals.min():.4g} max={vals.max():.4g} mean={vals.mean():.4g}")


def init(cfg: AeroBulkConfig, sst, t_zt, hum_zt, U_zu, V_zu, slp,
         rad_sw=None, rad_lw=None):
    """Validate inputs, build the in-range mask, detect humidity type.

    Host-side (numpy) equivalent of ``AEROBULK_INIT``
    (mod_aerobulk.f90:24-170).  Returns ``(mask, humidity_type)``; raises
    ``ValueError`` on unit inconsistencies or if every point is masked.
    """
    sst = np.asarray(sst, np.float64)
    shapes = {np.shape(a) for a in (sst, t_zt, hum_zt, U_zu, V_zu, slp)
              if a is not None}
    if len(shapes) != 1:
        raise ValueError(f"input shapes disagree: {shapes}")

    mask = ((np.asarray(sst) >= c.ref_sst_min) & (np.asarray(sst) <= c.ref_sst_max)
            & (np.asarray(t_zt) >= c.ref_taa_min) & (np.asarray(t_zt) <= c.ref_taa_max)
            & (np.asarray(slp) >= c.ref_slp_min) & (np.asarray(slp) <= c.ref_slp_max))
    wnd = np.sqrt(np.asarray(U_zu) ** 2 + np.asarray(V_zu) ** 2)
    mask &= (wnd >= c.ref_wnd_min) & (wnd <= c.ref_wnd_max)
    if not mask.any():
        raise ValueError("aerobulk_tpu.init: all points masked — check units")

    htype = detect_humidity_type(hum_zt, mask) if cfg.humidity == "auto" \
        else cfg.humidity

    check_unit_consistency("sst", sst, mask)
    check_unit_consistency("t_air", t_zt, mask)
    hum_field = {"sh": "q_air", "rh": "rh_air", "dp": "dp_air"}[htype]
    check_unit_consistency(hum_field, hum_zt, mask)
    check_unit_consistency("slp", slp, mask)
    check_unit_consistency("wnd", wnd, mask)
    if rad_sw is not None:
        check_unit_consistency("rad_sw", rad_sw, mask)
    if rad_lw is not None:
        check_unit_consistency("rad_lw", rad_lw, mask)
    return mask, htype


# ---------------------------------------------------------------------------
# the pure compute step (aerobulk_compute semantics) — jittable
# ---------------------------------------------------------------------------

def flux_step(cfg: AeroBulkConfig, sst, t_zt, hum_zt, U_zu, V_zu, slp,
              rad_sw=None, rad_lw=None, isecday_utc=None, lon=None,
              skin_state: Optional[SkinState] = None):
    """Compute fluxes for one time record (mod_aerobulk_compute.f90:22-213).

    Args mirror ``aerobulk_compute``: ``t_zt`` is ABSOLUTE air temperature
    at zt [K]; ``hum_zt`` is interpreted per ``cfg.humidity``.  Returns
    ``(FluxOutput, SkinState)``.

    ``isecday_utc`` (UTC seconds since 00h) anchors the COARE warm layer's
    solar clock and is REQUIRED when the configured algorithm uses it
    (coare3p0/coare3p6 with ``use_skin=True``).  There is deliberately no
    default: the reference hardcodes ``isecday_utc=12`` — 12 *seconds*
    past midnight — at the library level (mod_aerobulk_compute.f90:136, a
    known bug), which silently anchors the warm layer to midnight.  Pass
    the record's true seconds-of-day (``io.seconds_of_day``), ``43200``
    for solar noon, or ``12`` explicitly to replicate the reference bug
    (:func:`aerobulk_model`, the drop-in compat wrapper, does the latter).
    """
    fn, supports_skin, needs_time = OCEAN_ALGOS[cfg.algo]

    # humidity conversion (slp floored at 50000 Pa as the reference does)
    if cfg.humidity == "auto":
        raise ValueError("flux_step: resolve humidity='auto' via init() "
                         "and rebuild the config with the detected type")
    if cfg.humidity == "sh":
        q_zt = hum_zt
    elif cfg.humidity == "dp":
        q_zt = thermo.q_air_dp(hum_zt, jnp.maximum(slp, 50000.0))
    else:
        q_zt = thermo.q_air_rh(hum_zt, t_zt, jnp.maximum(slp, 50000.0))

    wnd = jnp.sqrt(U_zu * U_zu + V_zu * V_zu)
    ssq = c.rdct_qsat_salt * thermo.q_sat(sst, slp)
    theta_zt = thermo.theta_from_z_p0_t_q(cfg.zt, slp, t_zt, q_zt)

    if lon is None:
        lon = jnp.zeros_like(sst)

    if cfg.use_skin:
        if rad_sw is None or rad_lw is None:
            raise ValueError("flux_step: rad_sw & rad_lw required with skin")
        Qsw = (1.0 - c.roce_alb0) * rad_sw
        kw = dict(niter=cfg.niter, use_cs=True, use_wl=True, Qsw=Qsw,
                  rad_lw=rad_lw, slp=slp, skin_state=skin_state,
                  rdt=cfg.rdt, gdept=cfg.gdept)
        if needs_time:
            if isecday_utc is None:
                raise ValueError(
                    f"flux_step: algo {cfg.algo!r} with use_skin=True "
                    "needs isecday_utc (UTC seconds since 00h) for the "
                    "warm layer's solar clock.  Pass the record's true "
                    "seconds-of-day, 43200 for solar noon, or 12 "
                    "explicitly to replicate the reference's hardcoded "
                    "value (a known bug: mod_aerobulk_compute.f90:136 "
                    "anchors the warm layer 12 seconds past midnight)")
            kw.update(isecday_utc=isecday_utc, lon=lon)
        res, state = fn(cfg.zt, cfg.zu, sst, theta_zt, ssq, q_zt, wnd, **kw)
    elif supports_skin:
        res, state = fn(cfg.zt, cfg.zu, sst, theta_zt, ssq, q_zt, wnd,
                        niter=cfg.niter, skin_state=skin_state)
    else:
        res = fn(cfg.zt, cfg.zu, sst, theta_zt, ssq, q_zt, wnd,
                 niter=cfg.niter)
        state = skin_state if skin_state is not None else \
            init_skin_state(cfg, jnp.shape(sst), jnp.result_type(sst))

    Tau, QH, QL, Evap, rho_a = thermo.bulk_formula(
        cfg.zu, res.T_s, res.q_s, res.t_zu, res.q_zu,
        res.Cd, res.Ch, res.Ce, wnd, res.Ubzu, slp)

    # stress vector decomposition with |U| > 1e-3 guard
    safe = wnd > 1.0e-3
    inv_w = jnp.where(safe, 1.0 / jnp.maximum(wnd, 1.0e-3), 0.0)
    Tau_x = Tau * inv_w * U_zu
    Tau_y = Tau * inv_w * V_zu

    out = FluxOutput(QL=QL, QH=QH, Tau=Tau, Tau_x=Tau_x, Tau_y=Tau_y,
                     Evap=Evap, T_s=res.T_s, rho_a=rho_a, diag=res)
    return out, state


_LINEARIZABLE = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp",
                 "rad_sw", "rad_lw")


def flux_step_linearized(cfg: AeroBulkConfig, sst, t_zt, hum_zt, U_zu,
                         V_zu, slp, rad_sw=None, rad_lw=None,
                         isecday_utc=None, lon=None,
                         skin_state: Optional[SkinState] = None,
                         wrt: str = "sst"):
    """Fluxes plus the per-point derivative of every output with respect
    to one input field, in ONE extra forward-mode pass.

    The bulk solve is pointwise — ``output[i]`` depends only on
    ``input[i]`` — so each output's Jacobian with respect to an input
    field is DIAGONAL, and a single ``jax.jvp`` with a ones tangent on
    that field evaluates the entire diagonal at once (cost ≈ one extra
    ``flux_step``; no N² Jacobian, no N finite-difference re-solves).

    Returns ``(out, d_out, state)`` where ``d_out`` is a ``FluxOutput``
    of derivatives: ``d_out.QL[i]`` is dQL/d<wrt> at point i, and
    ``d_out.diag`` carries the derivatives of every diagnostic
    (dCd/d<wrt>, dT_s/d<wrt>, ...).  The tangent of the skin state is
    discarded; ``state`` is the primal next-step state.

    This is exactly the quantity implicit air-sea coupling schemes
    consume (the reference offers no derivatives — coupled models using
    it must hand-derive linearizations): an implicit mixed-layer update
    solves ``T⁺ = T + dt·Q(T⁺)/(ρ·cp·h)`` via
    ``Q(T⁺) ≈ Q(T) + (dQ/dT)·(T⁺ − T)`` with
    ``dQ/dT = d_out.QL + d_out.QH`` from ``wrt="sst"`` — unconditionally
    stable at coupling steps where explicit forcing blows up
    (``examples/implicit_coupling.py``).
    """
    fields = dict(sst=sst, t_zt=t_zt, hum_zt=hum_zt, U_zu=U_zu,
                  V_zu=V_zu, slp=slp, rad_sw=rad_sw, rad_lw=rad_lw)
    if wrt not in _LINEARIZABLE:
        raise ValueError(f"flux_step_linearized: wrt={wrt!r} not one of "
                         f"{_LINEARIZABLE}")
    if fields[wrt] is None:
        raise ValueError(f"flux_step_linearized: wrt={wrt!r} but that "
                         "input was not provided")
    x = jnp.asarray(fields[wrt])

    def f(v):
        fx = dict(fields)
        fx[wrt] = v
        return flux_step(cfg, fx["sst"], fx["t_zt"], fx["hum_zt"],
                         fx["U_zu"], fx["V_zu"], fx["slp"],
                         rad_sw=fx["rad_sw"], rad_lw=fx["rad_lw"],
                         isecday_utc=isecday_utc, lon=lon,
                         skin_state=skin_state)

    (out, state), (d_out, _) = jax.jvp(f, (x,), (jnp.ones_like(x),))
    return out, d_out, state


def flux_step_ice(ice_algo: str, zt, zu, Ts_i, t_zt, hum_zt, U_zu, V_zu,
                  slp, frice=None, niter=5, humidity="sh", **algo_kw):
    """Fluxes over sea ice with one of the ice algorithm family.

    The reference never wired its ice algorithms into the top-level
    dispatcher (they are only called from ``src/ice/test_*.f90``); here
    they share the same entry pattern as the ocean path.  ``Ts_i`` is the
    ice surface temperature; saturation humidity at the surface uses the
    over-ice Goff formula and the bulk formula uses the sublimation branch
    (``l_ice`` semantics of mod_phymbl.f90:1193-1196).

    Returns ``(FluxOutput, FluxResult)``.
    """
    from .ice import ICE_ALGOS

    fn, needs_frice = ICE_ALGOS[ice_algo]

    if humidity == "sh":
        q_zt = hum_zt
    elif humidity == "dp":
        q_zt = thermo.q_air_dp(hum_zt, jnp.maximum(slp, 50000.0))
    else:
        q_zt = thermo.q_air_rh(hum_zt, t_zt, jnp.maximum(slp, 50000.0))

    wnd = jnp.sqrt(U_zu * U_zu + V_zu * V_zu)
    qs_i = thermo.q_sat(Ts_i, slp, l_ice=True)
    theta_zt = thermo.theta_from_z_p0_t_q(zt, slp, t_zt, q_zt)

    args = (zt, zu, Ts_i, theta_zt, qs_i, q_zt, wnd)
    if needs_frice:
        if frice is None:
            raise ValueError(f"{ice_algo} requires the ice concentration "
                             "`frice`")
        args = args + (frice,)
    res = fn(*args, niter=niter, **algo_kw)

    Tau, QH, QL, Evap, rho_a = thermo.bulk_formula(
        zu, res.T_s, res.q_s, res.t_zu, res.q_zu,
        res.Cd, res.Ch, res.Ce, wnd, res.Ubzu, slp, l_ice=True)

    safe = wnd > 1.0e-3
    inv_w = jnp.where(safe, 1.0 / jnp.maximum(wnd, 1.0e-3), 0.0)
    out = FluxOutput(QL=QL, QH=QH, Tau=Tau, Tau_x=Tau * inv_w * U_zu,
                     Tau_y=Tau * inv_w * V_zu, Evap=Evap, T_s=res.T_s,
                     rho_a=rho_a, diag=res)
    return out, res


_ICE_LINEARIZABLE = ("Ts_i", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")


def flux_step_ice_linearized(ice_algo: str, zt, zu, Ts_i, t_zt, hum_zt,
                             U_zu, V_zu, slp, frice=None, niter=5,
                             humidity="sh", wrt: str = "Ts_i", **algo_kw):
    """Ice fluxes plus the per-point derivative of every output with
    respect to one input field, in one extra forward-mode pass.

    The ice-side counterpart of :func:`flux_step_linearized` (same
    diagonal-Jacobian argument).  ``wrt="Ts_i"`` yields the quantity
    sea-ice thermodynamic solvers need: the surface energy-balance
    Newton iteration of SI3/CICE-class ice models linearizes the
    turbulent fluxes in the ice surface temperature,
    ``Q(T⁺) ≈ Q(T) + (dQ/dT)·(T⁺ − T)``, with
    ``dQ/dT = d_out.QL + d_out.QH`` here exact through the chosen bulk
    scheme (transfer-coefficient and stability dependence included)
    rather than the usual fixed-coefficient approximation.

    Returns ``(out, d_out, res)`` — primal :class:`FluxOutput`, its
    derivative w.r.t. ``wrt`` (``d_out.diag`` holds diagnostic
    derivatives), and the primal ``FluxResult``.
    """
    fields = dict(Ts_i=Ts_i, t_zt=t_zt, hum_zt=hum_zt, U_zu=U_zu,
                  V_zu=V_zu, slp=slp)
    if wrt not in _ICE_LINEARIZABLE:
        raise ValueError(f"flux_step_ice_linearized: wrt={wrt!r} not one "
                         f"of {_ICE_LINEARIZABLE}")
    x = jnp.asarray(fields[wrt])

    def f(v):
        fx = dict(fields)
        fx[wrt] = v
        return flux_step_ice(ice_algo, zt, zu, fx["Ts_i"], fx["t_zt"],
                             fx["hum_zt"], fx["U_zu"], fx["V_zu"],
                             fx["slp"], frice=frice, niter=niter,
                             humidity=humidity, **algo_kw)

    (out, res), (d_out, _) = jax.jvp(f, (x,), (jnp.ones_like(x),))
    return out, d_out, res


def flux_step_mixed(zt, zu, Ts_i, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                    frice, ice_algo="ice_lg15", ocean_algo="ecmwf",
                    niter=5, humidity="sh", simultaneous=False):
    """Mixed ocean+ice grid cell: ice fluxes over the ice fraction, ocean
    fluxes over the leads, area-weighted net (the
    ``test_aerobulk_oce+ice.f90`` workload, BASELINE config 5).

    ``simultaneous=True`` selects the reference's LG15_IO path
    (mod_blk_ice_lg15_io.f90:55-404): ice and open-water transfer
    coefficients are solved in ONE pass by the same Louis-stability
    scheme (``turb_ice_lg15_io``) instead of running a separate ocean
    algorithm over the leads; ``ice_algo``/``ocean_algo`` are then
    ignored.

    Returns ``(net FluxOutput, ice FluxOutput, ocean FluxOutput)`` where
    the net fluxes are ``A * ice + (1 - A) * ocean``.
    """
    if simultaneous:
        return _flux_step_mixed_lg15_io(zt, zu, Ts_i, sst, t_zt, hum_zt,
                                        U_zu, V_zu, slp, frice,
                                        niter=niter, humidity=humidity)
    out_i, _ = flux_step_ice(ice_algo, zt, zu, Ts_i, t_zt, hum_zt,
                             U_zu, V_zu, slp, frice=frice, niter=niter,
                             humidity=humidity)
    cfg_w = AeroBulkConfig(algo=ocean_algo, zt=zt, zu=zu, niter=niter,
                           humidity=humidity)
    out_w, _ = flux_step(cfg_w, sst, t_zt, hum_zt, U_zu, V_zu, slp)

    def blend(i, w):
        return frice * i + (1.0 - frice) * w

    net = FluxOutput(
        QL=blend(out_i.QL, out_w.QL), QH=blend(out_i.QH, out_w.QH),
        Tau=blend(out_i.Tau, out_w.Tau),
        Tau_x=blend(out_i.Tau_x, out_w.Tau_x),
        Tau_y=blend(out_i.Tau_y, out_w.Tau_y),
        Evap=blend(out_i.Evap, out_w.Evap),
        T_s=blend(out_i.T_s, out_w.T_s),
        rho_a=blend(out_i.rho_a, out_w.rho_a), diag=out_w.diag)
    return net, out_i, out_w


def _flux_outputs_from_result(zu, res, wnd, U_zu, V_zu, slp, l_ice):
    """BULK_FORMULA + stress decomposition for one surface's FluxResult."""
    Tau, QH, QL, Evap, rho_a = thermo.bulk_formula(
        zu, res.T_s, res.q_s, res.t_zu, res.q_zu,
        res.Cd, res.Ch, res.Ce, wnd, res.Ubzu, slp, l_ice=l_ice)
    safe = wnd > 1.0e-3
    inv_w = jnp.where(safe, 1.0 / jnp.maximum(wnd, 1.0e-3), 0.0)
    return FluxOutput(QL=QL, QH=QH, Tau=Tau, Tau_x=Tau * inv_w * U_zu,
                      Tau_y=Tau * inv_w * V_zu, Evap=Evap, T_s=res.T_s,
                      rho_a=rho_a, diag=res)


def _flux_step_mixed_lg15_io(zt, zu, Ts_i, sst, t_zt, hum_zt, U_zu, V_zu,
                             slp, frice, niter=5, humidity="sh"):
    """LG15_IO mixed-cell step: one simultaneous ice+water coefficient
    solve (mod_blk_ice_lg15_io.f90:55-404), then per-surface BULK_FORMULA
    (ice branch over ice, ocean branch over leads) and area blending."""
    from .ice import turb_ice_lg15_io

    if humidity == "sh":
        q_zt = hum_zt
    elif humidity == "dp":
        q_zt = thermo.q_air_dp(hum_zt, jnp.maximum(slp, 50000.0))
    else:
        q_zt = thermo.q_air_rh(hum_zt, t_zt, jnp.maximum(slp, 50000.0))

    wnd = jnp.sqrt(U_zu * U_zu + V_zu * V_zu)
    qs_i = thermo.q_sat(Ts_i, slp, l_ice=True)
    ssq_w = c.rdct_qsat_salt * thermo.q_sat(sst, slp)
    theta_zt = thermo.theta_from_z_p0_t_q(zt, slp, t_zt, q_zt)

    res_i, res_w = turb_ice_lg15_io(zt, zu, Ts_i, theta_zt, qs_i, q_zt,
                                    wnd, frice, Ts_w=sst, qs_w=ssq_w,
                                    niter=niter)
    out_i = _flux_outputs_from_result(zu, res_i, wnd, U_zu, V_zu, slp, True)
    out_w = _flux_outputs_from_result(zu, res_w, wnd, U_zu, V_zu, slp, False)

    def blend(i, w):
        return frice * i + (1.0 - frice) * w

    net = FluxOutput(
        QL=blend(out_i.QL, out_w.QL), QH=blend(out_i.QH, out_w.QH),
        Tau=blend(out_i.Tau, out_w.Tau),
        Tau_x=blend(out_i.Tau_x, out_w.Tau_x),
        Tau_y=blend(out_i.Tau_y, out_w.Tau_y),
        Evap=blend(out_i.Evap, out_w.Evap),
        T_s=blend(out_i.T_s, out_w.T_s),
        rho_a=blend(out_i.rho_a, out_w.rho_a), diag=out_w.diag)
    return net, out_i, out_w


# ---------------------------------------------------------------------------
# flux sanity semantics (BULK_FORMULA_VCTR's tau abort, jit-compatible)
# ---------------------------------------------------------------------------

def flux_sanity_count(out: FluxOutput):
    """Jit-compatible analogue of the reference's wind-stress sanity abort
    (``BULK_FORMULA_VCTR``, mod_phymbl.f90:1249-1253): the number of
    points with |tau| above ``ref_tau_max`` or a non-finite flux.  Returns
    a traced int32 scalar — 0 means healthy.  Fold it into diagnostics or
    check it on the host via :func:`check_flux_sanity`.

    Works on fused-path outputs too: ``run_series(backend='fused')``
    returns ``Tau=None`` (reduced output set), in which case the stress
    module is reconstructed from its components."""
    tau = out.Tau if out.Tau is not None else jnp.hypot(out.Tau_x, out.Tau_y)
    bad = ((jnp.abs(tau) > c.ref_tau_max)
           | ~jnp.isfinite(tau) | ~jnp.isfinite(out.QL)
           | ~jnp.isfinite(out.QH))
    return jnp.sum(bad.astype(jnp.int32))


def check_flux_sanity(out: FluxOutput):
    """Host-side equivalent of the reference's ``ctl_stop`` on
    ``tau > ref_tau_max`` (mod_phymbl.f90:1249-1253): raises ValueError
    naming the worst offender.  Under jit use :func:`flux_sanity_count`
    instead (aborting is not jit-compatible)."""
    n = int(flux_sanity_count(out))
    if n:
        tau = np.asarray(out.Tau if out.Tau is not None
                         else jnp.hypot(out.Tau_x, out.Tau_y), np.float64)
        worst = float(np.nanmax(np.abs(tau)))
        raise ValueError(
            f"flux sanity check failed at {n} point(s): wind stress too "
            f"strong or non-finite flux (max |tau| = {worst:.3f} N/m^2, "
            f"limit {c.ref_tau_max}) — check input units/ranges")
    return out


def run_series(cfg: AeroBulkConfig, forcing: dict,
               skin_state: Optional[SkinState] = None,
               isecday_utc=None, lon=None, remat: bool = False,
               backend: str = "jit", batch_records: bool = False,
               fused_interpret: bool = False):
    """Scan :func:`flux_step` over a time axis.

    ``forcing`` maps input names (sst, t_zt, hum_zt, U_zu, V_zu, slp,
    [rad_sw, rad_lw]) to arrays of shape ``(nt, ...)``; ``isecday_utc`` is
    an ``(nt,)`` int array of UTC seconds-of-day — REQUIRED whenever the
    config runs the COARE warm layer (see :func:`flux_step` on the
    reference's hardcoded-``12`` bug), ignored otherwise.  The warm-layer
    state threads through the scan exactly as the reference's time loop
    carries its module arrays.  Returns ``(FluxOutput stacked over nt,
    final SkinState)``.

    ``backend`` selects the per-step implementation:
      * ``"jit"``  (default) — the plain XLA path; the semantics
        reference, differentiable, works on every platform.
      * ``"fused"`` — the single-pass GPU kernel
        (:func:`aerobulk_tpu.kernels.fused.fused_flux_step`); requires
        a skin-capable config with ``use_skin=True`` and rad_sw/rad_lw
        in the forcing, and a GPU: on any other platform it raises
        unless ``fused_interpret=True`` asks for the Pallas interpreter.
        Differentiable: the kernel carries a custom VJP whose backward
        pass is AD of the jit path (kernels/fused.py ``_fused_step_ad``).
        Returns the reduced output set (QL, QH, Tau_x, Tau_y, Evap, T_s;
        ``Tau`` and ``rho_a``/``diag`` are None).

    ``batch_records=True`` (stateless configs only) computes every record
    in one vectorized call instead of scanning — the fast way to run
    station/buoy series with a no-skin algorithm.  Combine with
    ``backend="fused"`` to solve the whole batch in one stateless GPU
    kernel launch (``kernels.fused.fused_bulk_step``; reduced output
    set like the skin-path fused backend).
    """
    names = ["sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp"]
    opt = [n for n in ("rad_sw", "rad_lw") if n in forcing]
    nt = forcing["sst"].shape[0]
    if skin_state is None:
        skin_state = init_skin_state(cfg, forcing["sst"].shape[1:],
                                     jnp.result_type(forcing["sst"]))
    if batch_records:
        # Stateless configs (no skin scheme) have independent records:
        # the computation is pointwise, so the whole (nt, ...) series is
        # one vectorized flux_step call — a single device dispatch instead
        # of an nt-step scan.  Massively faster for small grids / station
        # series (the reference's main regression workload is a year of
        # hourly single-point records).  Identical results by construction.
        if cfg.use_skin:
            raise ValueError("run_series(batch_records=True) requires a "
                             "stateless (use_skin=False) config — skin "
                             "state couples consecutive records")
        if backend == "fused":
            # stateless fused kernel: the whole (nt, ...) batch is
            # flattened into tiles and solved in one kernel launch
            # (kernels/fused.py fused_bulk_step)
            from .kernels.fused import fused_bulk_step, require_gpu
            require_gpu("run_series(batch_records=True, backend='fused')",
                        fused_interpret)
            if opt or lon is not None:
                # the jit batch path forwards rad_sw/rad_lw/lon to
                # flux_step (which ignores them for stateless configs);
                # the fused kernel does not take them at all — warn so
                # the asymmetry can never silently mask a caller error
                import warnings
                warnings.warn(
                    "run_series(batch_records=True, backend='fused'): "
                    f"ignoring {opt + (['lon'] if lon is not None else [])}"
                    " — stateless configs use neither (radiation/lon only "
                    "drive the skin schemes)", stacklevel=2)
            QL, QH, Tau_x, Tau_y, Evap, T_s = fused_bulk_step(
                cfg, *(forcing[n] for n in names), interpret=fused_interpret)
            out = FluxOutput(QL=QL, QH=QH, Tau=None, Tau_x=Tau_x,
                             Tau_y=Tau_y, Evap=Evap, T_s=T_s,
                             rho_a=None, diag=None)
            return out, skin_state
        if backend != "jit":
            raise ValueError(f"run_series: unknown backend {backend!r}")
        out, _ = flux_step(
            cfg, *(forcing[n] for n in names),
            **{n: forcing[n] for n in opt},
            lon=lon, skin_state=None)
        return out, skin_state

    if isecday_utc is None:
        if cfg.use_skin and OCEAN_ALGOS[cfg.algo][2]:
            raise ValueError(
                f"run_series: algo {cfg.algo!r} with use_skin=True needs "
                "isecday_utc — an (nt,) array of UTC seconds since 00h "
                "(io.seconds_of_day of the record timestamps) — to anchor "
                "the warm layer's solar clock.  Pass "
                "jnp.full((nt,), 12) explicitly to replicate the "
                "reference's hardcoded library value (a known bug: "
                "mod_aerobulk_compute.f90:136)")
        isecday_utc = jnp.zeros((nt,), jnp.int32)   # unused by the config

    if backend == "fused":
        from .kernels.fused import fused_flux_step, require_gpu
        if not cfg.use_skin or "rad_sw" not in forcing \
                or "rad_lw" not in forcing:
            raise ValueError("run_series(backend='fused') needs a skin "
                             "config and rad_sw/rad_lw forcing")
        require_gpu("run_series(backend='fused')", fused_interpret)

        def body(state, xs):
            args, isd = xs
            (QL, QH, Tau_x, Tau_y, Evap, T_s), state = fused_flux_step(
                cfg, *(args[n] for n in names), args["rad_sw"],
                args["rad_lw"], lon=lon, isecday_utc=isd,
                skin_state=state, interpret=fused_interpret)
            return state, FluxOutput(QL=QL, QH=QH, Tau=None, Tau_x=Tau_x,
                                     Tau_y=Tau_y, Evap=Evap, T_s=T_s,
                                     rho_a=None, diag=None)
    elif backend == "jit":
        def body(state, xs):
            args, isd = xs
            out, state = flux_step(
                cfg, *(args[n] for n in names),
                **{n: args[n] for n in opt},
                isecday_utc=isd, lon=lon, skin_state=state)
            return state, out
    else:
        raise ValueError(f"run_series: unknown backend {backend!r}")

    if remat:
        # rematerialize each step in the backward pass: O(1) residual
        # memory for gradients over long series (jax.checkpoint)
        body = jax.checkpoint(body)

    xs = ({n: forcing[n] for n in names + opt}, isecday_utc)
    final_state, outs = jax.lax.scan(body, skin_state, xs)
    return outs, final_state


_MODEL_STATE: dict = {}


def aerobulk_model(jt, Nt, calgo, zt, zu, sst, t_zt, hum_zt, U_zu, V_zu,
                   slp, Niter=5, l_use_skin=False, rad_sw=None, rad_lw=None,
                   isecday_utc=12, lon=None, series_id=0):
    """Drop-in analogue of the reference's ``AEROBULK_MODEL``
    (mod_aerobulk.f90:176-268) for migrating users.

    Call with ``jt`` from 1 to ``Nt``; input validation and humidity-type
    detection run at ``jt == 1`` (the AEROBULK_INIT semantics,
    mod_aerobulk.f90:126-153) and both the warm-layer state and the
    detected humidity kind are carried between calls in a process-local
    registry, initialized at ``jt == 1`` and dropped after ``jt == Nt`` —
    exactly the reference's lifecycle (``ctype_humidity`` is detected once
    and stored, mod_aerobulk.f90:127), without the hidden module arrays.
    A series whose humidity values drift across a range boundary keeps the
    interpretation detected at init, and no per-step host sync happens.

    ``series_id`` disambiguates interleaved series sharing the same
    algorithm and grid shape, which would otherwise silently share the
    warm-layer state (the reference's module-global-state hazard).

    Returns ``(QL, QH, Tau_x, Tau_y, Evap, T_s)`` as jnp arrays.
    Prefer :func:`flux_step` / :func:`run_series` in new code (explicit
    state, jit/scan-friendly).

    NB: the default ``isecday_utc=12`` replicates the reference's
    library-level warm-layer bug verbatim (mod_aerobulk_compute.f90:136
    anchors the solar clock 12 *seconds* past midnight) — this wrapper is
    bit-compatible with the reference by design.  Pass the real
    seconds-of-day for physically-meaningful warm-layer timing.
    """
    cfg = AeroBulkConfig(algo=calgo, zt=float(zt), zu=float(zu),
                         niter=int(Niter), use_skin=bool(l_use_skin),
                         humidity="auto")
    key = (calgo, np.shape(np.asarray(sst)), series_id)
    if int(jt) == 1 or key not in _MODEL_STATE:
        _, htype = init(cfg, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                        rad_sw=rad_sw, rad_lw=rad_lw)
        cfg = dataclasses.replace(cfg, humidity=htype)
        _MODEL_STATE[key] = (
            init_skin_state(cfg, key[1],
                            jnp.result_type(jnp.asarray(sst))), htype)
    skin_state, htype = _MODEL_STATE[key]
    cfg = dataclasses.replace(cfg, humidity=htype)
    out, state = flux_step(cfg, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                           rad_sw=rad_sw, rad_lw=rad_lw,
                           isecday_utc=isecday_utc, lon=lon,
                           skin_state=skin_state)
    # the reference's BULK_FORMULA_VCTR aborts on tau > ref_tau_max
    # (mod_phymbl.f90:1249-1253); this driver-level path is host-side,
    # so the same hard-stop semantics apply here.
    check_flux_sanity(out)
    if int(jt) >= int(Nt):
        _MODEL_STATE.pop(key, None)
    else:
        _MODEL_STATE[key] = (state, htype)
    return out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap, out.T_s


def flux(algo, zt, zu, sst, t_zt, hum_zt, U_zu, V_zu, slp,
         rad_sw=None, rad_lw=None, niter=5, use_skin=False, humidity="sh",
         **kw):
    """One-shot convenience wrapper (the ``aerobulk::model`` analogue)."""
    cfg = AeroBulkConfig(algo=algo, zt=zt, zu=zu, niter=niter,
                         use_skin=use_skin, humidity=humidity)
    out, _ = flux_step(cfg, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                       rad_sw=rad_sw, rad_lw=rad_lw, **kw)
    return out
