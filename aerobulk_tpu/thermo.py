"""Thermodynamics / physics function library (vectorized JAX).

Vectorized re-implementation of the reference thermo library
(``/root/reference/src/mod_phymbl.f90``).  The reference keeps a scalar and
a vector variant of every function behind a generic interface; here each
function is a single pure ``jnp`` function that broadcasts over any shape,
so it works per-point, per-tile, under ``vmap``/``pjit``, and inside Pallas
kernels alike.

Every SIGN/MAX/MIN clamp of the reference is reproduced exactly — they are
semantics, not noise (see SURVEY.md §5 "race detection" note).

Functions cite the reference implementation as ``mod_phymbl.f90:LINE``.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from . import constants as c

__all__ = [
    "fsign", "step", "clip_mag", "nonzero_delta", "pot_temp", "abs_temp", "virt_temp",
    "pz_from_p0_tz_qz", "theta_from_z_p0_t_q", "t_from_z_p0_theta_q",
    "rho_air", "visc_air", "l_vap", "cp_air", "gamma_moist", "one_on_l",
    "ri_bulk", "e_sat", "e_sat_ice", "de_sat_dt_ice", "q_sat",
    "dq_sat_dt_ice", "q_air_rh", "q_air_dp", "rho_air_adv", "q_sat_crude",
    "dry_static_energy", "update_qnsol_tau", "bulk_formula", "alpha_sw",
    "qlw_net", "z0_from_cd", "z0_from_ustar", "cd_from_z0", "f_m_louis",
    "f_h_louis", "un10_from_ustar", "un10_from_cdn", "un10_from_cd",
    "z0tq_lkb", "e_air", "rh_air", "delta_skin_layer",
    "skin_layer_coefs", "delta_skin_layer_from_coefs",
]

# Goff-formula constants over ice (mod_phymbl.f90:143-148)
_rAg_i = -9.09718
_rBg_i = -3.56654
_rCg_i = 0.876793
_rDg_i = math.log10(6.1071)

# Louis (1979) constants (mod_phymbl.f90:150-153)
_rc_louis = 5.0
_rc2_louis = _rc_louis * _rc_louis
_ram_louis = 2.0 * _rc_louis
_rah_louis = 3.0 * _rc_louis


def fsign(a, b):
    """Fortran SIGN(a, b): |a| with the sign *bit* of b (copysign)."""
    return jnp.copysign(jnp.abs(a), b)


def step(x):
    """Fortran ``0.5 + SIGN(0.5, x)``: 1 where x >= 0, else 0."""
    return jnp.where(x >= 0, 1.0, 0.0)


def clip_mag(x, cap):
    """SIGN(MIN(|x|, cap), x) — symmetric magnitude clamp."""
    return fsign(jnp.minimum(jnp.abs(x), cap), x)


def nonzero_delta(dx, floor):
    """SIGN(MAX(|dx|, floor), dx) — keep a difference away from zero."""
    return fsign(jnp.maximum(jnp.abs(dx), floor), dx)


def pow23_pos(x):
    """``MAX(x, 0)**(2/3)`` with a finite gradient at the clamp.

    Forward-bitwise-identical to ``jnp.maximum(x, 0.0) ** (2.0 / 3.0)``
    (both give exactly 0.0 for x <= 0), but the naive form has a NaN
    gradient wherever the clamp is active — d(t^(2/3))/dt is infinite at
    t = 0, and ``inf * 0`` from the max's zero cotangent is NaN.  Used by
    the gustiness terms (COARE/ECMWF), which hit the clamp at every
    stably-stratified point; without this guard any jax.grad through the
    bulk solve is NaN over half the ocean."""
    pos = x > 0.0
    return jnp.where(pos, jnp.where(pos, x, 1.0) ** (2.0 / 3.0), 0.0)


_clip_mag = clip_mag
_nz = nonzero_delta


# ---------------------------------------------------------------------------
# temperature conversions
# ---------------------------------------------------------------------------

def pot_temp(Ta, Pz, Pref=c.Patm):
    """Potential temperature from absolute temp via Poisson eq. (mod_phymbl.f90:163-200)."""
    return Ta * (Pref / Pz) ** c.rpoiss_dry


def abs_temp(Thta, Pz, Pref=c.Patm):
    """Absolute temperature from potential temp (mod_phymbl.f90:205-241)."""
    return Thta / jnp.maximum((Pref / Pz) ** c.rpoiss_dry, 1.0e-9)


def virt_temp(Ta, qa):
    """Virtual (absolute or potential) temperature (mod_phymbl.f90:247-276)."""
    return Ta * (1.0 + c.rctv0 * qa)


def pz_from_p0_tz_qz(z, slp, Ta, qa, l_ice=False):
    """Barometric pressure at height ``z`` via 3-iteration fixed point
    (mod_phymbl.f90:283-318).

    The Goff saturation pressure depends only on ``Ta`` — loop-invariant
    — so it is evaluated once and only the cheap ``q_sat`` quotient is
    re-derived per iteration (bitwise-identical to calling q_sat thrice;
    saves 2 of the 3 Goff transcendental chains)."""
    es = e_sat_ice(Ta) if l_ice else e_sat(Ta)
    pa = slp
    for _ in range(3):
        qsat = c.reps0 * es / (pa - (1.0 - c.reps0) * es)
        f = qa / qsat
        xm = (1.0 - f) * c.rmm_dryair + f * c.rmm_water
        pa = slp * jnp.exp(-c.grav * xm * z / (c.R_gas * Ta))
    return pa


def theta_from_z_p0_t_q(z, slp, Ta, qa):
    """Absolute temp at height z -> potential temp (mod_phymbl.f90:343-375)."""
    Pz = pz_from_p0_tz_qz(z, slp, Ta, qa)
    return pot_temp(Ta, Pz, Pref=slp)


def t_from_z_p0_theta_q(z, slp, Thta, qa):
    """Potential temp at height z -> absolute temp, 4-iteration
    (mod_phymbl.f90:380-407)."""
    Ta = Thta - c.rgamma_dry * z
    for _ in range(4):
        Pz = pz_from_p0_tz_qz(z, slp, Ta, qa)
        Ta = abs_temp(Thta, Pz, Pref=slp)
    return Ta


# ---------------------------------------------------------------------------
# air properties
# ---------------------------------------------------------------------------

def rho_air(Ta, qa, slp):
    """Moist-air density, floored at 0.8 kg/m^3 (mod_phymbl.f90:522-546)."""
    return jnp.maximum(slp / (c.R_dry * Ta * (1.0 + c.rctv0 * qa)), 0.8)


def visc_air(Ta):
    """Kinematic viscosity of air [m^2/s] (mod_phymbl.f90:549-574)."""
    tc = Ta - c.rt0
    tc2 = tc * tc
    return 1.326e-5 * (1.0 + 6.542e-3 * tc + 8.301e-6 * tc2 - 4.84e-9 * tc2 * tc)


def l_vap(sst):
    """Latent heat of vaporization of water [J/kg] (mod_phymbl.f90:579-598)."""
    return (2.501 - 0.00237 * (sst - c.rt0)) * 1.0e6


def cp_air(qa):
    """Specific heat of moist air [J/K/kg] (mod_phymbl.f90:603-622)."""
    return c.rCp_dry + c.rCp_vap * qa


def gamma_moist(Ta, qa):
    """Moist adiabatic lapse rate [K/m] (mod_phymbl.f90:627-661)."""
    ta = jnp.maximum(Ta, 180.0)
    qa_ = jnp.maximum(qa, 1.0e-6)
    wa = qa_ / (1.0 - qa_)
    iRT = 1.0 / (c.R_dry * ta)
    Lv = l_vap(Ta)  # NB: reference uses un-clamped pTa here
    return c.grav * (1.0 + Lv * wa * iRT) / (
        c.rCp_dry + Lv * Lv * wa * c.reps0 * iRT / ta)


# ---------------------------------------------------------------------------
# stability metrics
# ---------------------------------------------------------------------------

def one_on_l(Thta, qa, us, ts, qs):
    """1/(Obukhov length) [1/m], capped at |200| (mod_phymbl.f90:666-693)."""
    zqa = 1.0 + c.rctv0 * qa
    ool = c.grav * c.vkarmn * (ts * zqa + c.rctv0 * Thta * qs) / jnp.maximum(
        us * us * Thta * zqa, 1.0e-9)
    return _clip_mag(ool, 200.0)


def ri_bulk(z, sst, Thta, ssq, qa, ub, Ta_layer=None, qa_layer=None):
    """Bulk Richardson number (mod_phymbl.f90:712-747)."""
    sstv = virt_temp(sst, ssq)
    dthv = virt_temp(Thta, qa) - sstv
    if Ta_layer is not None and qa_layer is not None:
        tv = virt_temp(Ta_layer, qa_layer)
    else:
        tv = 0.5 * (sstv + virt_temp(Thta - c.rgamma_dry * z, qa))
    return c.grav * dthv * z / (tv * ub * ub)


# ---------------------------------------------------------------------------
# humidity
# ---------------------------------------------------------------------------

_LOG2_10 = math.log2(10.0)


def _exp10(x):
    """10**x as exp2(x * log2(10)) — one hardware exp2 instead of a
    generic pow (the costliest elementwise primitive).
    Ulp-level identical to libm pow(10, x); the 1e-12 scalar-oracle
    tests gate the substitution."""
    return jnp.exp2(x * _LOG2_10)


def e_sat(Ta):
    """Saturation vapour pressure over water [Pa], Goff 1957
    (mod_phymbl.f90:777-800).  NB: uses rt0=273.15, as the reference does.

    ``ta/rt0`` is bound once (the jaxpr census counts each textual
    occurrence; source-level CSE is bitwise-identical and keeps the
    Mosaic op stream minimal)."""
    ta = jnp.maximum(Ta, 180.0)
    ztmp = c.rt0 / ta
    zr = ta / c.rt0
    return 100.0 * _exp10(
        10.79574 * (1.0 - ztmp)
        - 5.028 * jnp.log10(zr)
        + 1.50475e-4 * (1.0 - _exp10(-8.2969 * (zr - 1.0)))
        + 0.42873e-3 * (_exp10(4.76955 * (1.0 - ztmp)) - 1.0)
        + 0.78614)


def e_sat_ice(Ta):
    """Saturation vapour pressure over ice [Pa] (mod_phymbl.f90:815-830)."""
    ta = jnp.maximum(Ta, 180.0)
    ztmp = c.rtt0 / ta
    zle = (_rAg_i * (ztmp - 1.0) + _rBg_i * jnp.log10(ztmp)
           + _rCg_i * (1.0 - ta / c.rtt0) + _rDg_i)
    return 100.0 * _exp10(zle)


def de_sat_dt_ice(Ta):
    """d(e_sat_ice)/dT [Pa/K], analytic (mod_phymbl.f90:845-861)."""
    ta = jnp.maximum(Ta, 180.0)
    ln10 = jnp.log(10.0)
    zde = (-(_rAg_i * c.rtt0) / (ta * ta) - _rBg_i / (ta * ln10)
           - _rCg_i / c.rtt0)
    return ln10 * zde * e_sat_ice(ta)


def q_sat(Ta, slp, l_ice=False):
    """Saturation specific humidity [kg/kg] (mod_phymbl.f90:881-904)."""
    es = e_sat_ice(Ta) if l_ice else e_sat(Ta)
    return c.reps0 * es / (slp - (1.0 - c.reps0) * es)


def dq_sat_dt_ice(Ta, slp):
    """d(q_sat_ice)/dT [1/K], analytic (mod_phymbl.f90:926-945)."""
    es = e_sat_ice(Ta)
    des_dt = de_sat_dt_ice(Ta)
    ztmp = (c.reps0 - 1.0) * es + slp
    return c.reps0 * slp * des_dt / (ztmp * ztmp)


def q_air_rh(rha, Ta, slp):
    """Specific humidity from relative humidity [%] (mod_phymbl.f90:963-985)."""
    ze = 0.01 * rha * e_sat(Ta)
    return ze * c.reps0 / jnp.maximum(slp - (1.0 - c.reps0) * ze, 1.0)


def q_air_dp(da, slp):
    """Specific humidity from dew-point temperature (mod_phymbl.f90:990-1000)."""
    e = jnp.maximum(e_sat(da), 0.0)
    return e * c.reps0 / jnp.maximum(slp - (1.0 - c.reps0) * e, 1.0)


def e_air(qa, slp, niter=10):
    """Vapour pressure of air from specific humidity, fixed-point
    (mod_phymbl.f90:1706-1736; the reference iterates to 1e-6, a handful of
    iterations of this strong contraction is bitwise-converged)."""
    e = qa * slp / c.reps0
    for _ in range(niter):
        e = qa / c.reps0 * (slp - (1.0 - c.reps0) * e)
    return e


def rh_air(qa, Ta, slp):
    """Relative humidity [%] from specific humidity (mod_phymbl.f90:1741-1756)."""
    return 100.0 * e_air(qa, slp) / e_sat(Ta)


def rho_air_adv(Ta, qa, slp):
    """Air density using true virtual temperature (mod_phymbl.f90:1008-1020)."""
    return slp / (c.R_dry * Ta / (1.0 - e_air(qa, slp) / slp * (1.0 - c.reps0)))


def q_sat_crude(ts, rhoa):
    """Crude saturation humidity (mod_phymbl.f90:1029-1035)."""
    return 640380.0 / rhoa * jnp.exp(-5107.4 / ts)


def dry_static_energy(z, Ta, qa):
    """Dry static energy, IFS Eq. 3.5 (mod_phymbl.f90:1043-1055)."""
    return c.grav * z + cp_air(qa) * Ta


# ---------------------------------------------------------------------------
# fluxes
# ---------------------------------------------------------------------------

def bulk_formula(zu, ts, qs, Thta, qa, Cd, Ch, Ce, wnd, Ub, slp, l_ice=False):
    """Turbulent fluxes from transfer coefficients (mod_phymbl.f90:1149-1203).

    Returns ``(Tau, Qsen, Qlat, Evap, rhoa)``.
    Air density is evaluated at zu with a height-corrected pressure,
    exactly as the reference does.
    """
    ta = Thta - c.rgamma_dry * zu       # absolute temperature at zu
    # two rho_air evaluations share the same denominator; binding it is
    # bitwise-identical and halves the duplicated arithmetic
    den = c.R_dry * ta * (1.0 + c.rctv0 * qa)
    rho = jnp.maximum(slp / den, 0.8)
    rho = jnp.maximum((slp - rho * c.grav * zu) / den, 0.8)
    Urho = Ub * jnp.maximum(rho, 1.0)
    Tau = Urho * Cd * wnd
    evap = Urho * Ce * (qa - qs)
    Qsen = Urho * Ch * (Thta - ts) * cp_air(qa)
    if l_ice:
        Qlat = c.rLsub * evap
        Evap = jnp.minimum(evap, 0.0)
    else:
        Qlat = l_vap(ts) * evap
        Evap = evap
    return Tau, Qsen, Qlat, Evap, rho


def qlw_net(dwlw, ts, l_ice=False):
    """Net longwave flux at the surface (mod_phymbl.f90:1291-1314)."""
    emiss = c.emiss_i if l_ice else c.emiss_w
    t2 = ts * ts
    return emiss * (dwlw - c.stefan * t2 * t2)


def update_qnsol_tau(zu, ts, qs, Thta, qa, ust, tst, qst, wnd, Ub, slp, rlw):
    """Non-solar heat flux Qns = Qlat+Qsen+Qlw and wind-stress module
    (mod_phymbl.f90:1059-1103).  Returns ``(Qns, Tau, Qlat)``."""
    zdt = _nz(Thta - ts, 1.0e-9)
    zdq = _nz(qa - qs, 1.0e-12)
    z0 = ust / Ub
    Cd = z0 * z0
    Ch = z0 * tst / zdt
    Ce = z0 * qst / zdq
    Tau, Qsen, Qlat, _, _ = bulk_formula(zu, ts, qs, Thta, qa, Cd, Ch, Ce,
                                         wnd, Ub, slp)
    Qlw = qlw_net(rlw, ts)
    return Qlat + Qsen + Qlw, Tau, Qlat


def alpha_sw(sst):
    """Thermal expansion coefficient of surface sea water [1/K]
    (mod_phymbl.f90:1267-1286).

    Grad-safety double-where (docs/PARITY.md pattern): the naive
    ``max(x, 0)**0.79`` has a NaN gradient for sst <= 269.95 K (pow's
    infinite slope at 0 times the clamp's zero cotangent); forward is
    bitwise-identical (0 both ways at the clamp)."""
    x = jnp.maximum(sst - c.rt0 + 3.2, 0.0)
    pos = x > 0.0
    return 2.1e-5 * jnp.where(pos, jnp.where(pos, x, 1.0) ** 0.79, 0.0)


# ---------------------------------------------------------------------------
# roughness length / drag conversions
# ---------------------------------------------------------------------------

def z0_from_cd(zu, Cd, psi=None):
    """Roughness length from (neutral or stability-corrected) drag coefficient
    (mod_phymbl.f90:1335-1366)."""
    if psi is None:
        return zu * jnp.exp(-c.vkarmn / jnp.sqrt(Cd))
    return zu * jnp.exp(-(c.vkarmn / jnp.sqrt(Cd) + psi))


def z0_from_ustar(zu, us, uzu):
    """Roughness length from friction velocity (mod_phymbl.f90:1371-1391)."""
    return zu * jnp.exp(-c.vkarmn * uzu / us)


def cd_from_z0(zu, z0, psi=None):
    """Drag coefficient from roughness length (mod_phymbl.f90:1396-1414)."""
    if psi is None:
        r = 1.0 / jnp.log(zu / z0)
    else:
        r = 1.0 / (jnp.log(zu / z0) - psi)
    return c.vkarmn2 * r * r


def f_m_louis(zu, Rib, Cdn, z0):
    """Louis (1979) momentum stability function (mod_phymbl.f90:1419-1440)."""
    zstab = step(Rib)
    ztu = Rib / (1.0 + 3.0 * _rc2_louis * Cdn
                 * jnp.sqrt(jnp.abs(-Rib * (zu / z0 + 1.0))))
    zts = Rib / jnp.sqrt(jnp.abs(1.0 + Rib))
    return ((1.0 - zstab) * (1.0 - _ram_louis * ztu)
            + zstab / (1.0 + _ram_louis * zts))


def f_h_louis(zu, Rib, Chn, z0):
    """Louis (1979) heat stability function (mod_phymbl.f90:1458-1479)."""
    zstab = step(Rib)
    ztu = Rib / (1.0 + 3.0 * _rc2_louis * Chn
                 * jnp.sqrt(jnp.abs(-Rib * (zu / z0 + 1.0))))
    zts = Rib / jnp.sqrt(jnp.abs(1.0 + Rib))
    return ((1.0 - zstab) * (1.0 - _rah_louis * ztu)
            + zstab / (1.0 + _rah_louis * zts))


def un10_from_ustar(zu, Uzu, us, psi):
    """Neutral-stability 10-m wind from u* (mod_phymbl.f90:1498-1510)."""
    return Uzu - us / c.vkarmn * (jnp.log(zu / 10.0) - psi)


def un10_from_cdn(zu, Ub, Cdn, psi):
    """Neutral-stability 10-m wind from CdN (mod_phymbl.f90:1515-1527)."""
    return Ub / (1.0 + jnp.sqrt(Cdn) / c.vkarmn * (jnp.log(zu / 10.0) - psi))


def un10_from_cd(zu, Ub, Cd, psi):
    """Neutral-stability 10-m wind from Cd (mod_phymbl.f90:1532-1558)."""
    return jnp.sqrt(Cd) * Ub / c.vkarmn * jnp.log(10.0 / z0_from_cd(zu, Cd, psi=psi))


# Liu-Katsaros-Businger (1979) piecewise-power lookup (mod_phymbl.f90:1635-1701)
# NB: plain tuples here — creating jnp arrays at import time would
# initialize a JAX backend before callers can choose a platform.
_LKB_XA = ((0.177, 1.376, 1.026, 1.625, 4.661, 34.904, 1667.19, 5.88e5),
           (0.292, 1.808, 1.393, 1.956, 4.994, 30.709, 1448.68, 2.98e5))
_LKB_XB = ((0.0, 0.929, -0.599, -1.018, -1.475, -2.067, -2.907, -3.935),
           (0.0, 0.826, -0.528, -0.870, -1.297, -1.845, -2.682, -3.616))
_LKB_XRAN = (0.0, 0.11, 0.825, 3.0, 10.0, 30.0, 100.0, 300.0, 1000.0)


def z0tq_lkb(iflag, Rer, z0):
    """Scalar roughness lengths z0t (iflag=1) / z0q (iflag=2) from the
    roughness Reynolds number, LKB table (mod_phymbl.f90:1635-1701).

    The reference's DO WHILE bin search becomes a branch-free chain of
    scalar-constant selects over the 8 fixed (e_j, e_{j+1}] intervals —
    no table array, so the same code traces into a GPU kernel, which
    cannot capture array constants.  Out-of-range Re_r saturates at
    0.05 m exactly as the reference's -999 sentinel does after its |.|
    clamp.
    """
    xa_t, xb_t = _LKB_XA[iflag - 1], _LKB_XB[iflag - 1]
    xa = jnp.full_like(Rer, xa_t[0])
    xb = jnp.full_like(Rer, xb_t[0])
    for j in range(8):
        m = (Rer > _LKB_XRAN[j]) & (Rer <= _LKB_XRAN[j + 1])
        xa = jnp.where(m, xa_t[j], xa)
        xb = jnp.where(m, xb_t[j], xb)
    val = xa * Rer ** xb * z0 / Rer
    in_range = (Rer > 0.0) & (Rer < 1000.0)
    val = jnp.where(in_range, val, -999.0)
    return jnp.minimum(jnp.maximum(jnp.abs(val), 1.0e-9), 0.05)


def variance(x):
    """Population *standard deviation* of a field (the reference's
    VARIANCE, mod_phymbl.f90:1794-1807, returns sqrt of the variance
    despite its name — quirk preserved, name kept for parity)."""
    x = jnp.asarray(x)
    m = jnp.mean(x)
    return jnp.sqrt(jnp.mean((x - m) * (x - m)))


def vmean(x):
    """Arithmetic mean of a field (mod_phymbl.f90:1811-1822)."""
    return jnp.mean(jnp.asarray(x))


def skin_layer_coefs(alpha, ustar_a, Qlat=None):
    """The Qd-independent pieces of :func:`delta_skin_layer` — hoistable
    out of the cool-skin fixed-point loop, which re-solves delta 5x with
    only the absorbed flux changing (mod_skin_{coare,ecmwf}.f90).  The
    hoisted expressions keep the original association order, so the
    hoisted evaluation is bitwise-identical to the inline one."""
    usw = jnp.maximum(ustar_a, 1.0e-4) * c.sq_radrw
    # alpha * rcst_cs / usw^4, written as products of 1/usw: the naive
    # x / (usw2*usw2) form has a transpose that squares 1/usw^4 —
    # (7.3e21)^2 overflows fp32 at the ustar clamp floor, and the
    # clamp's zero cotangent then turns the inf into NaN (inf*0) in the
    # cool-skin BACKWARD pass on the device (XLA CPU factors the same transpose
    # differently, which is why only the chip produced it).  Products of
    # reciprocals keep every backward intermediate in fp32 range; the
    # forward value differs by <=1 ulp (oracle tolerance 1e-12 holds).
    inv_usw = 1.0 / usw
    inv2 = inv_usw * inv_usw
    coef_y = alpha * c.rcst_cs * (inv2 * inv2)
    ztmp = c.rnu0_w * inv_usw
    corr = None
    if Qlat is not None:
        corr = 0.026 * jnp.minimum(Qlat, 0.0) * c.rCp0_w / c.rLevap / alpha
    return coef_y, ztmp, corr


def delta_skin_layer_from_coefs(coefs, Qd):
    """Viscous-layer thickness for one absorbed-flux value, given
    precomputed :func:`skin_layer_coefs`."""
    coef_y, ztmp, corr = coefs
    zQd = Qd if corr is None else Qd + corr
    ztf = step(zQd)
    # 6*(1 + y^(3/4))^(-1/3) with the fractional powers decomposed into
    # sqrt/cbrt chains (mathematically identical, cheaper than generic pow
    # and a shorter serial dependency chain).  The
    # MAX(y,0) clamp is active at every *cooling* point (zQd <= 0, i.e.
    # most of the ocean at night), where sqrt's infinite slope at 0 times
    # the clamp's zero cotangent is NaN — the where-guard keeps the value
    # bitwise-identical (0 both ways) with a finite gradient, like
    # pow23_pos for the gustiness term.
    zy = coef_y * zQd
    pos = zy > 0.0
    zs = jnp.sqrt(jnp.where(pos, zy, 1.0))
    lamb = 6.0 / jnp.cbrt(1.0 + jnp.where(pos, zs * jnp.sqrt(zs), 0.0))
    return (1.0 - ztf) * lamb * ztmp + ztf * jnp.minimum(6.0 * ztmp, 0.007)


def delta_skin_layer(alpha, Qd, ustar_a, Qlat=None):
    """Thickness of the viscous skin layer, Fairall et al. 1996
    (mod_phymbl.f90:2010-2046)."""
    return delta_skin_layer_from_coefs(
        skin_layer_coefs(alpha, ustar_a, Qlat=Qlat), Qd)
