"""Universal stability-profile functions psi_m / psi_h (vectorized JAX).

Branch-free re-implementations of the reference's psi families; the
reference already uses the ``0.5 + SIGN(0.5, zeta)`` mask trick everywhere,
which maps 1:1 onto ``jnp.where`` — no control flow survives into XLA.

Families:
  * COARE  (Fairall et al. 2003)           mod_common_coare.f90:217-392
  * NCAR   (Large & Yeager 2004)           mod_blk_ncar.f90:333-419
  * ECMWF  (IFS Cy31r1)                    mod_blk_ecmwf.f90:441-564
  * ANDREAS (Paulson-70 / Grachev-07)      mod_blk_andreas.f90:307-410
  * GRACHEV07 (SHEBA, Jordan-99 unstable)  mod_blk_grachev07.f90:49-127
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from .constants import rpi
from .thermo import step

__all__ = [
    "psi_m_coare", "psi_h_coare", "psi_m_ncar", "psi_h_ncar",
    "psi_m_ecmwf", "psi_h_ecmwf", "psi_m_andreas", "psi_h_andreas",
    "psi_m_grachev07", "psi_h_grachev07", "psi_m_ice", "psi_h_ice",
]


# ---------------------------------------------------------------------------
# COARE (Kansas + convective blend; Beljaars-Holtslag stable)
# ---------------------------------------------------------------------------

_INV_3 = 1.0 / 3.0
_INV_SQRT3 = 1.0 / 1.7320508


def _pos_or_one(a):
    """``a`` where positive, else 1 — grad-safety feed for a
    ``sqrt``/``**frac`` whose argument can land EXACTLY on 0 inside a
    branch the stability mask zeroes out (e.g. ``|1-15z|`` at z=1/15,
    which is a *stable* z, so the unstable phi using it is masked).

    The naive form is forward-correct (0 * finite = 0) but its backward
    is ``inf slope x zero cotangent = NaN``; this bit a real production
    gradient at exactly one 0.25-degree grid point in 1.04e6 (fp32 device
    rounding landed z on the knife; round 5, found by the on-device
    grad-parity gate).  Substituting 1 under the root changes only
    masked-branch values (the mask is exactly 0 there), so every psi
    value is bitwise unchanged for all inputs."""
    return jnp.where(a > 0.0, a, 1.0)


def _ge_one(a):
    """``a`` where >= 1, else 1 — same grad-safety idea for the
    NCAR/Andreas ``MAX(sqrt(|1-16z|), 1)`` clamp: for a < 1 the clamp
    outputs 1 regardless, so feeding sqrt a 1 there keeps the forward
    bitwise while removing sqrt's infinite slope at 0."""
    return jnp.where(a >= 1.0, a, 1.0)


def psi_m_coare(zeta):
    """COARE psi_m (mod_common_coare.f90:217-254).

    Strength reductions (each <=1-2 ulp vs the literal form, gated by
    the 1e-12 oracle tests; the step is compute-bound and divides cost
    several multiplies):
      * ``|1-15z|**0.25`` -> sqrt(sqrt(.));
      * ``/2`` -> ``*0.5`` (exact), ``/3`` and ``/sqrt(3)`` -> constant
        multiplies;
      * ``x/exp(cc)`` -> ``x*exp(-cc)``."""
    phi_m = jnp.sqrt(jnp.sqrt(_pos_or_one(jnp.abs(1.0 - 15.0 * zeta))))
    psi_k = (2.0 * jnp.log((1.0 + phi_m) * 0.5)
             + jnp.log((1.0 + phi_m * phi_m) * 0.5)
             - 2.0 * jnp.arctan(phi_m) + 0.5 * rpi)
    phi_c = _pos_or_one(jnp.abs(1.0 - 10.15 * zeta)) ** 0.3333
    psi_c = (1.5 * jnp.log((1.0 + phi_c + phi_c * phi_c) * _INV_3)
             - 1.7320508 * jnp.arctan((1.0 + 2.0 * phi_c) * _INV_SQRT3)
             + 1.813799447)
    f = zeta * zeta
    f = f / (1.0 + f)
    cc = jnp.minimum(50.0, 0.35 * zeta)
    stb = step(zeta)
    return ((1.0 - stb) * ((1.0 - f) * psi_k + f * psi_c)
            - stb * (1.0 + zeta
                     + 0.6667 * (zeta - 14.28) * jnp.exp(-cc) + 8.525))


def psi_h_coare(zeta):
    """COARE psi_h (mod_common_coare.f90:305-344).

    ``**0.5`` -> sqrt and ``**1.5`` -> x*sqrt(x), plus the same
    constant-divide and 1/exp reductions as :func:`psi_m_coare`
    (ulp-level vs the literal form, gated by the 1e-12 oracle tests)."""
    phi_h = jnp.sqrt(_pos_or_one(jnp.abs(1.0 - 15.0 * zeta)))
    psi_k = 2.0 * jnp.log((1.0 + phi_h) * 0.5)
    phi_c = _pos_or_one(jnp.abs(1.0 - 34.15 * zeta)) ** 0.3333
    psi_c = (1.5 * jnp.log((1.0 + phi_c + phi_c * phi_c) * _INV_3)
             - 1.7320508 * jnp.arctan((1.0 + 2.0 * phi_c) * _INV_SQRT3)
             + 1.813799447)
    f = zeta * zeta
    f = f / (1.0 + f)
    cc = jnp.minimum(50.0, 0.35 * zeta)
    stb = step(zeta)
    x32 = jnp.abs(1.0 + zeta * (2.0 / 3.0))
    x32 = x32 * jnp.sqrt(_pos_or_one(x32))
    return ((1.0 - stb) * ((1.0 - f) * psi_k + f * psi_c)
            - stb * (x32
                     + 0.6667 * (zeta - 14.28) * jnp.exp(-cc) + 8.525))


# ---------------------------------------------------------------------------
# NCAR / Large & Yeager
# ---------------------------------------------------------------------------

def psi_m_ncar(zeta):
    """NCAR psi_m (mod_blk_ncar.f90:333-363)."""
    x2 = jnp.maximum(jnp.sqrt(_ge_one(jnp.abs(1.0 - 16.0 * zeta))), 1.0)
    x = jnp.sqrt(x2)
    psi_unst = (2.0 * jnp.log((1.0 + x) * 0.5)
                + jnp.log((1.0 + x2) * 0.5)
                - 2.0 * jnp.arctan(x) + rpi * 0.5)
    psi_stab = -5.0 * zeta
    stb = step(zeta)
    return stb * psi_stab + (1.0 - stb) * psi_unst


def psi_h_ncar(zeta):
    """NCAR psi_h (mod_blk_ncar.f90:379-407)."""
    x2 = jnp.maximum(jnp.sqrt(_ge_one(jnp.abs(1.0 - 16.0 * zeta))), 1.0)
    psi_unst = 2.0 * jnp.log(0.5 * (1.0 + x2))
    psi_stab = -5.0 * zeta
    stb = step(zeta)
    return stb * psi_stab + (1.0 - stb) * psi_unst


# ---------------------------------------------------------------------------
# ECMWF / IFS
# ---------------------------------------------------------------------------

def _cap_zeta_ecmwf(zeta):
    """Clamp zeta into [-50, 5] (mod_blk_ecmwf.f90:551-564)."""
    return jnp.minimum(jnp.maximum(zeta, -50.0), 5.0)


def psi_m_ecmwf(zeta):
    """ECMWF psi_m: Paulson-70 unstable + IFS stable (mod_blk_ecmwf.f90:441-477)."""
    zc = 5.0 / 0.35
    zta = _cap_zeta_ecmwf(zeta)
    x2 = jnp.sqrt(_pos_or_one(jnp.abs(1.0 - 16.0 * zta)))
    x = jnp.sqrt(x2)
    t = 1.0 + x
    psi_unst = (jnp.log(0.125 * t * t * (1.0 + x2))
                - 2.0 * jnp.arctan(x) + 0.5 * rpi)
    psi_stab = (-2.0 / 3.0 * (zta - zc) * jnp.exp(-0.35 * zta)
                - zta - 2.0 / 3.0 * zc)
    stb = step(zta)
    return stb * psi_stab + (1.0 - stb) * psi_unst


def psi_h_ecmwf(zeta):
    """ECMWF psi_h (mod_blk_ecmwf.f90:498-533).

    ``**1.5`` -> x*sqrt(x) (ulp-level vs generic pow, 1e-12
    oracle-gated)."""
    zc = 5.0 / 0.35
    zta = _cap_zeta_ecmwf(zeta)
    x2 = jnp.sqrt(_pos_or_one(jnp.abs(1.0 - 16.0 * zta)))
    psi_unst = 2.0 * jnp.log(0.5 * (1.0 + x2))
    x32 = jnp.abs(1.0 + 2.0 / 3.0 * zta)
    x32 = x32 * jnp.sqrt(_pos_or_one(x32))
    psi_stab = (-2.0 / 3.0 * (zta - zc) * jnp.exp(-0.35 * zta)
                - x32 - 2.0 / 3.0 * zc + 1.0)
    stb = step(zta)
    return stb * psi_stab + (1.0 - stb) * psi_unst


# ---------------------------------------------------------------------------
# ANDREAS (Paulson-70 unstable; Grachev-07 SHEBA stable)
# ---------------------------------------------------------------------------

def psi_m_andreas(zeta):
    """Andreas psi_m (mod_blk_andreas.f90:307-360)."""
    am = 5.0
    bm = am / 6.5
    one_third = 1.0 / 3.0
    sr3 = math.sqrt(3.0)
    zta = jnp.minimum(zeta, 15.0)
    x2 = jnp.maximum(jnp.sqrt(_ge_one(jnp.abs(1.0 - 16.0 * zta))), 1.0)
    x = jnp.sqrt(x2)
    psi_unst = (2.0 * jnp.log(jnp.abs((1.0 + x) * 0.5))
                + jnp.log(jnp.abs((1.0 + x2) * 0.5))
                - 2.0 * jnp.arctan(x) + rpi * 0.5)
    xs = _pos_or_one(jnp.abs(1.0 + zta)) ** one_third
    bbm = abs((1.0 - bm) / bm) ** one_third  # scalar B_m
    psi_stab = (-3.0 * am / bm * (xs - 1.0) + am * bbm / (2.0 * bm) * (
        2.0 * jnp.log(jnp.abs((xs + bbm) / (1.0 + bbm)))
        - jnp.log(jnp.abs((xs * xs - xs * bbm + bbm * bbm)
                          / (1.0 - bbm + bbm * bbm)))
        + 2.0 * sr3 * (jnp.arctan((2.0 * xs - bbm) / (sr3 * bbm))
                       - math.atan((2.0 - bbm) / (sr3 * bbm)))))
    stb = step(zta)
    return stb * psi_stab + (1.0 - stb) * psi_unst


def psi_h_andreas(zeta):
    """Andreas psi_h (mod_blk_andreas.f90:363-410)."""
    ah = 5.0
    bh = 5.0
    ch = 3.0
    bbh = math.sqrt(5.0)
    zta = jnp.minimum(zeta, 15.0)
    x2 = jnp.maximum(jnp.sqrt(_ge_one(jnp.abs(1.0 - 16.0 * zta))), 1.0)
    psi_unst = 2.0 * jnp.log(0.5 * (1.0 + x2))
    zz = 2.0 * zta + ch
    # the stable-branch log arguments hit EXACT zeros at the fp32
    # unstable-branch (masked) zetas (-3±sqrt(5))/2 ≈ -0.382 / -2.618:
    # |1+3z+z^2| -> 0 and (zz∓sqrt5) -> 0, so the naive form is
    # 0 * (-inf) = NaN in the FORWARD pass, not just the backward
    # (round-5 review finding; for z >= 0 the arguments are >= 1 and
    # > 0.15 respectively, so the guards only touch masked points)
    psi_stab = (-0.5 * bh * jnp.log(_pos_or_one(
                    jnp.abs(1.0 + ch * zta + zta * zta)))
                + (-ah / bbh + 0.5 * bh * ch / bbh)
                * (jnp.log(_pos_or_one(jnp.abs((zz - bbh) / (zz + bbh))))
                   - math.log(abs((ch - bbh) / (ch + bbh)))))
    stb = step(zta)
    return stb * psi_stab + (1.0 - stb) * psi_unst


# ---------------------------------------------------------------------------
# GRACHEV07 (SHEBA over sea ice; Jordan-99 unstable)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# ICE: Jordan et al. 1999 (Paulson-70 unstable, Holtslag & De Bruin stable)
# shared by the AN05 / EASY / BEST ice algorithms
# (mod_blk_ice_an05.f90:316-406, identical copies in easy/best modules)
# ---------------------------------------------------------------------------

def _psi_s_holtslag(zeta):
    """Holtslag & De Bruin 1988 stable branch, Jordan-99 Eq. 33."""
    return -(0.7 * zeta + 0.75 * (zeta - 14.3) * jnp.exp(-0.35 * zeta) + 10.7)


def psi_m_ice(zeta):
    """Ice psi_m: Jordan-99 Eq. 30 unstable / Eq. 33 stable
    (mod_blk_ice_an05.f90:316-360)."""
    x = _pos_or_one(jnp.abs(1.0 - 16.0 * zeta)) ** 0.25
    psi_u = (jnp.log((1.0 + x * x) / 2.0) + 2.0 * jnp.log((1.0 + x) / 2.0)
             - 2.0 * jnp.arctan(x) + 0.5 * rpi)
    stb = step(zeta)
    return (1.0 - stb) * psi_u + stb * _psi_s_holtslag(zeta)


def psi_h_ice(zeta):
    """Ice psi_h: Jordan-99 Eq. 31 unstable / Eq. 33 stable
    (mod_blk_ice_an05.f90:363-406)."""
    x = _pos_or_one(jnp.abs(1.0 - 16.0 * zeta)) ** 0.25
    psi_u = 2.0 * jnp.log((1.0 + x * x) / 2.0)
    stb = step(zeta)
    return (1.0 - stb) * psi_u + stb * _psi_s_holtslag(zeta)


def psi_m_grachev07(zeta):
    """Grachev-07 psi_m (mod_blk_grachev07.f90:49-70)."""
    x = _pos_or_one(jnp.abs(1.0 - 16.0 * zeta)) ** 0.25
    psi_u = (jnp.log(0.5 * (1.0 + x * x)) + 2.0 * jnp.log(0.5 * (1.0 + x))
             - 2.0 * jnp.arctan(x) + 0.5 * rpi)
    psi_s = (1.0 + 6.5 * zeta * _pos_or_one(1.0 + zeta) ** 0.3333333
             / jnp.where(zeta < 0.0, 1.0, 1.3 + zeta))
    return jnp.where(zeta < 0.0, psi_u, -psi_s)


def psi_h_grachev07(zeta):
    """Grachev-07 psi_h (mod_blk_grachev07.f90:91-113)."""
    x = _pos_or_one(jnp.abs(1.0 - 16.0 * zeta)) ** 0.25
    psi_u = 2.0 * jnp.log(0.5 * (1.0 + x * x))
    psi_s = 1.0 + 5.0 * zeta * (1.0 + zeta) / (1.0 + 3.0 * zeta + zeta * zeta)
    return jnp.where(zeta < 0.0, psi_u, -psi_s)
