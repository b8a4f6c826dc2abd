"""aerobulk_tpu — air-sea turbulent-flux framework for GPUs (JAX/XLA/Pallas).

A ground-up JAX/XLA re-design of the capabilities of AeroBulk
(github.com/brodeau/aerobulk): bulk aerodynamic computation of wind stress,
evaporation / latent heat and sensible heat over ocean and sea ice, with
five ocean bulk-transfer parameterizations (COARE 3.0, COARE 3.6,
ECMWF/IFS, NCAR/Large&Yeager, ANDREAS), cool-skin / warm-layer skin
temperature schemes, a sea-ice algorithm family, and a thermodynamics
function library — all as pure, jit-able, shardable functions.

Quick start::

    from aerobulk_tpu import flux
    out = flux("coare3p6", zt=2., zu=10., sst=sst, t_zt=t2m, hum_zt=q2m,
               U_zu=u10, V_zu=v10, slp=slp, rad_sw=ssrd, rad_lw=strd,
               use_skin=True)
"""

from . import constants, thermo, stability, closures, skin
from .algos import (FluxResult, OCEAN_ALGOS, turb_andreas, turb_coare3p0,
                    turb_coare3p6, turb_ecmwf, turb_ncar)
from .algos.neutral_10m import turb_neutral_10m
from .api import (AeroBulkConfig, FluxOutput, aerobulk_model,
                  check_flux_sanity, flux, flux_sanity_count, flux_step,
                  flux_step_ice, flux_step_ice_linearized,
                  flux_step_linearized, flux_step_mixed,
                  init, init_skin_state, run_series)
from .skin import SkinState

__version__ = "0.1.0"

__all__ = [
    "AeroBulkConfig", "FluxOutput", "FluxResult", "OCEAN_ALGOS", "SkinState",
    "aerobulk_model", "check_flux_sanity",
    "closures", "constants", "flux", "flux_sanity_count", "flux_step",
    "flux_step_ice", "flux_step_ice_linearized", "flux_step_linearized",
    "flux_step_mixed", "init", "init_skin_state", "run_series",
    "skin", "stability", "thermo", "turb_andreas", "turb_coare3p0",
    "turb_coare3p6", "turb_ecmwf", "turb_ncar", "turb_neutral_10m",
]
