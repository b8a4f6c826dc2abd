"""Fused GPU kernels (Pallas, Triton route) for the hot flux paths."""

from .fused import (fused_bulk_step, fused_flux_step, fused_ice_step,
                    fused_mixed_step, require_gpu, tile_map)

__all__ = ["fused_bulk_step", "fused_flux_step", "fused_ice_step",
           "fused_mixed_step", "require_gpu", "tile_map"]
