"""Fused flux-step kernels for the GPU (Pallas, Triton route).

The reference's hot loop is ``for point: for jit in 1..nb_iter: ~100
transcendental-heavy flops`` with zero inter-point dependence (SURVEY.md
§3).  :func:`tile_map` runs such a pointwise body over 1-D tiles of the
flattened grid: one block of threads reads its slice of every input
field once, runs the whole solve in registers, and writes every output
once.  Every kernel below is one body handed to that wrapper.

Because every piece of the algorithm library is pure elementwise jnp, a
kernel body simply *calls the same functions* as the jit path — the jnp
implementation is the correctness oracle and the kernel cannot drift
from it.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..api import AeroBulkConfig, flux_step
from ..skin import SkinState

#: Tile length (points per Triton program) and warps per program: one
#: point per thread.  Chosen by a sweep on an H100 (PERF.md, "Kernel
#: decisions"); wider tiles hold more live values per thread and spill.
BLOCK = 128
NUM_WARPS = 4


def require_gpu(what: str, interpret: bool = False):
    """Raise unless compiled kernels can run here (a GPU backend), or the
    caller asked for the Pallas interpreter explicitly."""
    if interpret:
        return
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"{what}: the fused kernels are compiled for the GPU, but JAX's "
            f"default platform is {platform!r}.  Use the jit path "
            "(backend='jit'), which runs on every platform, or pass "
            "interpret=True to run the kernel in the Pallas interpreter.")


def tile_map(body, fields, scalars=(), *, n_out: int, block: int = BLOCK,
             num_warps: int = NUM_WARPS, interpret: bool = False,
             name: str = "tile_map"):
    """Apply the pointwise ``body`` over same-shaped ``fields`` in 1-D
    tiles through Pallas on the Triton route.

    ``body(*field_tiles, *scalars)`` returns ``n_out`` arrays shaped like a
    field tile.  ``scalars`` are 0-d values shared by every point (e.g. the
    UTC clock).  Fields are flattened (a free reshape of a row-major
    array), cut into ``block``-point tiles (a power of two, as Triton
    requires), and the ragged tail is masked on load and store, so no
    input is padded or copied.  Returns ``n_out`` arrays of the fields'
    shape and dtype.
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    if block <= 0 or block & (block - 1):
        raise ValueError(f"tile_map: block must be a power of two, "
                         f"got {block}")
    shape = fields[0].shape
    dtype = fields[0].dtype
    n = int(np.prod(shape))
    nf, ns = len(fields), len(scalars)

    def kernel(*refs):
        idx = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
        mask = idx < n
        xs = [plgpu.load(r.at[idx], mask=mask) for r in refs[:nf]]
        ss = [r[0] for r in refs[nf:nf + ns]]
        outs = body(*xs, *ss)
        for r, o in zip(refs[nf + ns:], outs):
            plgpu.store(r.at[idx], o.astype(dtype), mask=mask)

    flat = [jnp.reshape(x, (n,)) for x in fields]
    svec = [jnp.reshape(jnp.asarray(s, dtype), (1,)) for s in scalars]
    outs = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((n,), dtype)] * n_out,
        grid=(pl.cdiv(n, block),),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name=name,
    )(*flat, *svec)
    return tuple(jnp.reshape(o, shape) for o in outs)


# ---------------------------------------------------------------------------
# COARE/ECMWF skin forward step
# ---------------------------------------------------------------------------

def _skin_body(cfg, sst, t, q, u, v, slp, rsw, rlw, lon,
               dT_wl, Hz_wl, Qnt_ac, Tau_ac, isd):
    out, ns = flux_step(
        cfg, sst, t, q, u, v, slp, rad_sw=rsw, rad_lw=rlw,
        isecday_utc=isd, lon=lon,
        skin_state=SkinState(dT_wl=dT_wl, Hz_wl=Hz_wl, Qnt_ac=Qnt_ac,
                             Tau_ac=Tau_ac))
    return (out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap, out.T_s, *ns)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _fused(cfg: AeroBulkConfig, interpret, args, isd, state):
    outs = tile_map(functools.partial(_skin_body, cfg), (*args, *state),
                    (isd,), n_out=10, interpret=interpret,
                    name="fused_skin_step")
    return tuple(outs[:6]), SkinState(*outs[6:])


def fused_flux_step(cfg: AeroBulkConfig, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                    rad_sw, rad_lw, lon=None, isecday_utc=43200,
                    skin_state: Optional[SkinState] = None,
                    interpret: bool = False):
    """Run one skin-enabled flux step as a single fused GPU kernel.

    Inputs share one shape (any rank; the kernel tiles the flattened
    grid).  Returns ``((QL, QH, Tau_x, Tau_y, Evap, T_s), SkinState)``.
    Compiled for the GPU; ``interpret=True`` runs the same kernel in the
    Pallas interpreter on any platform (exact jnp semantics, slow — the
    CPU tests' mode).  Any other platform raises: use ``api.flux_step``.

    Numerics: identical math to ``api.flux_step``; fp32 rounding differs
    from the XLA path by op ordering and fma contraction, so individual
    points near branch thresholds can diverge (root-caused in
    docs/PARITY.md "The fp32 tail").

    Differentiable through a custom VJP whose backward pass is AD of the
    jit path (see :func:`_fused_step_ad`).
    """
    from ..api import init_skin_state

    require_gpu("fused_flux_step", interpret)
    if lon is None:
        lon = jnp.zeros_like(sst)
    if skin_state is None:
        skin_state = init_skin_state(cfg, sst.shape, sst.dtype)
    return _fused_step_ad(
        (cfg, bool(interpret)),
        (sst, t_zt, hum_zt, U_zu, V_zu, slp, rad_sw, rad_lw, lon,
         isecday_utc, skin_state))


def _fused_step_primal(statics, diff_args):
    cfg, interpret = statics
    (sst, t_zt, hum_zt, U_zu, V_zu, slp, rad_sw, rad_lw, lon,
     isecday_utc, skin_state) = diff_args
    return _fused(cfg, interpret,
                  (sst, t_zt, hum_zt, U_zu, V_zu, slp, rad_sw, rad_lw, lon),
                  jnp.asarray(isecday_utc, sst.dtype), skin_state)


def _jit_equiv(cfg, diff_args):
    """The XLA-path computation with the fused kernel's exact output
    structure — the semantics reference used as the kernel's VJP."""
    (sst, t_zt, hum_zt, U_zu, V_zu, slp, rad_sw, rad_lw, lon,
     isecday_utc, skin_state) = diff_args
    out, new_state = flux_step(cfg, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                               rad_sw=rad_sw, rad_lw=rad_lw,
                               isecday_utc=isecday_utc, lon=lon,
                               skin_state=skin_state)
    return ((out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap, out.T_s),
            new_state)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _fused_step_ad(statics, diff_args):
    """Differentiable fused step: a Pallas kernel has no autodiff rule,
    so the kernel gets a custom VJP whose backward pass differentiates the
    jit path (``api.flux_step``) — the same math the kernel body runs, so
    primal and cotangents are consistent up to the documented fp32
    kernel/XLA rounding difference (docs/PARITY.md); on CPU fp64
    (interpret mode) they agree to 1e-9 (tests/test_grad.py).  This makes
    ``run_series(backend="fused")`` and ``sharded_fused_flux_step``
    differentiable end to end."""
    return _fused_step_primal(statics, diff_args)


def _fused_step_fwd(statics, diff_args):
    return _fused_step_primal(statics, diff_args), diff_args


def _fused_step_bwd(statics, diff_args, cotangents):
    _, vjp = jax.vjp(functools.partial(_jit_equiv, statics[0]), diff_args)
    return vjp(cotangents)


_fused_step_ad.defvjp(_fused_step_fwd, _fused_step_bwd)


# ---------------------------------------------------------------------------
# stateless bodies (bulk-SST ocean, ice, mixed cells)
# ---------------------------------------------------------------------------

def _bulk_body(cfg, sst, t, q, u, v, slp):
    out, _ = flux_step(cfg, sst, t, q, u, v, slp)
    return out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap, out.T_s


def fused_bulk_step(cfg: AeroBulkConfig, sst, t_zt, hum_zt, U_zu, V_zu,
                    slp, interpret: bool = False):
    """Stateless (bulk-SST, no skin scheme) flux solve as one fused GPU
    kernel over inputs of any (broadcastable) shape.  Returns
    ``(QL, QH, Tau_x, Tau_y, Evap, T_s)``."""
    if cfg.use_skin:
        raise ValueError("fused_bulk_step: stateless kernel requires a "
                         "use_skin=False config (use fused_flux_step)")
    require_gpu("fused_bulk_step", interpret)
    fields = (sst, t_zt, hum_zt, U_zu, V_zu, slp)
    dtype = jnp.result_type(*fields)
    fields = jnp.broadcast_arrays(*(jnp.asarray(x, dtype) for x in fields))
    return tile_map(functools.partial(_bulk_body, cfg), fields, n_out=6,
                    interpret=interpret, name="fused_bulk_step")


def _ice_body(zt, zu, ice_algo, niter, humidity, algo_kw,
              Ts_i, t, q, u, v, slp, frice=None):
    from ..api import flux_step_ice
    out, _ = flux_step_ice(ice_algo, zt, zu, Ts_i, t, q, u, v, slp,
                           frice=frice, niter=niter, humidity=humidity,
                           **dict(algo_kw))
    return out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap, out.T_s


def fused_ice_step(ice_algo, zt, zu, Ts_i, t_zt, hum_zt, U_zu, V_zu, slp,
                   frice=None, niter=5, humidity="sh",
                   interpret: bool = False, **algo_kw):
    """Ice-only flux step (``flux_step_ice``) as one fused GPU kernel.
    Scalar ``algo_kw`` are baked in as compile-time statics.  Returns
    ``(QL, QH, Tau_x, Tau_y, Evap, T_s)``."""
    require_gpu("fused_ice_step", interpret)
    fields = (Ts_i, t_zt, hum_zt, U_zu, V_zu, slp)
    if frice is not None:
        fields += (frice,)
    body = functools.partial(_ice_body, float(zt), float(zu), ice_algo,
                             int(niter), humidity,
                             tuple(sorted(algo_kw.items())))
    return tile_map(body, fields, n_out=6, interpret=interpret,
                    name="fused_ice_step")


def _mixed_body(zt, zu, ice_algo, ocean_algo, niter, humidity, simultaneous,
                Ts_i, sst, t, q, u, v, slp, frice):
    from ..api import flux_step_mixed
    net, _, _ = flux_step_mixed(
        zt, zu, Ts_i, sst, t, q, u, v, slp, frice, ice_algo=ice_algo,
        ocean_algo=ocean_algo, niter=niter, humidity=humidity,
        simultaneous=simultaneous)
    return net.QL, net.QH, net.Tau, net.Evap, net.T_s


def fused_mixed_step(zt, zu, Ts_i, sst, t_zt, hum_zt, U_zu, V_zu, slp,
                     frice, ice_algo="ice_lg15", ocean_algo="ecmwf",
                     niter=5, humidity="sh", simultaneous=False,
                     interpret: bool = False):
    """Mixed ocean+ice cell (``flux_step_mixed``) as one fused GPU
    kernel.  Returns ``(QL, QH, Tau, Evap, T_s)`` of the area-weighted
    net fluxes."""
    require_gpu("fused_mixed_step", interpret)
    body = functools.partial(_mixed_body, float(zt), float(zu), ice_algo,
                             ocean_algo, int(niter), humidity,
                             bool(simultaneous))
    return tile_map(body, (Ts_i, sst, t_zt, hum_zt, U_zu, V_zu, slp, frice),
                    n_out=5, interpret=interpret, name="fused_mixed_step")
