"""Host -> device input pipeline: overlapped streaming of time records.

The reference processes the time axis strictly sequentially because of the
warm-layer state (SURVEY.md §5); the input files live on the host — its
flagship workload is an IO-fed stateful time loop
(test_aerobulk_buoy_series_oce.f90:364-537).  Here the host feed overlaps
three streams:

  * H2D: a producer thread issues ``jax.device_put`` for record (or chunk)
    t+1 while record t computes;
  * compute: JAX dispatch is async, so the step for record t+1 is enqueued
    before record t's outputs are read back;
  * D2H: collected outputs start their device->host copy asynchronously
    (``copy_to_host_async``) at dispatch time and are only *synced* after
    ``inflight`` further records have been dispatched — the host never
    blocks the device on a read-back of the record it just computed.

Two granularities:

  * per-record (default): one jitted ``flux_step`` dispatch per record —
    simple, works for any config, but each record pays the fixed dispatch
    cost;
  * chunked (``chunk=K``): K records are stacked on the host, shipped as
    one transfer, and scanned on device (``run_series``, optionally the
    fused GPU kernel) — the dispatch/transfer overhead amortizes over
    K * npoints, which is the production shape for big grids.
"""

from __future__ import annotations

import collections
import functools
import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional

import jax
import numpy as np

__all__ = ["prefetch_to_device", "run_series_pipelined"]


def _prefetch_map(fn, items, buffer_size: int = 2):
    """Apply ``fn`` to each item on a daemon thread, keeping up to
    ``buffer_size`` results in flight; exceptions re-raise at the
    consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    _END = object()
    err = []
    stop = threading.Event()   # set when the consumer abandons the stream

    def put(item):
        # bounded put that gives up if the consumer is gone — otherwise a
        # consumer-side exception would leave this thread blocked forever
        # holding buffer_size device-sized buffers
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for it in items:
                if not put(fn(it)):
                    return
        except BaseException as e:   # re-raised on the consumer side
            err.append(e)
        finally:
            put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    drained = False   # saw _END: the producer finished (ok or with error)
    try:
        while True:
            item = q.get()
            if item is _END:
                drained = True
                break
            yield item
    finally:
        stop.set()
        if err and not drained:
            # the consumer abandoned the stream (its own exception or an
            # early break) while the producer ALSO failed — the normal
            # re-raise below never runs, so surface the producer failure
            # instead of silently dropping it at generator close
            import logging
            logging.getLogger(__name__).warning(
                "prefetch producer failed while the consumer abandoned "
                "the stream early: %r", err[0])
    if err:
        raise err[0]


def _grid_put(sharding):
    """device_put mapper: grid-shaped fields get the grid sharding,
    scalars/vectors (e.g. isecday_utc) are replicated over its mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(x):
        if sharding is None:
            return jax.device_put(x)
        if np.ndim(x) >= len(sharding.spec):
            return jax.device_put(x, sharding)
        return jax.device_put(x, NamedSharding(sharding.mesh, P()))
    return put


def prefetch_to_device(records: Iterable[Dict[str, np.ndarray]],
                       buffer_size: int = 2,
                       sharding=None) -> Iterator[dict]:
    """Iterate over forcing records with asynchronous device placement.

    ``records`` yields dicts of host numpy arrays (one time record each).
    A daemon thread keeps up to ``buffer_size`` records in flight:
    ``jax.device_put`` is issued ahead of consumption so the H2D copy of
    record t+1 overlaps the compute of record t.  With ``sharding`` the
    transfer lands directly in the sharded layout (multi-chip feed).
    """
    # a sharding over a single device buys nothing and (on some remote
    # backends) sends compilation through a much slower SPMD path
    if sharding is not None and len(sharding.device_set) <= 1:
        sharding = None
    put = _grid_put(sharding)
    return _prefetch_map(
        lambda rec: {k: put(v) for k, v in rec.items()}, records,
        buffer_size)


def _stack_chunk(batch, isecday_key):
    """Stack a list of per-record dicts into one (k, ...) chunk dict."""
    out = {k: np.stack([np.asarray(r[k]) for r in batch])
           for k in batch[0] if k != isecday_key}
    if isecday_key in batch[0]:
        out[isecday_key] = np.asarray([r[isecday_key] for r in batch],
                                      np.int32)
    return out


def _chunk_records(records, chunk, isecday_key):
    batch = []
    for rec in records:
        batch.append(rec)
        if len(batch) == chunk:
            yield _stack_chunk(batch, isecday_key)
            batch = []
    if batch:
        yield _stack_chunk(batch, isecday_key)


_I16_FILL = -32768   # sentinel for non-finite points (NetCDF _FillValue)


def _pack_i16(v):
    """Scale-offset int16 packing of one field (the NetCDF/GRIB
    convention): 2 bytes/value on the wire, reconstructed on device as
    q * scale + offset.  Quantization error <= (max-min)/131068 — e.g.
    0.12 mK for a 15 K SST range, far below fp32 flux sensitivity.

    Non-finite points (land-mask fill NaNs) are carried through as the
    _FillValue sentinel and reconstructed as NaN — and are excluded from
    the min/max so one masked point cannot poison the field's scale."""
    v = np.asarray(v, np.float32)
    finite = np.isfinite(v)
    if finite.all():
        vmin, vmax = float(v.min()), float(v.max())
    elif finite.any():
        vmin = float(v[finite].min())
        vmax = float(v[finite].max())
    else:
        vmin = vmax = 0.0
    scale = max((vmax - vmin) / 65534.0, 1e-30)
    with np.errstate(invalid="ignore"):
        q = (np.round((v - vmin) / scale) - 32767.0)
    q = np.where(finite, q, float(_I16_FILL)).astype(np.int16)
    offset = np.float32(vmin + 32767.0 * scale)
    return q, np.asarray([scale, offset], np.float32)


_I8_FILL = -128    # sentinel for non-finite points in delta records


def _pack_i8_delta(v):
    """Delta-encode one stacked (k, ...) field: record 0 as absolute
    int16 (:func:`_pack_i16`), records 1..k-1 as int8 deltas against the
    RECONSTRUCTED previous record (so quantization error does not chain —
    each record's error is bounded by its own delta span / 253, plus the
    base record's i16 error).

    Wire cost: (2 + (k-1)) / k bytes per value vs 2 for plain i16 —
    ~44% fewer H2D bytes at chunk=8.  The premise is geophysical forcing
    smoothness: consecutive hourly records differ by a small fraction of
    the field's absolute span, so the delta span (hence the int8 step)
    is small.  For a field that jumps a large fraction of its span
    between records (a storm front crossing the whole grid) the int8
    step degrades toward span/253 for that record — the end-to-end
    error is measured and gated by the streamed bench check.

    Returns ``(q0 int16, dq (k-1, ...) int8, meta (2k,) float32)`` with
    meta = [s0, o0, s1, o1, ...] (scale/offset per record)."""
    v = np.asarray(v, np.float32)
    q0, so0 = _pack_i16(v[0])
    metas = [so0]
    R = np.where(q0 == _I16_FILL, np.float32(np.nan),
                 q0.astype(np.float32) * so0[0] + so0[1]).astype(np.float32)
    dqs = []
    for j in range(1, v.shape[0]):
        d = v[j] - R
        finite = np.isfinite(d)
        if finite.all():
            dmin, dmax = float(d.min()), float(d.max())
        elif finite.any():
            dmin = float(d[finite].min())
            dmax = float(d[finite].max())
        else:
            dmin = dmax = 0.0
        scale = max((dmax - dmin) / 253.0, 1e-30)
        with np.errstate(invalid="ignore"):
            q = np.round((d - dmin) / scale) - 126.0
        q = np.where(finite, q, float(_I8_FILL)).astype(np.int8)
        offset = np.float32(dmin + 126.0 * scale)
        metas.append(np.asarray([scale, offset], np.float32))
        delta_rec = np.where(q == _I8_FILL, np.float32(np.nan),
                             q.astype(np.float32) * np.float32(scale)
                             + offset)
        R = (R + delta_rec).astype(np.float32)
        dqs.append(q)
    dq = (np.stack(dqs) if dqs
          else np.zeros((0,) + v.shape[1:], np.int8))
    return q0, dq, np.concatenate(metas).astype(np.float32)


def _recon_wire(fc, meta, wire):
    """Device-side reconstruction of a packed chunk (runs under jit,
    before the shard_map for the sharded path — purely elementwise)."""
    import jax.numpy as jnp

    if wire == "i16":
        return {k: jnp.where(v == _I16_FILL, jnp.nan,
                             v.astype(jnp.float32) * meta[k][0]
                             + meta[k][1])
                for k, v in fc.items()}

    # i8d: base record + cumulative-summed delta records
    def recon(d, so):
        so = so.reshape(-1, 2)
        q0, dq = d["base"], d["dq"]
        R0 = jnp.where(q0 == _I16_FILL, jnp.nan,
                       q0.astype(jnp.float32) * so[0, 0] + so[0, 1])
        if dq.shape[0] == 0:
            return R0[None]
        bshape = (-1,) + (1,) * R0.ndim
        s = so[1:, 0].reshape(bshape)
        o = so[1:, 1].reshape(bshape)
        deltas = jnp.where(dq == _I8_FILL, jnp.nan,
                           dq.astype(jnp.float32) * s + o)
        return jnp.concatenate(
            [R0[None], R0[None] + jnp.cumsum(deltas, 0)], 0)

    return {k: recon(v, meta[k]) for k, v in fc.items()}


def _default_collect(out):
    """Keep the flux headline fields; tolerate the fused backend's reduced
    output set (Tau=None)."""
    import jax.numpy as jnp
    tau = out.Tau if out.Tau is not None else jnp.hypot(out.Tau_x,
                                                        out.Tau_y)
    return {"QL": out.QL, "QH": out.QH, "Tau": tau, "Evap": out.Evap}


@functools.lru_cache(maxsize=1)
def _device_pack_i16_fn():
    """One jitted tree-packer for collected outputs: every float leaf
    becomes (int16 quantized, fp32 [scale, offset]) — the D2H mirror of
    :func:`_pack_i16`, computed on device in a single dispatch."""
    import jax.numpy as jnp

    def pack_leaf(x):
        if not jnp.issubdtype(x.dtype, jnp.floating):
            return x
        finite = jnp.isfinite(x)
        safe = jnp.where(finite, x, 0.0)
        has = jnp.any(finite)
        vmin = jnp.where(has, jnp.min(jnp.where(finite, x, jnp.inf)), 0.0)
        vmax = jnp.where(has, jnp.max(jnp.where(finite, x, -jnp.inf)), 0.0)
        scale = jnp.maximum((vmax - vmin) / 65534.0, 1e-30)
        q = jnp.where(finite,
                      jnp.round((safe - vmin) / scale) - 32767.0,
                      float(_I16_FILL)).astype(jnp.int16)
        so = jnp.stack([scale, vmin + 32767.0 * scale]).astype(jnp.float32)
        return {"_i16q": q, "_i16so": so}

    return jax.jit(lambda tree: jax.tree_util.tree_map(pack_leaf, tree))


def _unpack_i16_host(tree):
    """Reconstruct fp32 numpy fields from materialized packed leaves."""
    if isinstance(tree, dict):
        if set(tree) == {"_i16q", "_i16so"}:
            q = np.asarray(tree["_i16q"])
            scale, offset = np.asarray(tree["_i16so"], np.float64)
            x = q.astype(np.float32) * np.float32(scale) \
                + np.float32(offset)
            return np.where(q == _I16_FILL, np.float32(np.nan), x)
        return {k: _unpack_i16_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unpack_i16_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unpack_i16_host(v) for v in tree)
    return tree


class _InflightCollector:
    """Deferred, overlapped output collection.

    ``push(out)`` applies ``collect`` (a *selection*: it may return jax
    arrays), starts the async D2H copy of every selected leaf, and only
    materializes (``np.asarray``) a pushed selection once ``inflight``
    newer ones exist — so the device is never idled by a blocking
    read-back of the record it just produced (VERDICT r3 item 1a).
    """

    def __init__(self, collect: Optional[Callable], inflight: int,
                 wire: str = "f32"):
        self.collect = _default_collect if collect is None else collect
        self.inflight = max(0, int(inflight))
        self.wire = wire
        self.pending: "collections.deque" = collections.deque()
        self.results = []

    def _materialize(self, sel):
        sel = jax.tree_util.tree_map(np.asarray, sel)
        if self.wire == "i16":
            sel = _unpack_i16_host(sel)
        return sel

    def push(self, out):
        sel = self.collect(out)
        if self.wire == "i16":
            # one extra device dispatch quantizes the whole selection to
            # int16 before the async D2H copy — half the read-back bytes
            sel = _device_pack_i16_fn()(sel)
        for leaf in jax.tree_util.tree_leaves(sel):
            if isinstance(leaf, jax.Array):
                leaf.copy_to_host_async()
        self.pending.append(sel)
        while len(self.pending) > self.inflight:
            self.results.append(self._materialize(self.pending.popleft()))

    def drain(self):
        while self.pending:
            self.results.append(self._materialize(self.pending.popleft()))
        return self.results


@functools.lru_cache(maxsize=64)
def _make_chunk_step(cfg, backend, fused_interpret, wire="f32"):
    """Jitted chunk scan, cached per static config so repeated
    run_series_pipelined calls re-use the trace/compile (the step
    functions must not be rebuilt per call — a fresh jit wrapper forgets
    its cache)."""
    from .api import run_series

    @jax.jit
    def chunk_step(fc, meta, isd, lon, st):
        if meta is not None:     # packed wire: reconstruct on device
            fc = _recon_wire(fc, meta, wire)
        return run_series(cfg, fc, skin_state=st, isecday_utc=isd,
                          lon=lon, backend=backend,
                          fused_interpret=fused_interpret)
    return chunk_step


def _shard_multiple(mesh, axis):
    """Number of shards a PartitionSpec entry cuts an axis into."""
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _mesh_pad_widths(sharding, grid_shape):
    """Per-axis padding rounding ``grid_shape`` up to shard multiples.

    ``NamedSharding`` cannot lay out uneven global dims via device_put
    (sharding.py:_mesh_padding) — the real 0.25-degree grid is 721x1440
    and 721 = 7*103, so the streamed sharded feed edge-pads each chunk on
    the prefetch thread before the transfer.  Spec entries align to the
    LEADING grid axes (PartitionSpec semantics); missing trailing entries
    mean replicated."""
    spec = tuple(sharding.spec)
    spec = spec + (None,) * (len(grid_shape) - len(spec))
    return tuple((-s) % _shard_multiple(sharding.mesh, ax)
                 for s, ax in zip(grid_shape, spec))


@functools.lru_cache(maxsize=64)
def _make_sharded_chunk_step(cfg, backend, fused_interpret, mesh, spec,
                             grid_shape, wire="f32"):
    """Jitted chunk scan over a device mesh: the whole chunk is scanned
    *device-local* inside one ``shard_map`` (the warm-layer state carries
    across records entirely on-chip, zero collectives per step) — the
    streamed analogue of :func:`aerobulk_tpu.sharding.sharded_run_series`
    and the multi-chip form of the reference's IO-fed stateful time loop
    (test_aerobulk_buoy_series_oce.f90:364-537 on a decomposed domain).

    Inputs arrive already edge-padded to shard multiples (see
    :func:`_mesh_pad_widths`); outputs are sliced back to ``grid_shape``
    before collection so ``collect`` reductions never see padded lanes.
    The (padded) state stays sharded and device-resident between chunks.
    """
    from functools import partial

    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from .api import run_series

    fspec = P(None, *spec)    # (k, ...grid): time axis replicated
    gspec = P(*spec)          # grid fields / state
    glen = len(grid_shape)

    kw = dict(backend=backend, fused_interpret=fused_interpret)

    @jax.jit
    def chunk_step(fc, meta, isd, lon, st):
        if meta is not None:     # packed wire: reconstruct on device
            fc = _recon_wire(fc, meta, wire)
        in_specs = ({k: fspec for k in fc}, P(None), gspec,
                    jax.tree_util.tree_map(lambda _: gspec, st))

        # check_vma=False: pallas_call inside shard_map cannot declare
        # varying-across-mesh outputs (pointwise workload — nothing is
        # actually replicated); harmless for the jit backend.
        @partial(shard_map, mesh=mesh, in_specs=in_specs,
                 out_specs=(fspec, gspec), check_vma=False)
        def local_series(fc, isd, lo, st):
            return run_series(cfg, fc, skin_state=st, isecday_utc=isd,
                              lon=lo, **kw)

        outs, ns = local_series(fc, isd, lon, st)
        padded = tuple(fc["sst"].shape[1:])
        if padded != tuple(grid_shape):
            sl = (Ellipsis,) + tuple(slice(0, s) for s in grid_shape)
            outs = jax.tree_util.tree_map(
                lambda x: x[sl] if x.shape[-glen:] == padded else x, outs)
        return outs, ns

    return chunk_step


@functools.lru_cache(maxsize=64)
def _make_record_step(cfg, backend, fused_interpret):
    """Jitted single-record step, cached per static config (see
    :func:`_make_chunk_step`)."""
    from .api import FluxOutput, flux_step

    if backend == "fused":
        from .kernels.fused import fused_flux_step

        @jax.jit
        def step(rec, isd, lon0, st):
            import jax.numpy as jnp
            lo = rec.get("lon", lon0)
            if lo is None:
                lo = jnp.zeros_like(rec["sst"])
            (QL, QH, Tau_x, Tau_y, Evap, T_s), ns = fused_flux_step(
                cfg, rec["sst"], rec["t_zt"], rec["hum_zt"], rec["U_zu"],
                rec["V_zu"], rec["slp"], rec["rad_sw"], rec["rad_lw"],
                lon=lo, isecday_utc=isd, skin_state=st,
                interpret=fused_interpret)
            return FluxOutput(QL=QL, QH=QH, Tau=None, Tau_x=Tau_x,
                              Tau_y=Tau_y, Evap=Evap, T_s=T_s, rho_a=None,
                              diag=None), ns
    else:
        @jax.jit
        def step(rec, isd, lon0, st):
            return flux_step(
                cfg, rec["sst"], rec["t_zt"], rec["hum_zt"], rec["U_zu"],
                rec["V_zu"], rec["slp"],
                rad_sw=rec.get("rad_sw"), rad_lw=rec.get("rad_lw"),
                isecday_utc=isd, lon=rec.get("lon", lon0), skin_state=st)
    return step


def run_series_pipelined(cfg, records: Iterable[Dict[str, np.ndarray]],
                         skin_state=None, sharding=None,
                         isecday_key: str = "isecday_utc",
                         lon=None,
                         collect: Optional[Callable] = None,
                         inflight: int = 2,
                         chunk: Optional[int] = None,
                         backend: str = "jit",
                         fused_interpret: bool = False,
                         buffer_size: int = 2,
                         wire: str = "f32",
                         collect_wire: str = "f32"):
    """Sequential time stepping with an overlapped host->device feed.

    Unlike :func:`aerobulk_tpu.run_series` (whole series resident on
    device, ``lax.scan``), this streams records from the host — the right
    shape when the forcing does not fit in HBM (e.g. years of 0.25-degree
    global fields).

    ``collect(out)`` selects what to keep from each FluxOutput (default:
    QL/QH/Tau/Evap).  It may return jax arrays: their device->host copies
    start asynchronously at dispatch time and are materialized to numpy
    only after ``inflight`` further records have been dispatched, so
    read-back never serializes against the next dispatch.

    ``chunk=K`` switches to chunked streaming: K records are stacked on
    the host, shipped in one transfer, and scanned on device via
    :func:`run_series` (``backend="fused"`` selects the fused GPU kernel;
    ``fused_interpret=True`` runs it in the Pallas interpreter off the
    GPU), amortizing the fixed per-dispatch cost over
    K * npoints.  ``collect`` then receives the chunk's stacked
    FluxOutput and each element of the returned results list covers K
    records (the final one possibly fewer).

    Chunked + ``sharding`` is the MULTI-CHIP streamed production shape
    (both backends): each chunk is device_put straight into the sharded
    layout on the prefetch thread and scanned *device-local* inside one
    ``shard_map`` (:func:`_make_sharded_chunk_step`) — the warm-layer
    state stays sharded and device-resident between chunks, and grids
    that do not divide the mesh evenly (721x1440 on a 2-D mesh) are
    edge-padded to shard boundaries on the host and sliced back before
    collection.  Per-record + multi-device ``sharding`` with
    ``backend="fused"`` raises — use ``chunk=1``, which has the same
    per-record semantics through the shard_map path.

    ``wire="i16"`` (chunked mode only) ships each forcing field as
    scale-offset-packed int16 — the NetCDF/GRIB packing convention — and
    reconstructs to fp32 on device: half the host->device bytes, which
    on a feed-bound link nearly doubles streamed throughput.  Per-field
    quantization error is (max-min)/131068 (e.g. ~0.1 mK on SST), far
    below fp32 flux sensitivity; packing runs on the prefetch thread.
    ``wire="i8d"`` goes further for smooth-in-time streams: the chunk's
    first record ships as absolute int16 and the rest as int8 deltas
    against the reconstructed previous record — (k+1)/k bytes per value
    (1.125 at chunk=8, 44% below i16), with per-record error bounded by
    that record's DELTA span / 253 (no error chaining; see
    :func:`_pack_i8_delta` for when this degrades).
    ``collect_wire="i16"`` is the D2H mirror: collected float fields are
    quantized on device (one extra dispatch) and reconstructed to fp32
    numpy on the host — half the read-back bytes, same packing
    convention (archives routinely store fluxes GRIB/NetCDF-packed).

    Returns ``(list of collected outputs, final SkinState)``.
    """
    from .api import init_skin_state

    if wire not in ("f32", "i16", "i8d"):
        raise ValueError(f"run_series_pipelined: unknown wire format "
                         f"{wire!r} (use 'f32', 'i16' or 'i8d')")
    if collect_wire not in ("f32", "i16"):
        raise ValueError(f"run_series_pipelined: unknown collect_wire "
                         f"format {collect_wire!r} (use 'f32' or 'i16')")
    if wire != "f32" and chunk is None:
        raise ValueError("run_series_pipelined: packed wire formats "
                         "require chunked mode (pass chunk=K) — "
                         "per-record streaming always ships raw fp "
                         "arrays")

    if backend == "fused":
        from .kernels.fused import require_gpu
        require_gpu("run_series_pipelined(backend='fused')",
                    fused_interpret)

    if sharding is not None and len(sharding.device_set) <= 1:
        sharding = None

    if sharding is not None and backend == "fused" and chunk is None:
        raise ValueError(
            "run_series_pipelined: per-record fused streaming over a "
            "multi-device sharding is not supported (pallas_call does not "
            "auto-partition under jit — the dispatch would gather the "
            "full grid onto one device or error); use chunk=1, which "
            "routes each record through a shard_map'd device-local scan")

    def _pad_sharded(arr, lead):
        """Edge-pad the trailing grid axes to shard multiples (host side,
        runs on the prefetch thread — see _mesh_pad_widths)."""
        if sharding is None:
            return arr
        pads = _mesh_pad_widths(sharding, arr.shape[lead:])
        if not any(pads):
            return arr
        return np.pad(arr, [(0, 0)] * lead + [(0, p) for p in pads],
                      mode="edge")

    # lon is static geography: commit it to the device ONCE up front —
    # as a plain numpy jit argument it would be re-transferred on every
    # step/chunk call (~4 MB per call on the 0.25-degree grid)
    if lon is not None and not isinstance(lon, jax.Array):
        lon = jax.device_put(_pad_sharded(np.asarray(lon), 0),
                             sharding if sharding is not None else None)

    coll = _InflightCollector(collect, inflight, wire=collect_wire)
    state = skin_state
    if state is not None and sharding is not None:
        # a user-supplied initial state is padded to shard boundaries and
        # stays padded (device-resident) for the whole run; the padding is
        # sliced away before returning
        state = jax.tree_util.tree_map(
            lambda x: jax.device_put(
                _pad_sharded(np.asarray(x), np.ndim(x) - 2), sharding),
            state)

    if chunk is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        ch_shard = rep_shard = None
        spec = None
        if sharding is not None:
            spec = tuple(sharding.spec)
            ch_shard = NamedSharding(sharding.mesh, P(None, *spec))
            rep_shard = NamedSharding(sharding.mesh, P())

        lon_cell = [None]   # per-record 'lon' shipped once (static field)
        lon_host = [None]   # host copy for the equality check below

        def put_chunk(ch):
            isd = ch.pop(isecday_key, None)
            # per-record 'lon' is static geography: ship ONE copy (from
            # the first chunk only), never packed — otherwise it would be
            # silently stacked into the forcing dict and IGNORED by
            # run_series (which takes lon as an argument)
            lo = ch.pop("lon", None)
            if lo is not None:
                lo = np.asarray(lo)
                if lon_cell[0] is None:
                    lon_host[0] = lo[0]
                    lon_cell[0] = jax.device_put(
                        _pad_sharded(lon_host[0], 0), sharding)
                if not np.array_equal(
                        lo, np.broadcast_to(lon_host[0], lo.shape)):
                    # only the FIRST record's lon is committed; a
                    # genuinely time-varying lon (drifting platform /
                    # moving nest) would silently get a wrong warm-layer
                    # solar clock — refuse instead
                    raise ValueError(
                        "run_series_pipelined: records carry a "
                        "time-varying 'lon'; only static geography is "
                        "supported (the first record's lon is committed "
                        "once) — drop 'lon' from the records and restart "
                        "a new series when the grid moves")
                lo = lon_cell[0]
            grid_shape = ch["sst"].shape[1:]
            if wire == "i16":
                dev = {}
                meta = {}
                for k, v in ch.items():
                    q, so = _pack_i16(v)
                    dev[k] = jax.device_put(_pad_sharded(q, 1), ch_shard)
                    meta[k] = jax.device_put(so, rep_shard)
                dev = {"data": dev, "meta": meta}
            elif wire == "i8d":
                # delta wire: int16 base record + int8 delta records —
                # (k+1)/k bytes per value instead of 2 (packing runs
                # here, on the prefetch thread)
                dev = {}
                meta = {}
                for k, v in ch.items():
                    q0, dq, m = _pack_i8_delta(np.asarray(v))
                    dev[k] = {"base": jax.device_put(_pad_sharded(q0, 0),
                                                     sharding),
                              "dq": jax.device_put(_pad_sharded(dq, 1),
                                                   ch_shard)}
                    meta[k] = jax.device_put(m, rep_shard)
                dev = {"data": dev, "meta": meta}
            else:
                dev = {"data": {k: jax.device_put(
                    _pad_sharded(np.asarray(v), 1), ch_shard)
                                for k, v in ch.items()}, "meta": None}
            dev["lon"] = lo
            dev["_grid"] = grid_shape
            sst0 = dev["data"]["sst"]
            dev["_pgrid"] = (tuple(sst0["base"].shape) if wire == "i8d"
                             else tuple(sst0.shape[1:]))
            if isd is not None:
                dev[isecday_key] = jax.device_put(isd, rep_shard)
            return dev

        chunk_step = None
        grid_shape = None
        fi = bool(fused_interpret)

        for ch in _prefetch_map(put_chunk,
                                _chunk_records(records, chunk, isecday_key),
                                buffer_size):
            isd = ch.pop(isecday_key, None)
            lo = ch.pop("lon", None)
            grid_shape = ch.pop("_grid")
            pgrid = ch.pop("_pgrid")
            if chunk_step is None:
                if sharding is None:
                    chunk_step = _make_chunk_step(cfg, backend, fi, wire)
                else:
                    chunk_step = _make_sharded_chunk_step(
                        cfg, backend, fi, sharding.mesh, spec,
                        tuple(grid_shape), wire)
            if state is None:
                dtype = (jax.numpy.float32 if wire != "f32"
                         else ch["data"]["sst"].dtype)
                state = init_skin_state(cfg, pgrid, dtype)
                if sharding is not None:
                    state = jax.tree_util.tree_map(
                        lambda x: jax.device_put(x, sharding), state)
            outs, state = chunk_step(ch["data"], ch["meta"], isd,
                                     lo if lo is not None else lon, state)
            coll.push(outs)
        if sharding is not None and state is not None \
                and grid_shape is not None \
                and tuple(state.dT_wl.shape) != tuple(grid_shape):
            # slice the shard padding off the returned state (the
            # collected outputs were already sliced inside chunk_step)
            sl = tuple(slice(0, s) for s in grid_shape)
            state = jax.tree_util.tree_map(lambda x: x[sl], state)
        return coll.drain(), state

    step = _make_record_step(cfg, backend, bool(fused_interpret))

    # per-record 'lon' is static geography: strip it on the producer side
    # and commit one device copy instead of re-uploading it every record
    lon_cell = [None]
    lon_host = [None]

    def strip_lon(recs):
        for r in recs:
            if "lon" in r:
                r = dict(r)
                lo = np.asarray(r.pop("lon"))
                if lon_cell[0] is None:
                    lon_host[0] = lo
                    lon_cell[0] = jax.device_put(lo, sharding)
                elif not np.array_equal(lo, lon_host[0]):
                    raise ValueError(
                        "run_series_pipelined: records carry a "
                        "time-varying 'lon'; only static geography is "
                        "supported (the first record's lon is committed "
                        "once) — drop 'lon' from the records and restart "
                        "a new series when the grid moves")
            yield r

    for rec in prefetch_to_device(strip_lon(records), sharding=sharding,
                                  buffer_size=buffer_size):
        isd = rec.pop(isecday_key, None)
        if state is None:
            state = init_skin_state(cfg, rec["sst"].shape, rec["sst"].dtype)
            if sharding is not None:
                state = jax.tree_util.tree_map(
                    lambda x: jax.device_put(x, sharding), state)
        out, state = step(
            rec, isd, lon_cell[0] if lon_cell[0] is not None else lon,
            state)
        coll.push(out)
    return coll.drain(), state
