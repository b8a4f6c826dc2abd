"""Worker process for the 2-process jax.distributed CPU test.

Spawned by tests/test_distributed.py as:
    python tests/_distributed_worker.py <coordinator> <nproc> <pid> <outdir>

Each process owns 2 virtual CPU devices (4 global), initializes
jax.distributed, builds a global (1, 4) grid mesh, feeds its OWN
host-local slab of the forcing through
``sharding.global_from_host_local`` (jax.make_array_from_process_local_data),
runs a jit-compiled 3-record stateful COARE3.6+skin scan (warm-layer
state carried across records) sharded over the global mesh, and saves its
addressable per-point output shards to ``<outdir>/worker<pid>.npz``.
The parent reassembles the global fields and compares them PER POINT
against a single-process run of the same global problem.
"""

import os
import sys

# exactly 2 local virtual CPU devices per process (before any jax import);
# strip any inherited device-count flag (the pytest parent sets 8)
flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
         if "xla_force_host_platform_device_count" not in f]
os.environ["XLA_FLAGS"] = " ".join(
    flags + ["--xla_force_host_platform_device_count=2"])

import jax  # noqa: E402

# the workers run on the CPU whatever accelerator the host has; the platform
# choice must be fixed in-process before any backend is used
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

NT = 3   # records in the stateful scan (multi-step: VERDICT r2 item 2)


def global_problem(ny=8, nx=16):
    """The same global forcing on every process (same seed)."""
    rng = np.random.default_rng(2027)
    shape = (NT, ny, nx)
    sst = 285.0 + 15.0 * rng.random(shape)
    f = dict(
        sst=sst,
        t_zt=sst + rng.normal(0.0, 2.0, shape),
        hum_zt=0.004 + 0.012 * rng.random(shape),
        U_zu=rng.normal(0.0, 6.0, shape),
        V_zu=rng.normal(0.0, 6.0, shape),
        slp=98000.0 + 4000.0 * rng.random(shape),
        rad_sw=500.0 * rng.random(shape),
        rad_lw=250.0 + 150.0 * rng.random(shape),
    )
    lon = 360.0 * rng.random((ny, nx))
    isd = np.asarray([5 * 3600, 43200, 82800], np.int32)
    return f, lon, isd


def main():
    coordinator, nproc, pid, outdir = (sys.argv[1], int(sys.argv[2]),
                                       int(sys.argv[3]), sys.argv[4])

    from aerobulk_tpu.sharding import (global_from_host_local,
                                       init_distributed, make_grid_mesh)

    init_distributed(coordinator_address=coordinator, num_processes=nproc,
                     process_id=pid)

    assert jax.process_count() == nproc, jax.process_count()
    devs = jax.devices()
    assert len(devs) == 2 * nproc, devs      # global device view

    import jax.numpy as jnp
    from aerobulk_tpu.api import AeroBulkConfig, init_skin_state, run_series

    mesh = make_grid_mesh(devs, shape=(1, len(devs)))

    # global problem: (8, 16) grid split over gx=4 -> each device owns
    # (8, 4); this process owns the two columns of its two local devices.
    f_g, lon_g, isd = global_problem()
    ny, nx = lon_g.shape
    nx_local = nx // nproc
    x0 = pid * nx_local

    # each process feeds ONLY its local slab (the multi-host IO pattern)
    forcing = global_from_host_local(
        mesh, {k: v[..., x0:x0 + nx_local] for k, v in f_g.items()}, ndim=3)
    lon = global_from_host_local(mesh, lon_g[:, x0:x0 + nx_local])

    cfg = AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=3,
                         use_skin=True)
    state = init_skin_state(cfg, (ny, nx_local), jnp.float64)
    state = global_from_host_local(mesh, state)

    @jax.jit
    def series(fc, lo, st):
        out, ns = run_series(cfg, fc, skin_state=st,
                             isecday_utc=jnp.asarray(isd), lon=lo)
        return out.QL, out.QH, out.Tau, ns

    ql, qh, tau, ns = series(forcing, lon, state)
    jax.block_until_ready((ql, qh, tau, ns))

    def local_slab(x):
        """Reassemble THIS process's addressable shards (order by x)."""
        shards = sorted(x.addressable_shards,
                        key=lambda s: s.index[-1].start)
        return np.concatenate([np.asarray(s.data) for s in shards], axis=-1)

    out = {"x0": np.asarray(x0), "QL": local_slab(ql), "QH": local_slab(qh),
           "Tau": local_slab(tau), "dT_wl": local_slab(ns.dT_wl),
           "Qnt_ac": local_slab(ns.Qnt_ac)}
    assert all(np.all(np.isfinite(v)) for v in out.values())
    np.savez(os.path.join(outdir, f"worker{pid}.npz"), **out)
    print(f"WORKER {pid} OK {out['QL'].sum():.12e}", flush=True)

    # multi-host sharded checkpoint: a COLLECTIVE Orbax save (each process
    # writes only its addressable shards) + restore onto the same mesh,
    # bitwise per local shard.  This is the path save_skin_state (host
    # np.asarray gather) cannot take on multi-host state.
    from aerobulk_tpu.skin import (load_skin_state_sharded,
                                   save_skin_state_sharded)
    ckpt_dir = os.path.join(outdir, "skin_ckpt")
    save_skin_state_sharded(ckpt_dir, ns)
    restored = load_skin_state_sharded(ckpt_dir, ns)
    for name in ns._fields:
        np.testing.assert_array_equal(local_slab(getattr(restored, name)),
                                      local_slab(getattr(ns, name)),
                                      err_msg=name)
    print(f"WORKER {pid} CKPT OK", flush=True)

    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
