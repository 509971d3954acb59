"""Two processes over ``torch.distributed`` (gloo) on the CPU, as
tests/test_multihost.py runs two JAX processes.

The test starts this file twice as a script with torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``); each process holds 2 logical CPU shards, so the
process-major mesh has 4.  Each worker checks, against the same work done
in one process over a mesh of 4 logical shards:
1. ``initialize_from_env`` (gloo), 2 processes, ``local_shard_range``;
2. the two multi-controller averaging entry points, each process passing
   its own half of the wavenumbers: min and max identical, fits within
   1e-12 (the processes' sums associate differently);
3. a sharded LW candidate-cost probe: costs within 1e-12;
4. the data-parallel training cost (5 profiles over 4 shards, padded):
   value and gradient within 1e-12.
Each process has a timeout of its own, so a hang fails the test instead of
taking the suite's time.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

CPU = torch.device("cpu")
NLOCAL = 2


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo(tmp_path):
    from synth import synth_lw_ckd_model
    model = str(tmp_path / "model.nc")
    synth_lw_ckd_model().write(model, argv=["t"], config_str="")
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=root,
                   CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), model], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out}"
        assert f"MULTIHOST OK rank={rank}" in out, out


# ------------------------------------------------------------ the worker

def _lw_band(nwav=203, nlay=9, seed=5):
    """The arrays of an LW candidate-cost kernel, from a seed."""
    rng = np.random.default_rng(seed)
    p = np.exp(np.linspace(np.log(100.0), np.log(1.0e5), nlay + 1))
    od = 10.0 ** rng.uniform(-3, 0.5, (nlay, nwav))
    planck = np.abs(rng.normal(0.3, 0.05, (nlay + 1, nwav))) + 0.05
    lw = np.sqrt(p[1:]) - np.sqrt(p[:-1])
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    return dict(layer_weight=t(lw / lw.sum()), pressure_hl=t(p),
                surf_emissivity=t(np.full(nwav, 0.98)),
                surf_planck=t(planck[-1] * 1.05),
                flux_dn_surf=t(np.abs(rng.normal(0.2, 0.02, nwav))),
                flux_up_toa=t(np.abs(rng.normal(0.25, 0.02, nwav))),
                planck_hl=t(planck), bg_od=t(0.05 * od.sum(0) + 0 * od),
                metric=t(-np.expm1(-1.66 * od)),
                hr=t(rng.normal(0.0, 1e-5, (nlay, nwav))))


def _lbl(model, ncol=5, nlay=12, seed=3):
    """LW training fluxes of ``ncol`` profiles for the model's g-points."""
    from ecckd_tpu_torch.io.lbl_fluxes import LblFluxes
    rng = np.random.default_rng(seed)
    ng = model.ng
    m = LblFluxes()
    m.is_sw = False
    m.pressure_hl = np.tile(np.exp(np.linspace(np.log(120.0),
                                               np.log(1.0e5), nlay + 1)),
                            (ncol, 1))
    m.temperature_hl = (np.linspace(215.0, 288.0, nlay + 1)[None, :]
                        + rng.normal(0, 5, (ncol, 1)))
    h2o = 4e-6 + 8e-3 * (m.pressure_hl[:, 1:] / 1.0e5) ** 3
    co2 = 4.15e-4 * rng.uniform(1.0, 1.5, (ncol, nlay))
    m.vmr_fl = np.stack([h2o, co2], axis=1)
    m.molecules = ["h2o", "co2"]
    m.spectral_flux_dn = np.abs(rng.normal(5.0, 1.0, (ncol, nlay + 1, ng)))
    m.spectral_flux_up = np.abs(rng.normal(5.0, 1.0, (ncol, nlay + 1, ng)))
    m.flux_dn = m.spectral_flux_dn.sum(-1)
    m.flux_up = m.spectral_flux_up.sum(-1)
    conv = -(9.80665 / 1004.0) / np.diff(m.pressure_hl, axis=1)
    m.spectral_heating_rate = conv[:, :, None] * (
        np.diff(m.spectral_flux_dn, axis=1)
        - np.diff(m.spectral_flux_up, axis=1))
    m.heating_rate = m.spectral_heating_rate.sum(-1)
    m.surf_emissivity = np.ones((ncol, ng))
    m.have_spectral_fluxes = True
    return m


def _rel(a, b):
    a, b = np.ravel(np.asarray(a)), np.ravel(np.asarray(b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def worker(model_path):
    import torch.distributed as dist
    from ecckd_tpu_torch.models import CkdModel
    from ecckd_tpu_torch.ops.cost import CostWeights
    from ecckd_tpu_torch.optimize.solver import (TrainingCost,
                                                 log_state_tree, ravel_tree)
    from ecckd_tpu_torch.parallel import distributed
    from ecckd_tpu_torch.parallel import sharded_average as sa
    from ecckd_tpu_torch.parallel.mesh import Mesh, make_mesh
    from ecckd_tpu_torch.partition import CandidateCostLw
    from ecckd_tpu_torch.tools.optimize_lut import prepare_lbl

    assert distributed.initialize_from_env(backend="gloo", timeout_s=120)
    rank = dist.get_rank()
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    r = distributed.local_shard_range(10)
    assert list(r) == list(range(rank * 5, rank * 5 + 5)), list(r)
    r = distributed.local_shard_range(7)
    assert list(r) == (list(range(0, 4)) if rank == 0 else [4, 5, 6])

    mesh = make_mesh(devices=[CPU] * NLOCAL, data_parallel=1)
    one = Mesh([CPU] * 2 * NLOCAL, 1)        # one process, 4 shards
    assert mesh.size == one.size == 4 and mesh.process_count == 2
    assert [g for g, _ in mesh.local_shards()] == [2 * rank, 2 * rank + 1]

    # ---- the multi-controller averaging entry points
    nz, nwav, ng = 5, 512, 6
    rng = np.random.default_rng(7)            # the same on both processes
    od = 10.0 ** rng.uniform(-3, 0, (nz, nwav))
    od[:, rng.integers(0, nwav, 8)] = 0.0
    w = np.abs(rng.normal(1.0, 0.1, (nz, nwav)))
    gp = rng.integers(0, ng, nwav).astype(np.int32)
    half = nwav // 2
    sl = slice(rank * half, (rank + 1) * half)
    od_l, w_l, gp_l = od[:, sl], w[:, sl], gp[sl]
    for method in ("logarithmic", "transmission"):
        want = sa.sharded_average_od_to_gpoints(one, ng, gp, od, w, method)
        got = [sa.sharded_average_od_to_gpoints_multihost(
            mesh, ng, gp_l, od_l, w_l, method),
            sa.streaming_sharded_average_od_to_gpoints_multihost(
                mesh, ng, gp_l, lambda i0, nb: od_l[:, i0:i0 + nb], half,
                lambda i0, nb: w_l[:, i0:i0 + nb], method, block_wav=100)]
        for fit, mn, mx in got:
            assert _rel(fit, want[0]) <= 1e-12, method
            assert np.array_equal(mn, want[1]) and np.array_equal(mx,
                                                                  want[2])

    # ---- a sharded LW probe
    band = _lw_band()
    i1 = np.array([0, 30, 77, 150], np.int32)
    i2 = np.array([29, 76, 149, 202], np.int32)
    got = CandidateCostLw("transmission", 0.02, mesh=mesh,
                          **band).costs(i1, i2)
    want = CandidateCostLw("transmission", 0.02, mesh=one,
                           **band).costs(i1, i2)
    assert np.abs(got / want - 1.0).max() <= 1e-12, (got, want)

    # ---- the data-parallel training cost
    values = []
    for m in (mesh, one):
        model = CkdModel.read(model_path, active_gas_list=["h2o", "co2"])
        model.create_error_covariances(prior_error=2.0)
        lbl = _lbl(model)
        prepare_lbl(lbl, model, 1e4)
        cost = TrainingCost(model, [lbl], CostWeights(), device="cpu",
                            mesh=m)
        values.append(cost(ravel_tree(log_state_tree(model))))
    (v, g), (v1, g1) = values
    assert abs(v / v1 - 1.0) <= 1e-12 and _rel(g, g1) <= 1e-12, (v, v1)

    dist.barrier()
    dist.destroy_process_group()
    print(f"MULTIHOST OK rank={rank}", flush=True)


if __name__ == "__main__":
    worker(sys.argv[1])
