"""The round-5 experiment path of ecckd_tpu_torch against the JAX script.

The same numpy inputs go through ``scripts/exp_kernels.py`` (its Pallas
kernels E1 and E2 in interpret mode, float64) and through the port's plain
versions of E1 (:func:`sweep_lw_scan_plain`) and E2
(:func:`fused_sums_lw_plain`), which the wrappers run for CPU tensors.
Errors are normwise per output row.  E1 is held to 1e-10: the port takes
the emissivity as ``-expm1``, the script as ``1 - exp``, which differ in
the 11th digit at the ods of ~1e-5 of the top layers.  E2 is held to 1e-12:
the same products, summed in another order.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import bench  # noqa: E402
import exp_kernels as jexp  # noqa: E402

from ecckd_tpu_torch.ops.kernels import (fused_sums_lw_intervals,  # noqa: E402
                                         fused_sums_lw_plain,
                                         reset_launch_counts,
                                         sweep_lw_plain,
                                         sweep_lw_scan_intervals,
                                         sweep_lw_scan_plain)
from ecckd_tpu_torch.ops.segments import (interval_sum_fused,  # noqa: E402
                                          part_of)
from ecckd_tpu_torch.scripts import exp_kernels  # noqa: E402

E1_TOL = 1e-10
E2_TOL = 1e-12
JAX_TILE = 256


def _row_err(got, want):
    """Largest normwise relative error over the rows (absolute for an
    all-zero row, such as the downward flux at the top)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    num = np.linalg.norm(got - want, axis=1)
    den = np.linalg.norm(want, axis=1)
    return float(np.max(np.where(den > 0, num / np.maximum(den, 1e-300),
                                 num)))


def _bounds(nwav):
    """Two front-padded [0, 0] bucket columns, then intervals with a
    shared boundary index (200) whose last one stops short of the end."""
    i1 = np.array([0, 0, 0, 200, 450], np.int32)
    i2 = np.array([0, 0, 200, 449, nwav - 40], np.int32)
    return i1, i2


def _sweep_inputs(nlay, nwav, seed, seg_outside=37):
    rng = np.random.default_rng(seed)
    i1, i2 = _bounds(nwav)
    planck = np.abs(rng.normal(5, 1, (nlay + 1, nwav)))
    # ods from ~1e-5 in the top layers to ~5 at the surface
    scale = np.geomspace(1e-4, 1.0, nlay)[:, None]
    bg_od = scale * rng.gamma(2.0, 0.5, (nlay, nwav))
    od_fit = scale * rng.gamma(2.0, 0.5, (nlay, len(i1)))
    emis = rng.uniform(0.9, 1.0, nwav)
    surfp = np.abs(rng.normal(8, 1, nwav))
    seg = np.maximum(0, np.searchsorted(i1, np.arange(nwav), side="right")
                     - 1).astype(np.int32)
    seg[-seg_outside:] = -1
    return planck, bg_od, od_fit, seg, emis, surfp, i1, i2


def _sum_inputs(nlay, nwav, seed):
    rng = np.random.default_rng(seed)
    i1, i2 = _bounds(nwav)
    planck = np.abs(rng.normal(5, 1, (nlay + 1, nwav)))
    metric = -np.expm1(-1.66 * rng.gamma(0.5, 1.0, (nlay, nwav)))
    hr = rng.normal(0.0, 1e-5, (nlay, nwav))
    fd = np.abs(rng.normal(1, 0.2, nwav))
    fu = np.abs(rng.normal(2, 0.3, nwav))
    return metric, planck, hr, fd, fu, i1, i2


def _torch(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# (nlay, nwav): 7 and 50 layers pad to 8 and 64; 64 needs no padding; no
# nwav is a multiple of the JAX tile
_SWEEP_CASES = [(7, 1000), (50, 700), (64, 517)]


@pytest.mark.parametrize("nlay,nwav", _SWEEP_CASES)
def test_e1_plain_matches_jax_e1(nlay, nwav):
    args = _sweep_inputs(nlay, nwav, seed=nlay)
    want = jexp.rt_lw_bb_intervals_scan(*args, tile=JAX_TILE,
                                        interpret=True)
    got = sweep_lw_scan_plain(*_torch(args))
    for g, w in zip(got, want):
        assert g.shape == (nlay + 1, len(args[6]))
        assert _row_err(g, w) <= E1_TOL


@pytest.mark.parametrize("nlay,nwav", _SWEEP_CASES)
def test_e1_plain_matches_k1_plain(nlay, nwav):
    args = _torch(_sweep_inputs(nlay, nwav, seed=100 + nlay))
    for g, w in zip(sweep_lw_scan_plain(*args), sweep_lw_plain(*args)):
        assert _row_err(g, w) <= E1_TOL


@pytest.mark.parametrize("nlay,nwav", [(7, 1000), (50, 700)])
def test_e2_plain_matches_jax_e2(nlay, nwav):
    args = _sum_inputs(nlay, nwav, seed=nlay)
    want = jexp.fused_sums_pallas(*args, tile=JAX_TILE, interpret=True)
    got = fused_sums_lw_plain(*_torch(args))
    assert got.shape == (3 * nlay + 2, len(args[5]))
    assert _row_err(got, want) <= E2_TOL


@pytest.mark.parametrize("nlay,nwav", [(7, 1000), (50, 700)])
def test_e2_plain_matches_k3_plain(nlay, nwav):
    metric, planck, hr, fd, fu, i1, i2 = _torch(_sum_inputs(nlay, nwav, 9))
    w_num = planck[1:]
    want = interval_sum_fused([part_of(metric, w_num), part_of(w_num),
                               part_of(hr), part_of(fd), part_of(fu)],
                              nwav, i1, i2)
    got = fused_sums_lw_plain(metric, planck, hr, fd, fu, i1, i2)
    assert _row_err(got, want) <= E2_TOL


def test_cpu_tensors_take_plain_path():
    reset_launch_counts()
    args = _torch(_sweep_inputs(6, 700, seed=4))
    for g, w in zip(sweep_lw_scan_intervals(*args),
                    sweep_lw_scan_plain(*args)):
        assert torch.equal(g, w)
    sums = _torch(_sum_inputs(6, 700, seed=4))
    assert torch.equal(fused_sums_lw_intervals(*sums),
                       fused_sums_lw_plain(*sums))
    assert sweep_lw_scan_intervals.launches == 0
    assert fused_sums_lw_intervals.launches == 0


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA card has no kernel."""
    meta = lambda arrays: tuple(t.to("meta") for t in _torch(arrays))
    with pytest.raises(ValueError, match="no kernel"):
        sweep_lw_scan_intervals(*meta(_sweep_inputs(4, 600, seed=1)))
    with pytest.raises(ValueError, match="no kernel"):
        fused_sums_lw_intervals(*meta(_sum_inputs(4, 600, seed=1)))


def test_build_inputs_match_bench():
    want = bench.build_inputs(6, 300, 4, np.float64)
    got = exp_kernels.build_inputs(6, 300, 4, torch.float64, "cpu")
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].numpy()
        if w.dtype.kind == "i":
            assert g.dtype == np.int32 and np.array_equal(g, w), key
        else:
            assert g.dtype == np.float64, key
            np.testing.assert_allclose(g, w, rtol=1e-14, atol=0, err_msg=key)


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
def test_experiment_main_on_cpu(dtype, bar):
    """Every variant's lines, finite errors under the bars."""
    lines = []
    res = exp_kernels.main(device="cpu", dtype=dtype, nwav=4096, iters=1,
                           out=lines.append)
    text = "\n".join(lines)
    assert lines[0].startswith("device=cpu") and "nwav=4096" in lines[0]
    for tag in ("sweep-v0 (K1", "sweep-scan max rel err vs sweep-v0",
                "sweep-scan (E1", "isum-pallas max rel err vs K3",
                "isum-pallas (E2", "isum-K3 same rows"):
        assert tag in text, tag
    for variant in ("sweep-scan", "isum-pallas"):
        err = res[variant]["err"]
        assert np.isfinite(err) and err <= bar, (variant, err)
    for variant in exp_kernels.VARIANTS:
        assert np.isfinite(res[variant]["ms"]) and res[variant]["ms"] > 0
    assert res["sweep-scan"]["got"][0].shape == (51, 64)
    assert res["isum-pallas"]["got"].shape == (152, 64)


def test_experiment_command_line(monkeypatch, capsys):
    """``python -m ecckd_tpu_torch.scripts.exp_kernels`` reads EX_NWAV and
    EX_ITERS, the variants and ``device=``/``precision=``."""
    monkeypatch.setenv("EX_NWAV", "2048")
    monkeypatch.setenv("EX_ITERS", "1")
    assert exp_kernels._cli(["isum-pallas", "device=cpu",
                             "precision=float64"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "nwav=2048" in lines[0] and "dtype=float64" in lines[0]
    assert "iters=1" in lines[0]
    assert not any(line.startswith("sweep") for line in lines)
    assert any(line.startswith("isum-pallas (E2") for line in lines)
    with pytest.raises(ValueError, match="precision"):
        exp_kernels._cli(["device=cpu", "precision=bfloat16"])
    with pytest.raises(ValueError, match="unknown variants"):
        exp_kernels._cli(["sweep-v1", "device=cpu"])
