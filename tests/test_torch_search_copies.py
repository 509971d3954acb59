"""The search's copies of the od on the port's block loop
(``ops/streaming.block_results`` over ``read_ahead``): reorder_spectrum's
sorting variable (``compute_sorting_variable``) and find_g_points' copy of
each gas's od and background (``_device_copy``).

On the CPU the loop copies each block with ``to_device``: the sorting
variable is held bit for bit to the parent's loop (each block copied by
``device_tensor`` and its kernel called directly), and the copy to
``device_tensor(a).index_select`` of the same index, at block sizes that do
and do not divide the spectrum.  On the card (marker ``gpu``, skipped
here; ``python -m pytest --noconftest -m gpu
tests/test_torch_search_copies.py``, which needs no jax), a small LW and a
small SW search stage every od block in page-locked memory, and their
sorting variables, ranks and g-points are the bits of the same search with
every block copied by ``to_device``, on the normal and the checked build.
"""

import contextlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from ecckd_tpu_torch.io.spectrum import Spectrum, spectrum_blocks
from ecckd_tpu_torch.ops import streaming
from ecckd_tpu_torch.tools import find_g_points as fgp
from ecckd_tpu_torch.tools import reorder_spectrum as rs
from ecckd_tpu_torch.tools.common import device_tensor

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


def _profile(nwav=1000, nlay=15, seed=3):
    """A line spectrum over a continuum (tests/test_torch_kernels.py's rig
    at another size): columns thinner and thicker than the threshold."""
    rng = np.random.default_rng(seed)
    p = np.exp(np.linspace(np.log(100.0), np.log(1.013e5), nlay + 1))
    t = np.linspace(210.0, 284.0, nlay + 1)
    wav = np.linspace(1.0, 2000.0, nwav)
    k = np.full(nwav, 1e-4)
    for c0, s, wd in zip(rng.uniform(wav[0], wav[-1], 60),
                         10.0 ** rng.uniform(-1, 3.5, 60),
                         rng.uniform(2, 30, 60) * (wav[-1] - wav[0]) / 2000):
        k = k + s / (1.0 + ((wav - c0) / wd) ** 2)
    tfact = np.exp(0.02 * (t[1:, None] - 250.0))
    od = 0.01 * (np.diff(p) / 9.80665 / 0.02897)[:, None] * 1e-3 * k * tfact
    return p, t, wav, np.gradient(wav), od


def _parents_sorting(p, wav, dwav, od, threshold, block_wav, dtype, do_sw):
    """The sorting variable as the parent computed it: each block copied by
    ``device_tensor`` and its kernel called on it, two read-backs a
    block."""
    nwav = len(wav)
    sorting, column = np.empty(nwav), np.empty(nwav)
    p_hl = device_tensor(p, CPU, dtype)
    for i0 in range(0, nwav, block_wav):
        sl = slice(i0, i0 + block_wav)
        od_t = device_tensor(od[:, sl], CPU, dtype)
        if do_sw:
            s, c = rs._sw_sorting_kernel(p_hl, od_t, threshold)
        else:
            s, c = rs._sorting_kernel(
                p_hl, device_tensor(wav[sl], CPU, dtype),
                device_tensor(dwav[sl], CPU, dtype), od_t,
                threshold_optical_depth=threshold)
        sorting[sl] = s.numpy()
        column[sl] = c.numpy()
    return sorting, column


@pytest.mark.parametrize("source", ["dense", "blocks"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("do_sw", [False, True], ids=["lw", "sw"])
def test_sorting_variable_on_the_loop_is_the_parents(do_sw, dtype, source):
    """1000 wavenumbers in blocks of 300 (the last short), from a dense
    array (row-strided views) and from a ProfileBlocks: the parent's bits,
    both arrays float64, every block counted as a pageable copy."""
    p, t, wav, dwav, od = _profile()
    threshold, block_wav = 0.5, 300
    want = _parents_sorting(p, wav, dwav, od, threshold, block_wav, dtype,
                            do_sw)
    src = od if source == "dense" else spectrum_blocks(
        Spectrum(p, t, wav, dwav, od))
    streaming.reset_transfer_counts()
    got = rs.compute_sorting_variable(p, wav, dwav, src, threshold,
                                      block_wav, device="cpu", dtype=dtype,
                                      do_sw=do_sw)
    assert streaming.transfer_counts() == {"pinned": 0, "pageable": 4}
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("block_wav", [300, 1000, 4096])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_device_copy_is_device_tensor(monkeypatch, dtype, block_wav):
    """find_g_points' copy of an od, gathered into rank order, equals
    ``device_tensor(a).index_select(1, index)`` exactly, in blocks that do
    and do not divide the 1000 wavenumbers, and in one block."""
    od = _profile()[-1]
    index = torch.from_numpy(np.random.default_rng(5).permutation(1000))
    monkeypatch.setattr(fgp, "COPY_BLOCK_WAV", block_wav)
    streaming.reset_transfer_counts()
    got = fgp._device_copy(od, CPU, dtype)
    assert streaming.transfer_counts() == {
        "pinned": 0, "pageable": -(-1000 // block_wav)}
    assert got.dtype == dtype and got.shape == od.shape
    want = device_tensor(od, CPU, dtype).index_select(1, index)
    assert torch.equal(got.index_select(1, index), want)


def test_nothing_read_back_for_an_empty_reduce():
    """A ``reduce`` that writes its block elsewhere and returns {}: the
    loop yields each block's offset with an empty dict, in order, and a
    ``reduce`` with results on the same loop still reads them back."""
    a = np.arange(2 * 10, dtype=np.float64).reshape(2, 10)
    out = torch.zeros(2, 10, dtype=torch.float64)
    blocks = [(i0, a[:, i0:i0 + 4]) for i0 in range(0, 10, 4)]

    def into(i0, block):
        out[:, i0:i0 + block.shape[1]] = block
        return {}

    got = list(streaming.block_results(iter(blocks), into, CPU,
                                       torch.float64))
    assert got == [(0, {}), (4, {}), (8, {})]
    assert torch.equal(out, torch.from_numpy(a))
    sums = list(streaming.block_results(
        iter(blocks), lambda i0, b: {"s": b.sum(dim=0)}, CPU, torch.float64))
    assert [i0 for i0, _ in sums] == [0, 4, 8]
    np.testing.assert_array_equal(
        np.concatenate([r["s"] for _, r in sums]), a.sum(axis=0))


# ---------------------------------------------------------------- the card

def _bench_conftest():
    spec = importlib.util.spec_from_file_location(
        "ckd_bench_tests_conftest_copies",
        ROOT / "ckd_bench" / "tests" / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REORDER_BLOCK, COPY_BLOCK = 5000, 3000


def _small_search(name, monkeypatch, device):
    """The benchmark's search job on ``name``'s configuration cut as its
    tests cut it, with reorder's blocks of ``REORDER_BLOCK`` and
    find_g_points' copies of ``COPY_BLOCK`` wavenumbers: (job, the od
    blocks a search copies)."""
    import sys
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from ckd_bench.jobs.search import Job
    bench = _bench_conftest()
    override = bench.LW_SEARCH if name == "lw-fsck32" else bench.SW_SEARCH
    cfg = bench.tiny(name, **override)
    real = rs.compute_sorting_variable
    monkeypatch.setattr(
        rs, "compute_sorting_variable",
        lambda *a: real(*a[:5], REORDER_BLOCK, *a[6:]))
    monkeypatch.setattr(fgp, "COPY_BLOCK_WAV", COPY_BLOCK)
    job = Job(cfg, {"job": "search"}, 2 ** 31 + 5, device)
    nwav = cfg["nwav"]
    nbg = sum(bg is not None for _, _, bg in job.gases)
    blocks = (len(job.gases) * -(-nwav // REORDER_BLOCK)
              + (len(job.gases) + nbg) * -(-nwav // COPY_BLOCK))
    return job, blocks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: page-locked memory and side streams "
                    "have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def quiet():
    from ecckd_tpu_torch import logs
    logs.set_log_level("warning")
    yield
    logs.set_log_level("info")


def _arrays(answer):
    """A search's sorting variables and ranks, and each gas's g-points."""
    orders, gp = answer
    return ([o[k] for o in orders for k in ("sorting_variable", "rank")]
            + [a for g in gp.gases for a in (g.rank1, g.rank2, g.error)])


def test_search_on_the_cpu_copies_every_block_pageable(monkeypatch, quiet):
    """The small LW search on the CPU: every od block reorder and
    find_g_points copy goes through ``to_device``, none is staged."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        job, blocks = _small_search("lw-fsck32", monkeypatch, "cpu")
        streaming.reset_transfer_counts()
        job.run()
    finally:
        torch.set_num_threads(threads)
    assert streaming.transfer_counts() == {"pinned": 0, "pageable": blocks}


@pytest.mark.gpu
@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("name", ["lw-fsck32", "sw-rgb32"])
def test_search_stages_every_od_block(cuda, monkeypatch, quiet, name,
                                      checked):
    """A small search on the card: every od block of reorder and
    find_g_points staged and counted pinned, none pageable, and the
    sorting variables, ranks and g-points the bits of the same search with
    every block copied by ``to_device`` (staging switched off in this
    test); on the normal and the checked build."""
    from ecckd_tpu_torch.ops.kernels import _build
    job, blocks = _small_search(name, monkeypatch, cuda)
    with _build.checked() if checked else contextlib.nullcontext():
        streaming.reset_transfer_counts()
        staged = job.run()
        assert streaming.transfer_counts() == {"pinned": blocks,
                                               "pageable": 0}
        monkeypatch.setattr(streaming, "_staged", lambda blocks: blocks)
        streaming.reset_transfer_counts()
        pageable = job.run()
        assert streaming.transfer_counts() == {"pinned": 0,
                                               "pageable": blocks}
    assert job.digest(staged) == job.digest(pageable)
    for a, b in zip(_arrays(staged), _arrays(pageable)):
        np.testing.assert_array_equal(a, b)
