"""The streamed average's pinned path on the card (``ecckd_tpu_torch/ops/
streaming.py``: ``_stage``, ``_upload``, ``block_results``).

On a CUDA device the prefetch thread stages each host block in page-locked
memory and the consumer copies it on a side stream one block ahead of its
reduction.  On the card (marker ``gpu``, skipped here; run with ``python
-m pytest --noconftest -m gpu tests/test_torch_pinned_streaming.py``,
which needs no jax):

* a profile streamed in many small blocks, so that the staging buffers
  cycle fast, from arrays in memory (row-strided float64 views) and from a
  float32 shard (transposed views, widened on the card): the pinned path
  against the same loop on unstaged blocks (each block copied by
  ``to_device``) and the dense path at the same block size, bit for bit,
  every block counted as pinned;
* staging buffers handed back to the allocator while their copies still
  wait on a stalled side stream: each block reaches the card as staged,
  none overwritten by a later block's staging.

``block_sources`` also serves the CPU tests of the staging in
tests/test_torch_streaming.py.
"""

import numpy as np
import pytest
import torch

from ecckd_tpu_torch.io.shards import ShardReader, write_shard
from ecckd_tpu_torch.io.spectrum import Spectrum, spectrum_blocks
from ecckd_tpu_torch.ops import streaming
from ecckd_tpu_torch.ops.average import (finalize_gpoint_partials,
                                         gpoint_block_partials)
from ecckd_tpu_torch.ops.streaming import average_od_to_gpoints

SOURCES = ("arrays", "shard64", "shard32")


def block_sources(tmp_path, nlay=50, nwav=4096 * 24 + 123, seed=0):
    """A profile's od (nlay, nwav) float64 in memory and a function of a
    source name giving a block reader over it: ``arrays``
    (``spectrum_blocks``: row-strided float64 views), ``shard64`` and
    ``shard32`` (a ``ShardReader`` over a float64 or float32 shard:
    transposed views).  The od of ``shard32`` is the float32 one."""
    rng = np.random.default_rng(seed)
    p = np.exp(np.linspace(np.log(100.0), np.log(1.013e5), nlay + 1))
    wav = np.linspace(1.0, 3260.0, nwav)
    sp = Spectrum(p, np.linspace(210.0, 284.0, nlay + 1), wav,
                  np.gradient(wav), rng.gamma(0.5, 0.5, (nlay, nwav)),
                  molecule="h2o", reference_surface_vmr=0.01)

    def reader(kind):
        if kind == "arrays":
            return spectrum_blocks(sp), sp.optical_depth
        dtype = np.float64 if kind == "shard64" else np.float32
        path = write_shard(str(tmp_path / f"{kind}.spbin"), sp, dtype)
        return ShardReader(path), sp.optical_depth.astype(dtype)
    return sp, reader


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: page-locked memory and side streams "
                    "have no CPU mode")
    return torch.device("cuda")


def _pageable(reader, ng, gp, wfn, method, block_wav, device):
    """The block loop on the blocks as read, without staging: each block
    copied by ``to_device``."""
    def reduce(iwav0, od):
        nb = od.shape[1]
        return gpoint_block_partials(
            ng, gp[iwav0:iwav0 + nb], od,
            streaming.to_device(wfn(iwav0, nb), device, torch.float64),
            method)

    acc = streaming.fold_blocks(reader.iter_blocks(block_wav=block_wav),
                                reduce, device, torch.float64)
    return finalize_gpoint_partials(acc, method)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["transmission", "logarithmic"])
@pytest.mark.parametrize("kind", ["arrays", "shard32"])
def test_pinned_path_is_pageable_and_dense(cuda, tmp_path, kind, method):
    """Blocks of 4096 wavenumbers (25 a profile, the last short): the
    pinned path equals the pageable loop and the dense path bit for bit,
    and counts every block as pinned."""
    block_wav, ng = 4096, 7
    sp, source = block_sources(tmp_path)
    nlay, nwav = sp.optical_depth.shape
    rng = np.random.default_rng(1)
    gp = torch.as_tensor(rng.integers(-1, ng, nwav), device=cuda)
    w = torch.as_tensor(np.abs(rng.normal(5, 1, (nlay, nwav))), device=cuda)
    wfn = lambda i0, n: w[:, i0:i0 + n]  # noqa: E731
    reader, od = source(kind)
    with reader:
        streaming.reset_transfer_counts()
        got = streaming.streaming_average_od_to_gpoints(
            reader, ng, gp, wfn, method, block_wav=block_wav, device=cuda)
        counts = streaming.transfer_counts()
        pageable = _pageable(reader, ng, gp, wfn, method, block_wav, cuda)
    dense = average_od_to_gpoints(
        ng, gp, torch.as_tensor(od, device=cuda).double(), w, method,
        block_wav=block_wav)
    nblocks = -(-nwav // block_wav)
    assert counts == {"pinned": nblocks, "pageable": 0}
    for g, p, d in zip(got, pageable, dense):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, d)


@pytest.mark.gpu
def test_staging_buffers_outlive_their_copies(cuda):
    """Each block staged, its copy queued behind a stall on the side
    stream and its buffer dropped at once: the host stages every later
    block while those copies wait, and each device block is still its own
    host block."""
    rng = np.random.default_rng(7)
    full = rng.random((50, 4096 * 32))
    host = [full[:, i0:i0 + 4096] for i0 in range(0, full.shape[1], 4096)]
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        torch.cuda._sleep(1 << 30)      # about half a second
    got = []
    for a in host:
        staged = streaming._stage(a)
        assert staged.is_pinned()
        got.append(streaming._upload(staged, cuda, side)[0])
        del staged
    assert not side.query(), "the copies ended before the staging"
    torch.cuda.synchronize()
    for a, d in zip(host, got):
        np.testing.assert_array_equal(d.cpu().numpy(), a)
