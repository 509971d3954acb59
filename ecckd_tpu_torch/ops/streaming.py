"""The port's one loop over wavenumber blocks, and g-point averaging on it.

The port's counterpart of ``ecckd_tpu/ops/streaming.py``: a profile too
large to hold (CKDMIP's ~5.6M wavenumbers x ~50 layers) is averaged into
g-points block by block.  :func:`block_results` is the loop every
block-wise pass of the port runs on (dense and streamed averaging here,
the mesh's in :mod:`ecckd_tpu_torch.parallel.sharded_average`,
lw_spectra, reorder_spectrum's sorting variable, find_g_points' copies
of each gas's od): it puts each block on the device, enqueues the
caller's reduction of it and reads the reduction's tensors back in one
copy; the blocks' results combine on the host (:func:`fold_blocks`,
:func:`~ecckd_tpu_torch.ops.average.combine_partials`).  Blocks read from
a source are read ahead on a background thread (:func:`read_ahead`,
io/prefetch.py); on a CUDA device that thread also stages each in
page-locked memory, and the loop copies it to the card on a side stream
one block ahead of its reduction.  Blocks, reductions and the order of
their results do not depend on the path, so neither do the bits.  The
loop's spans keep create_lut's names (``ecckd.create_lut.wait_block``,
``.stage``, ``.copy``, ``.partials``), where a table reads them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import logs
from .average import (GPOINT_AVERAGING_METHODS, combine_partials,
                      finalize_gpoint_partials, gpoint_block_partials)


def to_device(a, device, dtype):
    """``a`` (numpy or tensor) as a ``dtype`` tensor on ``device``: copied
    in its own type and widened there.  A transposed view of C-ordered data
    (a shard block) is copied as it lies in memory, without a host pass."""
    if isinstance(a, np.ndarray):
        if not a.flags.c_contiguous and a.T.flags.c_contiguous:
            a = torch.from_numpy(a.T).T
        else:
            a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=device).to(dtype=dtype)


_transfers = {"pinned": 0, "pageable": 0}


def transfer_counts():
    """Host blocks the loop has copied to a device since the last reset:
    ``pinned``, staged in page-locked memory and copied to the card one
    block ahead of its reduction; ``pageable``, copied any other way.  A
    block that lies where it is reduced counts as neither."""
    return dict(_transfers)


def reset_transfer_counts():
    for key in _transfers:
        _transfers[key] = 0


def _stage(a, pin_memory=True):
    """Host block ``a`` (numpy) copied into a new buffer of its own dtype,
    page-locked with ``pin_memory``.  A transposed view of C-ordered data
    (a shard block) keeps its layout and is copied as it lies; any other
    view, such as a slice of an (nlay, nwav) array, is made C-contiguous.
    The buffer comes from PyTorch's caching host allocator, which does not
    hand it out again while a copy from it is in flight."""
    t = torch.from_numpy(a)
    # empty_like keeps the strides of a dense tensor, and gives any other
    # C order
    return torch.empty_like(t, pin_memory=pin_memory).copy_(t)


def _staged(blocks):
    """``blocks`` with each host block staged by :func:`_stage`: iterated
    on the prefetch thread, so that the host copy overlaps the consumer's
    work."""
    for iwav0, block in blocks:
        if isinstance(block, np.ndarray):
            with logs.span("ecckd.create_lut.stage"):
                block = _stage(block)
        yield iwav0, block


def _upload(block, device, stream):
    """Start the copy of a staged block to ``device`` on ``stream``:
    (device block, event the copy records when done)."""
    with torch.cuda.stream(stream):
        return block.to(device, non_blocking=True), stream.record_event()


def _waited(blocks):
    """``blocks``, each ``next`` of it under the span
    ``ecckd.create_lut.wait_block``: the time the consumer waits for the
    prefetch thread's next block."""
    blocks = iter(blocks)
    while True:
        with logs.span("ecckd.create_lut.wait_block"):
            item = next(blocks, None)
        if item is None:
            return
        yield item


def read_ahead(blocks, device):
    """``blocks`` (iwav0, host block) read two ahead on a background
    thread, and on a CUDA ``device`` staged there in page-locked memory:
    overlaps the reads, a ProfileBlocks' host widening and the staging with
    the device's reduction."""
    from ..io.prefetch import prefetch_iter
    if device.type == "cuda":
        blocks = _staged(blocks)
    return _waited(prefetch_iter(logs.spawned_iter(blocks), depth=2))


def block_results(blocks, reduce, device=None, dtype=None):
    """The loop: for each (iwav0, block) of ``blocks``, in order, (iwav0,
    dict of numpy arrays) of ``reduce(iwav0, device_block)``, a dict of
    tensors on one device, read back in one copy.  A ``reduce`` that
    returns an empty dict (it writes its block somewhere on the device)
    has nothing read back, and the loop does not wait for the device.

    With a ``device``, every host block (numpy or a CPU tensor) goes there
    as a ``dtype`` tensor: on a card a page-locked one (:func:`read_ahead`
    stages them) on a side stream, block i + 1's copy issued after block
    i's reduction is enqueued and before its results are read back, so
    the copy engine moves the next block while the reduction stream works
    on this one; any other by :func:`to_device`.  A block already on a
    card, or every block where ``device`` is None (the dense path, a
    mesh's shards), is reduced as it lies."""
    blocks = iter(blocks)
    side = compute = None
    if device is not None and device.type == "cuda":
        side = torch.cuda.Stream(device)
        compute = torch.cuda.current_stream(device)

    def issue():
        item = next(blocks, None)
        if item is None:
            return None
        iwav0, block = item
        if side is None or not (torch.is_tensor(block) and block.is_pinned()):
            return iwav0, block, None
        with logs.span("ecckd.create_lut.copy"):
            return (iwav0, *_upload(block, device, side))

    ahead = issue()
    while ahead is not None:
        iwav0, block, copied = ahead
        if copied is not None:
            _transfers["pinned"] += 1
            compute.wait_event(copied)
            # Allocated on the side stream, read on this one
            block.record_stream(compute)
            block = block.to(dtype=dtype)
        elif device is not None and (isinstance(block, np.ndarray)
                                     or block.device.type == "cpu"):
            _transfers["pageable"] += 1
            with logs.span("ecckd.create_lut.copy"):
                block = to_device(block, device, dtype)
        with logs.span("ecckd.create_lut.partials"):
            out = reduce(iwav0, block)
            flat = (torch.cat([v.reshape(-1) for v in out.values()])
                    if out else None)
        ahead = issue()
        if flat is None:
            yield iwav0, {}
            continue
        with logs.span("ecckd.create_lut.partials"):
            flat = flat.cpu().numpy()
        host, i = {}, 0
        for key, v in out.items():
            host[key] = flat[i:i + v.numel()].reshape(v.shape)
            i += v.numel()
        yield iwav0, host


def fold_blocks(blocks, reduce, device=None, dtype=None):
    """The results of :func:`block_results`, combined over the blocks in
    order by :func:`~ecckd_tpu_torch.ops.average.combine_partials`."""
    acc = None
    for _, part in block_results(blocks, reduce, device, dtype):
        acc = part if acc is None else combine_partials(acc, part)
    return acc


def average_od_to_gpoints(ng, g_point, optical_depth, weight,
                          averaging_method, pressure_fl=None,
                          block_wav=1 << 20):
    """Average spectral od into g-points: (od_fit, min_od, max_od), numpy
    (nz, ng).  Ref average_optical_depth_to_g_point
    (average_optical_depth.cpp:21-197) minus the molar-abs conversion
    (:func:`~ecckd_tpu_torch.ops.average.od_to_molar_abs`).

    The arrays are cut into blocks of ``block_wav`` wavenumbers and reduced
    by the loop exactly as :func:`streaming_average_od_to_gpoints` reduces
    a profile read from disk, so at the same block size the two give the
    same bits.

    Args:
      ng: number of g-points.
      g_point: (nwav,) integer tensor, wavenumber -> g-point (<0 =
        unassigned).
      optical_depth: (nz, nwav); weight: broadcastable to it, on the same
        device.
      averaging_method: any of ops.average.GPOINT_AVERAGING_METHODS.
      pressure_fl: (nz,), required for the hybrid method.
    """
    od = optical_depth
    w = torch.broadcast_to(weight, od.shape)

    def reduce(i0, od_block):
        sl = slice(i0, i0 + od_block.shape[1])
        return gpoint_block_partials(ng, g_point[sl], od_block, w[:, sl],
                                     averaging_method)

    acc = fold_blocks(((i0, od[:, i0:i0 + block_wav])
                       for i0 in range(0, od.shape[-1], block_wav)), reduce)
    if torch.is_tensor(pressure_fl):
        pressure_fl = pressure_fl.cpu().numpy()
    return finalize_gpoint_partials(acc, averaging_method,
                                    pressure_fl=pressure_fl)


def streaming_average_od_to_gpoints(reader, ng, g_point, weight_fn,
                                    averaging_method,
                                    block_wav: int = 1 << 16,
                                    pressure_fl=None, device="cuda",
                                    dtype=torch.float64):
    """Average a profile's od into g-points, streaming wavenumber blocks.

    Args:
      reader: anything with ``iter_blocks(block_wav=...)`` yielding
        (iwav0, (nz, nb) od): an io.shards.ShardReader or an
        io.spectrum.ProfileBlocks.
      g_point: (nwav,) map in the reader's wavenumber order.
      weight_fn: callable (iwav0, nb) -> (nz, nb) or (nb,) weights (Planck
        or SSI slice), numpy or a tensor.
      averaging_method: any of ops.average.GPOINT_AVERAGING_METHODS.
      pressure_fl: (nz,) full-level pressure, required for the hybrid
        pressure-switched method.
      device, dtype: where and in which type each block is reduced (the
        card unless ``device="cpu"``; raises without one).

    Returns (od_fit, min_od, max_od), numpy (nz, ng): the semantics of
    :func:`average_od_to_gpoints`, and its bits at the same block size.
    """
    from ..tools.common import resolve_device
    if averaging_method not in GPOINT_AVERAGING_METHODS:
        raise ValueError(
            f"streaming averaging does not support {averaging_method!r}; "
            f"choose from {GPOINT_AVERAGING_METHODS}")
    device = resolve_device(device)
    gp = torch.as_tensor(g_point, device=device)

    def reduce(iwav0, od_block):
        nb = od_block.shape[1]
        return gpoint_block_partials(
            ng, gp[iwav0:iwav0 + nb], od_block,
            to_device(weight_fn(iwav0, nb), device, dtype), averaging_method)

    acc = fold_blocks(read_ahead(reader.iter_blocks(block_wav=block_wav),
                                 device), reduce, device, dtype)
    return finalize_gpoint_partials(acc, averaging_method,
                                    pressure_fl=pressure_fl)
