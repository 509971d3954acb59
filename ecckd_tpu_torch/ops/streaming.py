"""Streaming g-point averaging over wavenumber blocks.

The port's counterpart of ``ecckd_tpu/ops/streaming.py``: a profile too
large to hold (CKDMIP's ~5.6M wavenumbers x ~50 layers) is averaged into
g-points block by block.  Each block is copied to the device, reduced to
its partial sums there (:func:`~ecckd_tpu_torch.ops.average.
gpoint_block_partials`), and its partials come back in one read-back; the
host adds them up and applies the final transform.  Every averaging
method of average_optical_depth.cpp:120-197 (including logarithmic
zero-counting and the pressure-switched hybrid) decomposes this way.  The
blocks are read one ahead on a background thread (io/prefetch.py), so the
reads overlap the device's work.  On a CUDA device that thread also
stages each host block in page-locked memory, and the consumer copies it
to the card on a side stream one block ahead of its reduction, so the copy
overlaps the reduction before it (:func:`_pinned_partials`); the blocks,
their reduction and the order of their partials are the same, and so are
the bits.  The dense path
(:func:`~ecckd_tpu_torch.ops.average.average_od_to_gpoints`) runs the same
block reduction on arrays in memory.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import logs
from .average import (GPOINT_AVERAGING_METHODS, finalize_gpoint_partials,
                      gpoint_block_partials)


def _to_device(a, device, dtype):
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
    """Blocks the streamed loop has reduced since the last reset:
    ``pinned``, staged in page-locked memory and copied to the card one
    block ahead of its reduction; ``pageable``, every other block."""
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


def _pinned_partials(blocks, ng, gp, weight_fn, averaging_method, device,
                     dtype):
    """The partials of each block of ``blocks`` (the consumer's side of the
    prefetch thread's :func:`_staged` blocks), in order.  A staged block is
    copied on a side stream, block i + 1's copy issued before block i's
    partials are read back, so the copy engine moves the next block while
    the reduction stream works on this one; that read-back is the loop's
    only wait for the card.  Any other block goes by :func:`_to_device`."""
    side = torch.cuda.Stream(device)
    compute = torch.cuda.current_stream(device)

    def issue():
        item = next(blocks, None)
        if item is None:
            return None
        iwav0, block = item
        if not (torch.is_tensor(block) and block.is_pinned()):
            return iwav0, block, None
        with logs.span("ecckd.create_lut.copy"):
            return (iwav0, *_upload(block, device, side))

    ahead = issue()
    while ahead is not None:
        iwav0, od_block, copied = ahead
        if copied is None:
            _transfers["pageable"] += 1
            with logs.span("ecckd.create_lut.copy"):
                od_block = _to_device(od_block, device, dtype)
        else:
            _transfers["pinned"] += 1
            compute.wait_event(copied)
            # Allocated on the side stream, read on this one
            od_block.record_stream(compute)
            od_block = od_block.to(dtype=dtype)
        nb = od_block.shape[1]
        with logs.span("ecckd.create_lut.partials"):
            out = gpoint_block_partials(
                ng, gp[iwav0:iwav0 + nb], od_block,
                _to_device(weight_fn(iwav0, nb), device, dtype),
                averaging_method)
            stacked = torch.stack(list(out.values()))
        ahead = issue()
        with logs.span("ecckd.create_lut.partials"):
            part = dict(zip(out, stacked.cpu().numpy()))
        yield part


def _pageable_partials(blocks, ng, gp, weight_fn, averaging_method, device,
                       dtype):
    """The partials of each block of ``blocks``, in order, each block
    copied by :func:`_to_device` and read back before the next."""
    for iwav0, od_block in blocks:
        _transfers["pageable"] += 1
        nb = od_block.shape[1]
        yield _block_accumulate(ng, gp[iwav0:iwav0 + nb], od_block,
                                weight_fn(iwav0, nb), averaging_method,
                                device, dtype)


def _block_accumulate(ng, g_point_block, od_block, weight_block,
                      averaging_method, device=None, dtype=None):
    """Partial sums for one wavenumber block -> dict of (nz, ng) numpy
    arrays.  ``od_block`` and ``weight_block`` (numpy or tensors) go to
    ``device`` in ``dtype`` (by default where and how ``od_block`` lies);
    ``g_point_block`` must be on ``device`` already."""
    if device is not None:
        with logs.span("ecckd.create_lut.copy"):
            od_block = _to_device(od_block, device, dtype)
            weight_block = _to_device(weight_block, device, dtype)
    with logs.span("ecckd.create_lut.partials"):
        out = gpoint_block_partials(ng, g_point_block, od_block,
                                    weight_block, averaging_method)
        # One device->host copy for the whole (tiny) partials dict
        stacked = torch.stack(list(out.values())).cpu().numpy()
    return dict(zip(out, stacked))


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


def _combine(acc, part):
    """In-place combination of per-block partials: min/max by elementwise
    extremum, every other key by addition."""
    for key, v in part.items():
        if key == "min":
            acc[key] = np.minimum(acc[key], v)
        elif key == "max":
            acc[key] = np.maximum(acc[key], v)
        else:
            acc[key] = acc[key] + v
    return acc


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
    ops.average.average_od_to_gpoints, and its bits at the same block size.
    """
    from ..io.prefetch import prefetch_iter
    from ..tools.common import resolve_device
    if averaging_method not in GPOINT_AVERAGING_METHODS:
        raise ValueError(
            f"streaming averaging does not support {averaging_method!r}; "
            f"choose from {GPOINT_AVERAGING_METHODS}")
    device = resolve_device(device)
    gp = torch.as_tensor(g_point, device=device)
    acc = None
    pinned = device.type == "cuda"
    blocks = reader.iter_blocks(block_wav=block_wav)
    if pinned:
        blocks = _staged(blocks)
    # Two blocks read (and on the card staged) ahead on a background
    # thread: overlaps the reads, a ProfileBlocks' host widening and the
    # staging with the device's reduction
    blocks = _waited(prefetch_iter(logs.spawned_iter(blocks), depth=2))
    partials = _pinned_partials if pinned else _pageable_partials
    for part in partials(blocks, ng, gp, weight_fn, averaging_method,
                         device, dtype):
        acc = part if acc is None else _combine(acc, part)
    return finalize_gpoint_partials(acc, averaging_method,
                                    pressure_fl=pressure_fl)
