"""Wavenumber-sharded g-point averaging over a mesh.

PyTorch counterpart of ``ecckd_tpu/parallel/sharded_average.py``: the
multi-shard form of :func:`~ecckd_tpu_torch.ops.streaming.
average_od_to_gpoints`.  The wavenumber axis of a block is split over
the mesh's spectral shards (padded to their multiple, padded wavenumbers
in g-point -1); every shard reduces its slice on its device into
per-g-point partials
(:func:`~ecckd_tpu_torch.ops.average.gpoint_block_partials`), and the
partials are combined over the shards and processes by the mesh's
collectives: sums added, ``min``/``max`` by extremum, three collectives
a block.  The blocks run on the port's one block loop
(:func:`~ecckd_tpu_torch.ops.streaming.fold_blocks`), each taken as it
lies, since the shards move it themselves: the (nz, ng) partials are
read back in one copy a block and combine across blocks on the host
(:func:`~ecckd_tpu_torch.ops.average.combine_partials`), so streaming
and sharding compose, and :func:`~ecckd_tpu_torch.ops.average.
finalize_gpoint_partials` applies the final transform.  All eight
averaging methods are supported.

Four entry points, as in the JAX package: dense and streamed, each in one
process or with every process passing its own contiguous wavenumber slice
(multi-controller, ``torch.distributed``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.average import (GPOINT_AVERAGING_METHODS, finalize_gpoint_partials,
                           gpoint_block_partials)
from ..ops.streaming import fold_blocks, to_device
from .mesh import pad_to_multiple, slice_wavenumbers

SUPPORTED_METHODS = GPOINT_AVERAGING_METHODS


def _check_method(averaging_method: str):
    if averaging_method not in SUPPORTED_METHODS:
        raise ValueError(
            f"sharded averaging does not support {averaging_method!r}; "
            f"choose from {SUPPORTED_METHODS}")


def _local_partials(mesh, ng, g_point, od, weight, averaging_method, dtype):
    """The mesh-combined partials (dict of (nz, ng) tensors on the first
    shard's device) of this process's wavenumbers ``od`` (nz, nb), split
    evenly over its spectral shards; every process calls it with the same
    ``nb``."""
    shards = mesh.spectral_shards()
    od = torch.as_tensor(od)
    nz, nb = od.shape
    w = torch.broadcast_to(torch.as_tensor(weight), od.shape)
    gp = torch.as_tensor(np.asarray(g_point, np.int64)
                         if not torch.is_tensor(g_point) else g_point)
    nloc = pad_to_multiple(nb, len(shards)) // len(shards)
    parts = []
    for k, (_, dev) in enumerate(shards):
        sl = (k * nloc, nloc, dev)
        parts.append(gpoint_block_partials(
            ng, slice_wavenumbers(gp, *sl, pad_value=-1),
            to_device(slice_wavenumbers(od, *sl), dev, dtype),
            to_device(slice_wavenumbers(w, *sl), dev, dtype),
            averaging_method))
    sums = [k for k in parts[0] if k not in ("min", "max")]
    stacked = mesh.sum([torch.stack([p[k] for k in sums]) for p in parts])
    out = dict(zip(sums, stacked))
    out["min"] = mesh.min([p["min"] for p in parts])
    out["max"] = mesh.max([p["max"] for p in parts])
    return out


def _global_partials(mesh, ng, g_point, od, weight, averaging_method, dtype):
    """Partials of a block every process holds whole: each process reduces
    the slice of its own spectral shards (one process: all of them)."""
    od = torch.as_tensor(od)
    nb = od.shape[-1]
    nspec = mesh.shape["spectral"]
    nloc = pad_to_multiple(nb, nspec) // nspec
    shards = mesh.spectral_shards()
    j0 = shards[0][0]
    lo, length = j0 * nloc, len(shards) * nloc
    w = torch.broadcast_to(torch.as_tensor(weight), od.shape)
    gp = torch.as_tensor(np.asarray(g_point, np.int64)
                         if not torch.is_tensor(g_point) else g_point)
    return _local_partials(
        mesh, ng, slice_wavenumbers(gp, lo, length, pad_value=-1),
        slice_wavenumbers(od, lo, length), slice_wavenumbers(w, lo, length),
        averaging_method, dtype)


def sharded_average_od_to_gpoints(mesh, ng: int, g_point, optical_depth,
                                  weight, averaging_method: str,
                                  axis: str = "spectral", pressure_fl=None,
                                  dtype=torch.float64, finalize=True
                                  ) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """Average spectral od into g-points with the wavenumber axis split
    over the mesh's spectral shards.

    Args:
      mesh: a :class:`~.mesh.Mesh`; ``axis`` must be "spectral".
      ng: number of g-points.
      g_point: (nwav,) int map wavenumber -> g-point (<0 = unassigned).
      optical_depth: (nz, nwav); weight: (nwav,) or (nz, nwav).
      averaging_method: any of ops.average.GPOINT_AVERAGING_METHODS.
      pressure_fl: (nz,) full-level pressure (hybrid method only).
      dtype: the shards' float type.
      finalize: False returns the combined partials (a dict of (nz, ng)
        numpy arrays) instead; so do the other three entry points.

    Returns:
      (od_fit, min_od, max_od), each (nz, ng) numpy: the semantics of
      ops.average.average_od_to_gpoints.
    """
    _check_method(averaging_method)
    _check_axis(axis)
    acc = fold_blocks([(0, optical_depth)], lambda _, od: _global_partials(
        mesh, ng, g_point, od, weight, averaging_method, dtype))
    return _finish(acc, averaging_method, pressure_fl, finalize)


def streaming_sharded_average_od_to_gpoints(mesh, reader, ng: int, g_point,
                                            weight_fn, averaging_method: str,
                                            block_wav: int = 1 << 20,
                                            axis: str = "spectral",
                                            pressure_fl=None,
                                            dtype=torch.float64,
                                            finalize=True
                                            ) -> Tuple[np.ndarray,
                                                       np.ndarray,
                                                       np.ndarray]:
    """Streamed and sharded averaging: the host streams wavenumber blocks
    (``reader.iter_blocks(block_wav=...)``), each block is split over the
    spectral shards and reduced with the mesh's collectives, and the
    (nz, ng) partials accumulate on the host across blocks, as in the
    one-device streaming path.  ``weight_fn(iwav0, nb)`` gives a block's
    weights."""
    _check_method(averaging_method)
    _check_axis(axis)

    def reduce(iwav0, od_block):
        nb = od_block.shape[1]
        return _global_partials(mesh, ng, g_point[iwav0:iwav0 + nb],
                                od_block, weight_fn(iwav0, nb),
                                averaging_method, dtype)

    acc = fold_blocks(reader.iter_blocks(block_wav=block_wav), reduce)
    return _finish(acc, averaging_method, pressure_fl, finalize)


def sharded_average_od_to_gpoints_multihost(mesh, ng: int, g_point_local,
                                            od_local, weight_local,
                                            averaging_method: str,
                                            axis: str = "spectral",
                                            pressure_fl=None,
                                            dtype=torch.float64,
                                            finalize=True
                                            ) -> Tuple[np.ndarray,
                                                       np.ndarray,
                                                       np.ndarray]:
    """Multi-controller form: every process passes only its own contiguous
    wavenumber slice (``local_shard_range``), of the same length in every
    process; the slice is split over the process's spectral shards and the
    partials are combined over all of them.  The spectral axis must span
    every shard (``data_parallel=1``)."""
    _check_method(averaging_method)
    _check_axis(axis)
    acc = fold_blocks([(0, od_local)], lambda _, od: _local_partials(
        mesh, ng, g_point_local, od, weight_local, averaging_method, dtype))
    return _finish(acc, averaging_method, pressure_fl, finalize)


def streaming_sharded_average_od_to_gpoints_multihost(
        mesh, ng: int, g_point_local, read_block_local, nwav_local: int,
        weight_fn, averaging_method: str, block_wav: int = 1 << 20,
        axis: str = "spectral", pressure_fl=None, dtype=torch.float64,
        finalize=True) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Multi-controller streamed and sharded averaging: per round every
    process reads one block of its own slice (``read_block_local(iwav0,
    nb)`` -> (nz, nb), local indices), splits it over its spectral shards,
    and the partials are combined over every shard of every process and
    accumulated on the host across rounds.  Every process must pass the
    same ``nwav_local`` and ``block_wav`` (the collectives need the same
    rounds); ``g_point_local`` and ``weight_fn`` take local indices."""
    _check_method(averaging_method)
    _check_axis(axis)
    mesh.spectral_shards()      # raises unless the axis spans every shard

    def reduce(i0, od_block):
        nb = od_block.shape[1]
        return _local_partials(mesh, ng, g_point_local[i0:i0 + nb], od_block,
                               weight_fn(i0, nb), averaging_method, dtype)

    blocks = ((i0, read_block_local(i0, min(block_wav, nwav_local - i0)))
              for i0 in range(0, nwav_local, block_wav))
    acc = fold_blocks(blocks, reduce)
    return _finish(acc, averaging_method, pressure_fl, finalize)


def _finish(acc, averaging_method, pressure_fl, finalize):
    if not finalize:
        return acc
    return finalize_gpoint_partials(acc, averaging_method,
                                    pressure_fl=pressure_fl)


def _check_axis(axis):
    if axis != "spectral":
        raise ValueError(f"sharded averaging shards the spectral axis, not "
                         f"{axis!r}")
