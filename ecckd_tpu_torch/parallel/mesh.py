"""Meshes of logical shards and the collectives that combine them.

PyTorch counterpart of ``ecckd_tpu/parallel/mesh.py``.  The framework has
two scaling axes (SURVEY.md §5):

* ``spectral``, the wavenumber axis (up to ~5.6M points): every wavenumber
  is independent in the two-stream RT, so each shard reduces its own slice
  and the tiny partials are summed over the shards;
* ``data``, the training profiles of optimize_lut: each shard evaluates the
  cost of its profiles against a copy of the state, and the values and
  gradients are summed over the shards.

A :class:`Mesh` is a ``(data, spectral)`` grid of **logical shards**, each
with a :class:`torch.device`; two shards may share one device, so a mesh
of N > 1 shards exists on the CPU (the tests) and on one card.  The mesh is
built from an explicit list of devices and holds exactly the shards asked
for, or raises.  Under ``torch.distributed`` (world size > 1) the grid is
process-major, as JAX's mesh is: each process owns a contiguous block of
shards, the same number in every process, and computes only on its own.

Collectives (:meth:`Mesh.sum`, :meth:`Mesh.min`, :meth:`Mesh.max`) combine
one tensor per local shard pairwise in shard order, ``(s0 + s1) + (s2 +
s3)``, so that a repeat gives the same bits, then across processes with
``torch.distributed.all_reduce``: a power-of-two mesh split over two
processes then adds in the same order as one process.  On the gloo backend
a CUDA tensor is reduced through a host copy; the choice goes by backend,
never by catching a failure.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .distributed import process_count, process_index

AXES = ("data", "spectral")


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def split_rule(n: int, data_parallel: Optional[int] = None
               ) -> Tuple[int, int]:
    """``(data, spectral)`` sizes of a mesh of ``n`` shards: the JAX
    package's rule (``ecckd_tpu/parallel/mesh.py:39-66``), the largest
    power-of-two split not above sqrt(n) for ``data`` when it is not
    given."""
    if data_parallel is None:
        data_parallel = 1
        while (data_parallel * 2 <= n // (data_parallel * 2)
               and n % (data_parallel * 2) == 0):
            data_parallel *= 2
    if data_parallel < 1 or n % data_parallel:
        raise ValueError(f"{n} devices not divisible by data_parallel="
                         f"{data_parallel}")
    return data_parallel, n // data_parallel


class Mesh:
    """A ``(data, spectral)`` grid of logical shards.

    ``devices`` are this process's shards, in order; with ``process_count``
    processes the global grid holds ``process_count * len(devices)`` shards,
    process-major, reshaped ``(data, spectral)`` in C order as JAX reshapes
    its device list."""

    def __init__(self, devices: Sequence, data_parallel: int,
                 process_index: int = 0, process_count: int = 1):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.size = self.process_count * len(self.devices)
        data, spectral = split_rule(self.size, data_parallel)
        self.shape = {"data": data, "spectral": spectral}
        self.axis_names = AXES

    def __repr__(self):
        devices = [str(d) for d in self.devices]
        return (f"Mesh(data={self.shape['data']}, spectral="
                f"{self.shape['spectral']}, process {self.process_index} of "
                f"{self.process_count}, devices {devices})")

    @property
    def local_offset(self) -> int:
        """Global index of this process's first shard."""
        return self.process_index * len(self.devices)

    def local_shards(self) -> List[Tuple[int, torch.device]]:
        """(global shard index, device) of every shard of this process:
        the profile axis is split over all of them."""
        return [(self.local_offset + k, d)
                for k, d in enumerate(self.devices)]

    def spectral_shards(self) -> List[Tuple[int, torch.device]]:
        """(spectral index, device) of the wavenumber slices this process
        reduces.  In one process these are the shards of the first data row
        (the other rows would hold copies of the same slices); across
        processes the spectral axis must span every shard
        (``data_parallel=1``), so that each process's slices are a
        contiguous block of the axis, as JAX requires
        (``ecckd_tpu/partition/cost_kernel.py:209-216``)."""
        spectral = self.shape["spectral"]
        if self.process_count == 1:
            return [(j, self.devices[j]) for j in range(spectral)]
        if spectral != self.size:
            raise ValueError(
                "multi-controller sharded work needs the spectral mesh axis "
                "to span ALL shards (data_parallel=1), so each process's "
                "shards are a contiguous exclusive wavenumber slice; got "
                f"spectral={spectral} of {self.size} shards")
        return self.local_shards()

    # ------------------------------------------------------ collectives

    def _reduce(self, tensors, op, fold, device):
        tensors = list(tensors)
        if not tensors:
            raise ValueError("a collective needs one tensor per local shard")
        if device is None:
            device = tensors[0].device
        level = [t.to(device) for t in tensors]
        while len(level) > 1:
            level = [fold(*level[i:i + 2]) if i + 1 < len(level)
                     else level[i] for i in range(0, len(level), 2)]
        acc = level[0]
        if self.process_count > 1:
            # all_reduce may reduce in place: never into the caller's tensor
            acc = all_reduce(acc.clone() if len(tensors) == 1 else acc, op)
        return acc

    def sum(self, tensors, device=None):
        """Sum of one tensor per local shard, added pairwise in shard
        order, then over the processes; on ``device`` (by default the
        first tensor's)."""
        return self._reduce(tensors, "sum", torch.add, device)

    def min(self, tensors, device=None):
        return self._reduce(tensors, "min", torch.minimum, device)

    def max(self, tensors, device=None):
        return self._reduce(tensors, "max", torch.maximum, device)


def all_reduce(t, op="sum"):
    """``t`` reduced over the processes of ``torch.distributed``, on the
    backend's own side: a CUDA tensor goes through a host copy on gloo, a
    CPU tensor through a copy on this process's card on NCCL.  Returns the
    reduced tensor, on ``t``'s device."""
    import torch.distributed as dist
    rop = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}[op]
    backend = dist.get_backend()
    if backend == "gloo" and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host, op=rop)
        return host.to(t.device)
    if backend == "nccl" and t.device.type == "cpu":
        card = t.to(torch.device("cuda", torch.cuda.current_device()))
        dist.all_reduce(card, op=rop)
        return card.cpu()
    t = t.contiguous()
    dist.all_reduce(t, op=rop)
    return t


def _default_devices():
    """Every visible card in one process; this process's current card under
    ``torch.distributed``.  Raises where there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available; pass "
                           "devices=[...] (e.g. [torch.device('cpu')] * 8 "
                           "for logical CPU shards)")
    if process_count() > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None,
              data_parallel: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, spectral)`` mesh over ``devices`` (this process's
    shards; by default every visible card, or this process's card under
    ``torch.distributed``), the first ``n_devices`` of them where given.
    A device listed twice is two logical shards on it.  Across processes
    every process must list the same number of shards (checked with one
    collective)."""
    devices = list(_default_devices() if devices is None else devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: {n_devices} shards asked for, "
                             f"{len(devices)} devices given")
        devices = devices[:n_devices]
    pid, nproc = process_index(), process_count()
    if nproc > 1:
        counts = torch.tensor([len(devices), -len(devices)])
        counts = all_reduce(counts, "max")
        if counts[0] != -counts[1]:
            raise ValueError("make_mesh: the processes list different "
                             "numbers of shards")
    return Mesh(devices, data_parallel, pid, nproc)


# --------------------------------------------------- shard helpers

def spectral_slices(mesh: Mesh, n: int) -> List[Tuple[torch.device, int, int]]:
    """(device, offset, length) of the wavenumber slices of an axis of
    ``n`` this process reduces: the axis padded to the spectral multiple
    (the counterpart of ``spectral_sharding``)."""
    nloc = pad_to_multiple(n, mesh.shape["spectral"]) // mesh.shape["spectral"]
    return [(dev, j * nloc, nloc) for j, dev in mesh.spectral_shards()]


def slice_wavenumbers(a, offset: int, length: int, device=None,
                      pad_value=0):
    """``a[..., offset:offset + length]`` (numpy or tensor) as a contiguous
    tensor on ``device``, filled with ``pad_value`` past the end of
    ``a``'s last axis."""
    t = torch.as_tensor(a)
    n = t.shape[-1]
    stop = min(offset + length, n)
    part = t[..., offset:stop] if offset < n else t[..., n:n]
    if device is not None:
        part = part.to(device)
    if part.shape[-1] < length:
        fill = torch.full(t.shape[:-1] + (length - part.shape[-1],),
                          pad_value, dtype=t.dtype, device=part.device)
        part = torch.cat([part, fill], dim=-1)
    return part.contiguous()


def profile_slices(mesh: Mesh, ncol: int
                   ) -> List[Tuple[torch.device, np.ndarray, np.ndarray]]:
    """(device, profile indices, profile weights) of every shard of this
    process: the profile axis split over all shards of the mesh (the
    counterpart of ``profile_sharding``).  A count the shards do not divide
    is padded by repeating the last profile, with weight zero
    (``ecckd_tpu/optimize/solver.py:97-138``)."""
    npad = pad_to_multiple(ncol, mesh.size)
    per = npad // mesh.size
    index = np.minimum(np.arange(npad), ncol - 1)
    weight = (np.arange(npad) < ncol).astype(np.float64)
    return [(dev, index[g * per:(g + 1) * per], weight[g * per:(g + 1) * per])
            for g, dev in mesh.local_shards()]
