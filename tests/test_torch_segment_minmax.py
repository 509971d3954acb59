"""Kernel K4 (``csrc/segment_minmax.cu``): create_lut's per-(layer,
g-point) least and largest od of a block, and the benchmark's reader of
its counter.

This file imports no jax, so its card tests run on a machine without it:
``python -m pytest --noconftest -m gpu tests/test_torch_segment_minmax.py``.
Without a card those tests skip.  On the card K4 is held bit for bit
against the plain version, two ``scatter_reduce`` calls (amin, amax), on
the same card: layers 1, 50 and 54; g-points 1, 33, 64 and 256, some below
0 and some never used (their segments stay +inf / -inf); block widths that
are and are not whole 16-byte vectors and whole runs of a thread, from a
storage offset that leaves od off 16 bytes; float32 and float64, int32 and
int64 g-points; NaN.  The values are normal, so no segment holds both
zeros, whose sign K4 chooses where ``scatter_reduce``'s atomics do.
"""

import importlib

import numpy as np
import pytest
import torch

from ecckd_tpu_torch.ops import streaming
from ecckd_tpu_torch.ops.average import _segment_min_max
from ecckd_tpu_torch.ops.kernels import segment_min_max

DTYPES = (torch.float32, torch.float64)
INT = {torch.float32: torch.int32, torch.float64: torch.int64}


def _inputs(nz, nb, ng, dtype, device, seed=0, gdtype=torch.int64,
            unused=()):
    """(g_point, od): g-points in [-1, ng) (none in ``unused``), normal od
    of ``dtype``, both on ``device``."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-1, ng, nb)
    if len(unused):
        g = np.where(np.isin(g, unused), -1, g)
    od = rng.normal(0.0, 3.0, (nz, nb))
    return (torch.as_tensor(g, dtype=gdtype, device=device),
            torch.as_tensor(od, dtype=dtype, device=device))


def _bits(t):
    return t.cpu().view(INT[t.dtype])


def _assert_bits(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(_bits(a), _bits(b))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 is CUDA C++ and has no CPU mode")
    return torch.device("cuda")


# -- CPU: the wrapper's plain path and the benchmark's reader -------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nz,ng", [(1, 1), (5, 33), (3, 64)])
def test_cpu_wrapper_is_the_plain_version(nz, ng, dtype):
    """On CPU tensors the wrapper returns the plain version's bits, an
    unused g-point keeping +inf / -inf, and launches nothing."""
    g, od = _inputs(nz, 1001, ng, dtype, "cpu", unused=(0,))
    before = segment_min_max.launches
    got = segment_min_max(ng, g, od)
    assert segment_min_max.launches == before
    _assert_bits(got, _segment_min_max(ng, g, od))
    assert torch.all(got[0][:, 0] == float("inf"))
    assert torch.all(got[1][:, 0] == -float("inf"))


def _reader():
    from ckd_bench.harness import load_metric
    return load_metric("minmax_kernel_share")


def test_share_reader_without_the_counter(monkeypatch):
    """The reader finds nothing where the port has no K4 (as before it)
    or has reduced no block."""
    import sys
    monkeypatch.setitem(sys.modules,
                        "ecckd_tpu_torch.ops.kernels.segment_minmax", None)
    assert _reader().read(None) is None
    monkeypatch.undo()
    monkeypatch.setattr(streaming, "_transfers",
                        {"pinned": 0, "pageable": 0})
    assert _reader().read(None) is None


def test_share_reader_every_block_through_k4(monkeypatch):
    """Every streamed block, pinned or pageable, with one K4 launch: 100;
    half of them: 50."""
    monkeypatch.setattr(streaming, "_transfers",
                        {"pinned": 30, "pageable": 6})
    monkeypatch.setattr(segment_min_max, "launches", 36)
    assert _reader().read(None) == 100.0
    monkeypatch.setattr(segment_min_max, "launches", 18)
    assert _reader().read(None) == 50.0


def test_block_partials_take_the_wrapper(monkeypatch):
    """gpoint_block_partials takes its min and max from the wrapper."""
    average = importlib.import_module("ecckd_tpu_torch.ops.average")
    calls = []

    def spy(ng, g_point, od):
        calls.append(tuple(od.shape))
        return segment_min_max(ng, g_point, od)

    monkeypatch.setattr(average, "segment_min_max", spy)
    g, od = _inputs(4, 300, 6, torch.float64, "cpu")
    out = average.gpoint_block_partials(6, g, od, torch.ones_like(od),
                                        "transmission")
    assert calls == [(4, 300)]
    _assert_bits((out["min"], out["max"]), _segment_min_max(6, g, od))


# -- the card ----------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("nb", [65576, 65537])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ng", [1, 33, 64, 256])
@pytest.mark.parametrize("nz", [1, 50, 54])
def test_k4_is_scatter_reduce(cuda, nz, ng, dtype, nb):
    """K4 against scatter_reduce on the card, bit for bit; g-points 0 and
    ng - 1 (for ng > 2) never used; a launch counted."""
    unused = (0, ng - 1) if ng > 2 else ()
    g, od = _inputs(nz, nb, ng, dtype, cuda, seed=nz * 1000 + ng,
                    unused=unused)
    before = segment_min_max.launches
    got = segment_min_max(ng, g, od)
    torch.cuda.synchronize()
    assert segment_min_max.launches == before + 1
    _assert_bits(got, _segment_min_max(ng, g, od))
    if unused:
        assert torch.all(got[0][:, list(unused)].cpu() == float("inf"))
        assert torch.all(got[1][:, list(unused)].cpu() == -float("inf"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gdtype", [torch.int32, torch.int64])
def test_k4_off_16_bytes(cuda, dtype, gdtype):
    """od from a storage offset of one element, so its rows start off 16
    bytes, and int32 or int64 g-points: scatter_reduce's bits."""
    nz, nb, ng = 50, 40000, 33
    g, od = _inputs(nz, nb, ng, dtype, cuda, seed=5, gdtype=gdtype)
    store = torch.empty(nz * nb + 1, dtype=dtype, device=cuda)
    shifted = store[1:].view(nz, nb)
    shifted.copy_(od)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    _assert_bits(segment_min_max(ng, g, shifted),
                 _segment_min_max(ng, g, od))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_k4_nan_and_infinities(cuda, dtype):
    """A NaN makes both extremes of its segment NaN, and +/-inf values
    are extremes like any other: scatter_reduce's bits."""
    nz, nb, ng = 50, 20000, 33
    g, od = _inputs(nz, nb, ng, dtype, cuda, seed=9)
    od[3, 100] = float("nan")
    od[7, 2000:2010] = float("inf")
    od[8, 3000:3010] = -float("inf")
    got = segment_min_max(ng, g, od)
    _assert_bits(got, _segment_min_max(ng, g, od))
    j = int(g[100])
    if j >= 0:
        assert torch.isnan(got[0][3, j]) and torch.isnan(got[1][3, j])


@pytest.mark.gpu
def test_k4_repeats_and_empty_block(cuda):
    """The same bits at every launch; a block of no wavenumbers gives
    +inf / -inf everywhere."""
    g, od = _inputs(50, 1 << 18, 33, torch.float64, cuda, seed=3)
    first = segment_min_max(33, g, od)
    for _ in range(3):
        _assert_bits(segment_min_max(33, g, od), first)
    lo, hi = segment_min_max(33, g[:0], od[:, :0])
    assert torch.all(lo.cpu() == float("inf"))
    assert torch.all(hi.cpu() == -float("inf"))


@pytest.mark.gpu
def test_k4_refuses(cuda):
    """The wrapper raises on a non-contiguous od and on a dtype K4 does not
    take, and launches nothing."""
    g, od = _inputs(50, 4096, 33, torch.float64, cuda)
    before = segment_min_max.launches
    with pytest.raises(ValueError, match="contiguous"):
        segment_min_max(33, g[::2], od[:, ::2])
    with pytest.raises(TypeError, match="dtype"):
        segment_min_max(33, g, od.half())
    assert segment_min_max.launches == before
