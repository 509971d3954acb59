"""The per-wavenumber g-point maps of ``partition/gas_data.py``: each
gas's map (``SingleGasData.store_g_points``, a gather of a table over
ranks) and the merged map (``merged_g_point_map``, a gather of a table
over the tuples of per-gas g-points that occur), held element for element,
dtype and length to the plain loops they replace (one masked pass over the
wavenumbers a g-point, and one a merged g-point and gas), copied here as
``plain_store`` and ``plain_merged``, warnings and all; and ``map_counts()``
counting one pass a store and one a gas a merged map.  On the card (marker
``gpu``, skipped here; ``python -m pytest --noconftest -m gpu
tests/test_torch_gas_maps.py``) the card's maps at 2^22 wavenumbers equal
the CPU's.
"""

import numpy as np
import pytest
import torch

from ecckd_tpu_torch.partition import gas_data
from ecckd_tpu_torch.partition.gas_data import (SingleGasData,
                                                merged_g_point_map)


def plain_store(rank, rank1, rank2):
    """Each gas's map as one masked pass a g-point: the later wins."""
    g_point = np.full(rank.max() + 1, -1, np.int32)
    for ig in range(len(rank1)):
        g_point[(rank >= rank1[ig]) & (rank <= rank2[ig])] = ig
    return g_point


def plain_merged(gases, ng, nwav, warn):
    """The merged map as one masked pass a (merged g-point, gas) pair."""
    g_point = np.full(nwav, -1, np.int32)
    for ig in range(ng):
        is_found = np.ones(nwav, bool)
        for g in gases:
            is_found &= ((g.g_point >= g.g_min[ig])
                         & (g.g_point <= g.g_max[ig]))
        if not np.any(is_found):
            warn(f"g point {ig} occupies none of the spectrum")
        g_point[is_found] = ig
    n_unassigned = int(np.sum(g_point == -1))
    if n_unassigned:
        warn(f"{n_unassigned} wavenumbers are not assigned to a g point")
    return g_point


@pytest.fixture
def warned(monkeypatch):
    said = []
    monkeypatch.setattr(gas_data.logs, "warning", said.append)
    return said


def _gas(rank1, rank2, name="gas"):
    ng = len(rank1)
    return SingleGasData(
        molecule=name, n_g_points=np.array([ng], np.int64),
        band_number=np.zeros(ng, np.int32),
        rank1=np.asarray(rank1, np.int64), rank2=np.asarray(rank2, np.int64),
        error=np.ones(ng), sorting_variable=np.arange(ng, dtype=float))


NWAV = 200
STORE_CASES = {
    "tiled": ([0, 50, 120], [49, 119, 199]),
    "overlapping": ([0, 40, 30, 150], [100, 60, 35, 199]),
    "empty": ([0, 90, 100], [99, 80, 199]),
    "negative_rank1": ([-20, 10], [9, 199]),
    "negative_rank2": ([-30, -5, 0], [-10, -1, 150]),
    "beyond_largest": ([0, 180], [179, 500]),
}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_is_the_plain_loop(case):
    rank1, rank2 = STORE_CASES[case]
    rank = np.random.default_rng(len(case)).permutation(NWAV)
    gas = _gas(rank1, rank2)
    gas.store_g_points(rank)
    want = plain_store(rank, gas.rank1, gas.rank2)
    assert gas.g_point.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(gas.g_point, want)
    assert (gas.g_point == -1).any() == (case in ("overlapping",
                                                  "negative_rank2"))


def _random_gases(ngas, ng, nwav, seed, holes=True):
    """``ngas`` gases of ``ng`` g-points each over one shuffled band, with
    ranks no interval holds (maps holding -1) where ``holes``, and merged
    ranges drawn at random: some cover nothing, some leave wavenumbers
    unassigned."""
    rng = np.random.default_rng(seed)
    gases = []
    for k in range(ngas):
        cuts = np.sort(rng.choice(np.arange(1, nwav), ng - 1, replace=False))
        rank1, rank2 = np.r_[0, cuts], np.r_[cuts - 1, nwav - 1]
        if holes:
            drop = rng.random(ng) < 0.3
            drop[0] = True
            rank2 = rank2 - drop * (rank2 > rank1)
        g = _gas(rank1, rank2, f"gas{k}")
        g.store_g_points(rng.permutation(nwav))
        gases.append(g)
    return gases


def _ranges(gases, nmerged, seed):
    rng = np.random.default_rng(seed)
    for g in gases:
        a, b = rng.integers(0, g.ng(), (2, nmerged))
        g.g_min, g.g_max = (np.minimum(a, b).astype(np.int32),
                            np.maximum(a, b).astype(np.int32))


def _held_to_plain(gases, ng, nwav, warned):
    got = merged_g_point_map(gases, ng, nwav)
    said = list(warned)
    warned.clear()
    want = plain_merged(gases, ng, nwav, warned.append)
    assert got.dtype == want.dtype == np.int32 and got.shape == (nwav,)
    np.testing.assert_array_equal(got, want)
    assert said == warned
    return got, said


@pytest.mark.parametrize("ngas", [1, 2, 3, 7])
def test_merged_is_the_plain_loop(ngas, warned):
    nwav, ng = 3000, 12
    gases = _random_gases(ngas, 5, nwav, seed=ngas)
    assert all((g.g_point == -1).any() for g in gases)
    _ranges(gases, ng, seed=10 + ngas)
    _held_to_plain(gases, ng, nwav, warned)


def test_merged_point_that_covers_nothing_warns(warned):
    nwav = 1000
    gases = _random_gases(2, 4, nwav, seed=5, holes=False)
    # Gas 1 keeps no wavenumber at g-point 0, which merged point 1 alone
    # asks of it
    gases[1].g_point[gases[1].g_point == 0] = 1
    for g, lo, hi in ((gases[0], [0, 3, 0], [3, 3, 3]),
                      (gases[1], [1, 0, 1], [3, 0, 3])):
        g.g_min, g.g_max = np.array(lo, np.int32), np.array(hi, np.int32)
    got, said = _held_to_plain(gases, 3, nwav, warned)
    assert said == ["g point 1 occupies none of the spectrum"]
    assert not (got == 1).any()


def test_unassigned_wavenumbers_are_counted(warned):
    nwav = 1000
    gases = _random_gases(3, 4, nwav, seed=8)
    for g in gases:
        g.g_min, g.g_max = np.zeros(2, np.int32), np.array([1, 2], np.int32)
    got, said = _held_to_plain(gases, 2, nwav, warned)
    n = int((got == -1).sum())
    assert n > 0 and said == [f"{n} wavenumbers are not assigned to a "
                              "g point"]


def test_twelve_gases_of_64_g_points(warned):
    """(64 + 2)^12 tuples overflow int64: the ids stay compact."""
    nwav, ng = 20000, 40
    assert 66 ** 12 > np.iinfo(np.int64).max
    gases = _random_gases(12, 64, nwav, seed=12)
    _ranges(gases, ng, seed=13)
    # Wide ranges, so that some merged points hold wavenumbers
    for g in gases:
        g.g_min[::2], g.g_max[::2] = 0, 63
    got, _ = _held_to_plain(gases, ng, nwav, warned)
    assert (got >= 0).any()


def test_map_counts(warned):
    gases = _random_gases(3, 6, 500, seed=1)
    _ranges(gases, 8, seed=2)
    gas_data.reset_map_counts()
    gases[0].store_g_points(np.arange(500))
    gases[1].store_g_points(np.arange(500))
    assert gas_data.map_counts() == {"store": 2, "merged": 0}
    merged_g_point_map(gases, 8, 500)
    merged_g_point_map(gases[:2], 8, 500)
    assert gas_data.map_counts() == {"store": 2, "merged": 5}
    gas_data.reset_map_counts()
    assert gas_data.map_counts() == {"store": 0, "merged": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the maps' tables on the device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_maps_are_the_cpus(cuda, warned):
    nwav, ng = 1 << 22, 32
    gases = _random_gases(7, 8, nwav, seed=22)
    _ranges(gases, ng, seed=23)
    rng = np.random.default_rng(24)
    for g in gases:
        rank = rng.permutation(nwav)
        g.store_g_points(rank, cuda)
        on_card = g.g_point
        g.store_g_points(rank)
        np.testing.assert_array_equal(on_card, g.g_point)
        assert on_card.dtype == np.int32
    on_card = merged_g_point_map(gases, ng, nwav, cuda)
    said = list(warned)
    warned.clear()
    np.testing.assert_array_equal(on_card,
                                  merged_g_point_map(gases, ng, nwav))
    assert on_card.dtype == np.int32 and said == warned
