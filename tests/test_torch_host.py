"""The port's own copies of the JAX package's host modules agree with it.

``ecckd_tpu_torch`` keeps copies of ``constants``, ``config``, ``logs``,
``partition/equipartition.py`` and ``io`` instead of importing them; these
tests hold each copy to the original: the same constants, the same config
keys and values, the same equipartition bounds, g-point files that the
JAX package reads back as it reads its own, the same prefetch, shard
header and shard loader, and the same timer report.
(``io/lbl_fluxes.py`` is held to its original in
``tests/test_torch_optimize.py``.)
"""

import numpy as np
import pytest

import ecckd_tpu.constants as jconstants
import ecckd_tpu_torch.constants as tconstants
from ecckd_tpu.config import Config as JConfig
from ecckd_tpu.partition.equipartition import Equipartition as JEquipartition
from ecckd_tpu_torch.config import Config as TConfig
from ecckd_tpu_torch.partition.equipartition import (
    Equipartition as TEquipartition)

from test_config_io import SAMPLE


def test_constants_equal():
    names = sorted(n for n in vars(jconstants) if n.isupper())
    assert names == sorted(n for n in vars(tconstants) if n.isupper())
    assert len(names) > 10
    for n in names:
        assert getattr(tconstants, n) == getattr(jconstants, n), n


def _entries(cfg):
    return [(k, cfg.read_string(k), cfg.size(k)) for k in cfg.keys()]


@pytest.mark.parametrize("build", ["text", "args"])
def test_config_reads_the_same(tmp_path, build):
    """The sample of tests/test_config_io.py, from text and from a file
    with command-line overrides: the same keys, values and sizes, the same
    typed reads and the same provenance string."""
    if build == "text":
        j, t = JConfig.from_text(SAMPLE), TConfig.from_text(SAMPLE)
    else:
        p = tmp_path / "test.cfg"
        p.write_text(SAMPLE)
        argv = ["gases=h2o o3", "o3.input=alt.h5", "-quiet", str(p)]
        j, t = JConfig.from_args(argv), TConfig.from_args(argv)
    assert _entries(t) == _entries(j)
    assert t.sprint() == j.sprint()
    assert t.serialize() == j.serialize()
    for cfg in (j, t):
        assert cfg.read_floats("vector_value") == [1.0, 2.5, -3.0]
    assert t.read_strings("h2o.background_input") \
        == j.read_strings("h2o.background_input")
    assert _entries(t.section("h2o")) == _entries(j.section("h2o"))


def _ramp(base, npoints):
    """The synthetic ramp of tests/test_equipartition.py on either
    package's Equipartition."""
    class Ramp(base):
        def __init__(self):
            super().__init__()
            self.values = np.exp(np.linspace(-2.0, 10.0, npoints))

        def calc_error(self, bound1, bound2):
            i1 = int(np.ceil(bound1 * (npoints - 1)))
            i2 = int(np.floor(bound2 * (npoints - 1)))
            return abs(self.values[i1:i2 + 1].sum()
                       - (i2 - i1 + 1) * self.values[(i1 + i2) // 2])

    te = Ramp()
    te.set_partition_max_iterations(200)
    te.set_line_search_max_iterations(15)
    te.set_partition_tolerance(0.01)
    te.set_resolution(1.0 / npoints)
    return te


def test_equipartition_bounds_equal():
    results = []
    for base in (JEquipartition, TEquipartition):
        te = _ramp(base, 20000)
        bounds = np.linspace(0.0, 1.0, 17)
        error = np.zeros(16)
        status_n = te.equipartition_n(bounds, error)
        status_e, bounds_e, error_e = _ramp(base, 20000).equipartition_e(
            float(error[0]), 0.0, 1.0)
        results.append((status_n.name, bounds, error, status_e.name,
                        bounds_e, error_e))
    (jn, jb, je, jse, jbe, jee), (tn, tb, te_, tse, tbe, tee) = results
    assert (tn, tse) == (jn, jse)
    assert np.array_equal(tb, jb) and np.array_equal(te_, je)
    assert np.array_equal(tbe, jbe) and np.array_equal(tee, jee)
    assert len(tee) >= 8


def test_g_point_file_reads_back_through_jax_ncfile(tmp_path):
    """A two-gas LW g-point file written by the port's writer: the JAX
    package's NcFile sees the variables, values, dimension scales and
    attributes that were written."""
    h5py = pytest.importorskip("h5py")
    from ecckd_tpu.io import NcFile
    from ecckd_tpu_torch.partition import SingleGasData
    from ecckd_tpu_torch.tools.find_g_points import GPoints, write_g_points

    rng = np.random.default_rng(1)
    nwav = 40
    gases = []
    for m, r2 in (("h2o", [9, 19, 29, 39]), ("co2", [14, 39])):
        ng = len(r2)
        r1 = np.r_[0, np.asarray(r2[:-1]) + 1]
        g = SingleGasData(m, np.array([ng], np.int32), np.zeros(ng, np.int32),
                          r1.astype(np.int32), np.asarray(r2, np.int32),
                          rng.uniform(0, 1, ng), rng.uniform(0, 5, ng))
        g.store_g_points(np.arange(nwav))
        g.g_min = np.arange(5) % ng
        g.g_max = np.minimum(g.g_min + 1, ng - 1)
        gases.append(g)
    wav = np.linspace(100.0, 500.0, nwav)
    result = GPoints(gases, np.zeros(5, np.int16), np.arange(nwav) % 5,
                     np.array([100.0]), np.array([500.0]), wav)
    path = str(tmp_path / "g_points.h5")
    write_g_points(path, result, TConfig({"gases": "h2o co2"}),
                   ["find_g_points", "gases=h2o co2"])

    with NcFile(path) as f:
        assert f.read_scalar("n_gases") == 2
        np.testing.assert_array_equal(f.read("wavenumber"), wav)
        np.testing.assert_array_equal(f.read("g_point"), np.arange(nwav) % 5)
        for g in gases:
            m = g.molecule
            np.testing.assert_array_equal(f.read(f"{m}_rank1"), g.rank1)
            np.testing.assert_array_equal(f.read(f"{m}_rank2"), g.rank2)
            np.testing.assert_allclose(f.read(f"{m}_error"),
                                       g.error.astype(np.float32))
            np.testing.assert_array_equal(f.read(f"{m}_g_point"), g.g_point)
            assert f.attribute("long_name", f"{m}_rank1") \
                == f"Rank of first wavenumber for {m.upper()}"
        assert f.attribute("constituent_id") == "h2o co2"
        assert f.attribute("Conventions") == "CF-1.7"
        assert f.attribute("title").endswith("longwave CKD model")
        assert "find_g_points 'gases=h2o co2'" in f.attribute("history")
        assert f.attribute("config") == "gases={h2o co2}"
        assert f.attribute("units", "wavenumber") == "cm-1"
        assert "g_point" in f.names() and "h2o_g_point" in f.names()
    with h5py.File(path) as raw:
        # variables named as a dimension are stored under the netCDF-4
        # library's _nc4_non_coord_ prefix
        for var, dim in (("h2o_rank1", "h2o_g_point"),
                         ("band_number", "g_point"),
                         ("co2_n_g_points", "band"),
                         ("_nc4_non_coord_g_point", "wavenumber"),
                         ("_nc4_non_coord_co2_g_point", "wavenumber")):
            assert [s.name for s in raw[var].dims[0].values()] \
                == ["/" + dim], var
        for dim in ("band", "g_point", "h2o_g_point", "wavenumber"):
            assert raw[dim].attrs["CLASS"] == b"DIMENSION_SCALE", dim


def test_spectrum_shards_not_read(tmp_path):
    """A .spbin path goes to the port's shard reader, never to NetCDF: a
    shard that is not there raises FileNotFoundError from the native
    loader, and a file that is not a shard raises ValueError, neither
    falling back to another reader."""
    from ecckd_tpu_torch.io import read_spectrum
    with pytest.raises(FileNotFoundError):
        read_spectrum(str(tmp_path / "ckdmip_h2o_000.spbin"), 0)
    fake = tmp_path / "fake_000.spbin"
    fake.write_bytes(b"\x04\x00\x00\x00\x00\x00\x00\x00{}  ")
    with pytest.raises(ValueError, match="not a spectral shard"):
        read_spectrum(str(fake), 0)


def test_prefetch_and_shard_copies_equal_their_originals(tmp_path):
    """io/prefetch.py's prefetch_iter, the shard format's magic and header
    and csrc/shardloader.cpp's code are the JAX package's: the same
    source, the same header bytes for the same spectrum, the same C++
    below the file's comment."""
    import inspect
    from pathlib import Path
    import ecckd_tpu.io.prefetch as jprefetch
    import ecckd_tpu.io.shards as jshards
    import ecckd_tpu_torch.io.prefetch as tprefetch
    import ecckd_tpu_torch.io.shards as tshards
    from ecckd_tpu_torch.io.spectrum import Spectrum
    assert inspect.getsource(tprefetch.prefetch_iter) \
        == inspect.getsource(jprefetch.prefetch_iter)
    assert tshards._MAGIC == jshards._MAGIC == "ecckd_tpu-spbin-v1"
    nlay, nwav = 3, 16
    sp = Spectrum(np.linspace(100.0, 1e5, nlay + 1),
                  np.linspace(200.0, 280.0, nlay + 1),
                  np.linspace(1.0, 20.0, nwav), np.ones(nwav),
                  np.arange(nlay * nwav, dtype=float).reshape(nlay, nwav),
                  "h2o", 0.01, np.full(nlay, 0.01))
    heads = []
    for mod in (tshards, jshards):
        path = mod.write_shard(str(tmp_path / f"{mod.__name__}.spbin"), sp)
        raw = Path(path).read_bytes()
        hlen = int.from_bytes(raw[:8], "little")
        heads.append(raw[:8 + hlen])
    assert heads[0] == heads[1]
    root = Path(__file__).resolve().parents[1]
    code = [(root / p).read_text().split("#include <atomic>", 1)[1]
            for p in ("csrc/shardloader.cpp",
                      "ecckd_tpu_torch/csrc/shardloader.cpp")]
    assert code[0] == code[1]


def test_timer_reports_the_same(monkeypatch):
    """logs.Timer and logs.timed (the solver's split of device cost and
    gradient from host minimizer time): the same totals and report as the
    JAX package's on the same clock."""
    import time
    import ecckd_tpu.logs as jlogs
    import ecckd_tpu_torch.logs as tlogs
    out = []
    for mod in (jlogs, tlogs):
        ticks = iter([0.0, 1.5, 2.0, 4.25, 5.0, 6.0, 6.5, 7.0])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        timer = mod.Timer()
        timer.start("minimizer")
        timer.start("cost function + gradient (device)")
        timer.stop()
        timer.start("minimizer")
        with mod.timed(timer, "cost function + gradient (device)"):
            pass
        timer.start("minimizer")
        report = timer.report()
        out.append((timer.total("minimizer"),
                    timer.total("cost function + gradient (device)"),
                    report))
    assert out[1] == out[0]
    assert out[1][:2] == (1.5 + 0.75 + 0.5, 0.5 + 1.0)
