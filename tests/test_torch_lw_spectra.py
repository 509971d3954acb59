"""lw_spectra in the port against the JAX tool, on the CPU in float64.

As tests/test_aux_tools.py:63-112: the file tool at full resolution for
every profile and for one, and the block-wise g-point collapse at two
block sizes, each file held to the JAX tool's (same variables, shapes,
types and attributes; values within 1e-10, which for the float32
variables on disk means the same float32 values).  The array core is
held in float64 to the JAX package's functions (1e-10 normwise), and
chip_smoke.py's LW training fluxes, which now come from the core, to the
recipe it used before (planck_function and rt_lw over the whole spectrum,
summed per g-point) at 1e-12.
"""

import os
import sys

import numpy as np
import pytest
import torch

from ecckd_tpu.config import Config as JConfig
from ecckd_tpu.io import NcFile, NcWriter
from ecckd_tpu.io.spectrum import open_merged_spectrum_profile as jopen
from ecckd_tpu.ops import planck_function as jplanck
from ecckd_tpu.ops import rt_lw as jrt_lw
from ecckd_tpu.tools.lw_spectra import _gpoint_profile_blockwise
from ecckd_tpu.tools.lw_spectra import lw_spectra as jlw_spectra
from ecckd_tpu_torch.config import Config
from ecckd_tpu_torch.io.shards import convert_spectrum_file
from ecckd_tpu_torch.io.spectrum import (Spectrum,
                                         open_merged_spectrum_profile,
                                         read_spectrum, spectrum_blocks)
from ecckd_tpu_torch.ops import streaming
from ecckd_tpu_torch.tools.lw_spectra import lw_spectra, lw_spectra_core
from synth import synth_spectrum_file
from test_torch_pinned_streaming import SOURCES, block_sources
from test_torch_pipeline import _assert_same_schema

FIELDS = ("flux_dn", "flux_up", "spectral_flux_dn", "spectral_flux_up",
          "optical_depth")


@pytest.fixture(scope="module")
def spectra(tmp_path_factory):
    d = tmp_path_factory.mktemp("lw_spectra")
    h2o = synth_spectrum_file(str(d / "h2o.h5"), molecule="h2o",
                              nwav=512, ncol=3, seed=3)
    thin = synth_spectrum_file(str(d / "h2o_thin.h5"), molecule="h2o",
                               nwav=512, ncol=1, seed=3, od_scale=1e-3)
    o3 = synth_spectrum_file(str(d / "o3.h5"), molecule="o3", nwav=512,
                             ncol=3, seed=7, vmr_value=1e-6)
    nwav, ng = 512, 4
    gp = np.repeat(np.arange(ng), nwav // ng)
    gfile = str(d / "gp.h5")
    with NcWriter(gfile) as w:
        w.define_dimension("wavenumber", nwav)
        w.define_variable("g_point", "short", "wavenumber")
        w.write(gp.astype(np.int16), "g_point")
    return dict(d=d, h2o=h2o, thin=thin, o3=o3, gfile=gfile, g_point=gp,
                ng=ng)


def _both(spectra, name, keys):
    """The JAX tool's and the port's output files for the same keys."""
    out = []
    for tag, tool, extra in (("jax", jlw_spectra, None),
                             ("torch", lw_spectra, {"device": "cpu"})):
        path = str(spectra["d"] / f"{name}_{tag}.h5")
        cfg = {"output": path, **keys}
        if extra:
            tool(Config({**cfg, **extra}), argv=["lw_spectra"])
        else:
            tool(JConfig(cfg), argv=["lw_spectra"])
        out.append(path)
    return out


def _assert_same_file(jpath, tpath):
    with NcFile(jpath) as a, NcFile(tpath) as b:
        assert sorted(a.names()) == sorted(b.names())
        for name in a.names():
            va, vb = np.asarray(a.read(name)), np.asarray(b.read(name))
            assert va.shape == vb.shape, name
            if va.dtype.kind == "f" and va.size:
                np.testing.assert_allclose(vb, va, rtol=1e-10,
                                           atol=1e-10 * np.abs(va).max(),
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(vb, va, name)
        assert b.attribute("molecules") == a.attribute("molecules")
    _assert_same_schema(jpath, tpath)


@pytest.mark.parametrize("name,keys", [
    ("full", lambda s: {"input": s["h2o"]}),
    ("single", lambda s: {"input": s["h2o"], "iprofile": "1"}),
    ("merged", lambda s: {"input": f"{s['h2o']} {s['o3']}",
                          "scaling": "1.0 2.0", "iprofile": "2"}),
])
def test_full_resolution(spectra, name, keys):
    jpath, tpath = _both(spectra, name, keys(spectra))
    _assert_same_file(jpath, tpath)
    with NcFile(tpath) as f:
        fd = f.read("flux_dn_lw")
        assert fd.shape[0] == (3 if name == "full" else 1)
        np.testing.assert_allclose(fd, f.read("spectral_flux_dn_lw").sum(-1),
                                   rtol=1e-5)
        assert np.all(fd[:, 0] == 0.0)    # no downwelling at TOA


@pytest.mark.parametrize("block", ["100", "512"])
def test_gpoint_collapse_blockwise(spectra, block):
    """The g-point-collapsed branch streams wavenumber blocks: the JAX
    tool's file at the same block size."""
    jpath, tpath = _both(spectra, f"g_{block}", {
        "input": spectra["thin"], "iprofile": "0",
        "gpoints": spectra["gfile"], "streaming_block_wav": block})
    _assert_same_file(jpath, tpath)


@pytest.mark.parametrize("block", [100, 512])
@pytest.mark.parametrize("gpoints", [False, True])
def test_core_matches_jax(spectra, block, gpoints):
    """lw_spectra_core against the JAX package in float64: the g-point
    mode against its ``_gpoint_profile_blockwise``, the full mode against
    its Planck function and rt_lw over the whole spectrum."""
    cfg = {"input": f"{spectra['thin']}"}
    with open_merged_spectrum_profile(Config(cfg), 0) as pb:
        got = lw_spectra_core(pb, spectra["g_point"] if gpoints else None,
                              block_wav=block, device="cpu")
    with jopen(JConfig(cfg), 0) as pb:
        if gpoints:
            want = _gpoint_profile_blockwise(pb, spectra["g_point"],
                                             spectra["ng"], jplanck, jrt_lw,
                                             block)
        else:
            sp = pb.materialize()
            planck = jplanck(sp.temperature_hl, sp.wavenumber,
                             sp.d_wavenumber)
            fd, fu = map(np.asarray, jrt_lw(planck, sp.optical_depth,
                                            np.ones(len(sp.wavenumber)),
                                            planck[-1]))
            want = (fd.sum(1), fu.sum(1), fd, fu, sp.optical_depth)
    for g, w in zip((got.flux_dn, got.flux_up, got.spectral_flux_dn,
                     got.spectral_flux_up, got.optical_depth), want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.linalg.norm(g - w) <= 1e-10 * np.linalg.norm(w)


def test_shard_input_equals_netcdf(spectra, tmp_path):
    """The file tool on a float64 shard of the spectrum writes the file it
    writes from the NetCDF original."""
    shard = convert_spectrum_file(spectra["h2o"], str(tmp_path / "h2o"),
                                  dtype=np.float64)[0]
    outs = []
    for tag, spec in (("nc", spectra["h2o"]), ("spbin", shard)):
        path = str(tmp_path / f"lbl_{tag}.h5")
        lw_spectra(Config({"output": path, "input": spec, "device": "cpu",
                           "gpoints": spectra["gfile"]}), argv=["l"])
        outs.append(path)
    with NcFile(outs[0]) as a, NcFile(outs[1]) as b:
        assert b.read("flux_dn_lw").shape[0] == 3
        for name in ("flux_dn_lw", "flux_up_lw", "spectral_flux_dn_lw",
                     "spectral_flux_up_lw", "optical_depth", "vmr_fl"):
            np.testing.assert_array_equal(a.read(name), b.read(name), name)


def test_chip_smoke_lw_training_fluxes_as_before(spectra):
    """chip_smoke.py's LW training fluxes, now from lw_spectra_core, equal
    the recipe it used before within 1e-12: the Planck function and rt_lw
    over each profile's whole spectrum, summed over it and per g-point."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from ecckd_tpu_torch.ops import planck_function, rt_lw
    profiles = [read_spectrum(spectra["h2o"], i) for i in range(3)]
    gp, ng = spectra["g_point"], spectra["ng"]
    lbl = chip_smoke.training_fluxes(profiles, gp, ng, torch.device("cpu"))
    onehot = torch.as_tensor(gp[:, None] == np.arange(ng)[None, :]).double()
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    for i, sp in enumerate(profiles):
        planck = planck_function(f(sp.temperature_hl), f(sp.wavenumber),
                                 f(sp.d_wavenumber))
        fd, fu = rt_lw(planck, f(sp.optical_depth),
                       torch.ones_like(planck[0]), planck[-1])
        for got, want in ((lbl.flux_dn[i], fd.sum(-1)),
                          (lbl.flux_up[i], fu.sum(-1)),
                          (lbl.spectral_flux_dn[i], fd @ onehot),
                          (lbl.spectral_flux_up[i], fu @ onehot)):
            want = want.numpy()
            assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)


def test_core_on_arrays_and_device_default(spectra):
    """spectrum_blocks feeds the core from arrays in memory; the core runs
    on the card unless asked for the CPU."""
    sp = read_spectrum(spectra["thin"], 0)
    a = lw_spectra_core(spectrum_blocks(sp), spectra["g_point"],
                        block_wav=200, device="cpu")
    with open_merged_spectrum_profile(Config({"input": spectra["thin"]}),
                                      0) as pb:
        b = lw_spectra_core(pb, spectra["g_point"], block_wav=200,
                            device="cpu")
    for name in ("flux_dn", "spectral_flux_up", "optical_depth"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            lw_spectra_core(spectrum_blocks(sp))


class _Staged:
    """A block source with its blocks staged as the card's prefetch thread
    stages them (here unpinned)."""

    def __init__(self, source):
        self.source = source

    def __getattr__(self, name):
        return getattr(self.source, name)

    def iter_blocks(self, block_wav):
        for i0, b in self.source.iter_blocks(block_wav=block_wav):
            yield i0, streaming._stage(b, pin_memory=False)


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("kind", SOURCES)
@pytest.mark.parametrize("gpoints", [False, True])
def test_core_on_block_sources(tmp_path, gpoints, kind, staged):
    """lw_spectra_core on a profile in blocks of 300 (the last short), from
    arrays and from float64 and float32 shards, as read or staged: the core
    on the arrays of the same od bit for bit, and the JAX package within
    1e-10 normwise (its blockwise g-point collapse, or its Planck function
    and rt_lw over the whole spectrum)."""
    nwav, ng = 1000, 5
    sp, source = block_sources(tmp_path, nlay=6, nwav=nwav, seed=5)
    reader, od = source(kind)
    sp = Spectrum(sp.pressure_hl, sp.temperature_hl, sp.wavenumber,
                  sp.d_wavenumber, od.astype(np.float64))
    g_point = (np.random.default_rng(6).integers(0, ng, nwav) if gpoints
               else None)
    with reader:
        got = lw_spectra_core(_Staged(reader) if staged else reader, g_point,
                              block_wav=300, device="cpu")
    want = lw_spectra_core(spectrum_blocks(sp), g_point, block_wav=300,
                           device="cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), name)
    if gpoints:
        jax_out = _gpoint_profile_blockwise(spectrum_blocks(sp), g_point,
                                            ng, jplanck, jrt_lw, 300)
    else:
        planck = jplanck(sp.temperature_hl, sp.wavenumber, sp.d_wavenumber)
        fd, fu = map(np.asarray, jrt_lw(planck, sp.optical_depth,
                                        np.ones(nwav), planck[-1]))
        jax_out = (fd.sum(1), fu.sum(1), fd, fu, sp.optical_depth)
    for name, w in zip(FIELDS, jax_out):
        g, w = getattr(got, name), np.asarray(w)
        assert g.shape == w.shape, name
        assert np.linalg.norm(g - w) <= 1e-10 * np.linalg.norm(w), name
