"""The port's streaming path against the JAX package's, on the CPU.

Case for case with tests/test_streaming.py and tests/test_prefetch.py: the
native shard loader (built into build/ecckd_tpu_torch/, raising where it
cannot be built), the ``.spbin`` shard format (byte for byte the JAX
package's), the thread-ahead prefetch, the per-block g-point partials of
all eight averaging methods, the streamed average, create_lut's execution
policy and its streamed LUT, the tools on shards, and the shard path in a
process without h5py.

Bars.  The partial sums are JAX's within 1e-12 (the JAX package sums by a
split dot, the port by a matmul); min and max are exact, so bit-identical.
The streamed average follows tests/test_streaming.py: 1e-9 where the
fitted od stays below 2.5, 0.05 above it, where the transmission mean
nears the clamp and -log1p(-mean) amplifies a rounding of the sums
(ROADMAP §3).  The port's streamed and dense paths reduce the same blocks
with the same code, so at the same block size they agree bit for bit.  The
LUT bars are tests/test_torch_pipeline.py's: linear 1e-10 (the same
float32 values), transmission 1e-2, min/max bit-identical.  All in
float64: the port widens a float32 shard's blocks to the precision it is
given (float64 here), where the JAX package computes a raw ShardReader's
float32 blocks in float32 and a ProfileBlocks' in float64; the bars below
compare float64 with float64.
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ecckd_tpu.config import Config as JConfig
from ecckd_tpu.io.shards import ShardReader as JShardReader
from ecckd_tpu.io.shards import write_shard as jwrite_shard
from ecckd_tpu.io.spectrum import read_spectrum as jread_spectrum
from ecckd_tpu.models import CkdModel as JCkdModel
from ecckd_tpu.ops.average import finalize_gpoint_partials as jfinalize
from ecckd_tpu.ops.average import gpoint_block_partials as jpartials
from ecckd_tpu.ops.streaming import \
    streaming_average_od_to_gpoints as jstreaming
from ecckd_tpu.tools.create_lut import _Execution as JExecution
from ecckd_tpu.tools.create_lut import create_lut as jcreate_lut
from ecckd_tpu_torch.config import Config
from ecckd_tpu_torch.io import native
from ecckd_tpu_torch.io.native import NativeFile, PrefetchPool, get_lib
from ecckd_tpu_torch.io.prefetch import prefetch_iter
from ecckd_tpu_torch.io.shards import (ShardReader, convert_spectrum_file,
                                       write_shard)
from ecckd_tpu_torch.io.spectrum import (Spectrum, open_spectrum_profile,
                                         read_spectrum, spectrum_blocks)
from ecckd_tpu_torch.ops.average import (GPOINT_AVERAGING_METHODS,
                                         combine_partials,
                                         finalize_gpoint_partials,
                                         gpoint_block_partials)
from ecckd_tpu_torch.ops import streaming as ops_streaming
from ecckd_tpu_torch.ops.streaming import (average_od_to_gpoints,
                                           streaming_average_od_to_gpoints)
from ecckd_tpu_torch.tools.create_lut import _Execution, create_lut
from synth import synth_spectrum_file
from test_torch_pinned_streaming import SOURCES, block_sources

ROOT = Path(__file__).resolve().parents[1]
T = torch.from_numpy


def _assert_avg_close(got, want, fit_bar=1e-9):
    """tests/test_streaming.py's bars: the fit 1e-9 where it is below 2.5
    and 0.05 above, min and max bit-identical."""
    fit_g, min_g, max_g = (np.asarray(a) for a in got)
    fit_w, min_w, max_w = (np.asarray(a) for a in want)
    sat = fit_w > 2.5
    np.testing.assert_allclose(fit_g[~sat], fit_w[~sat], rtol=fit_bar)
    np.testing.assert_allclose(fit_g[sat], fit_w[sat], rtol=0.05)
    np.testing.assert_array_equal(min_g, min_w)
    np.testing.assert_array_equal(max_g, max_w)


class TestNativeLoader:
    def test_library_builds(self):
        lib = get_lib()
        assert lib is not None
        path = native.library_path()
        assert path.parent == ROOT / "build" / "ecckd_tpu_torch"
        assert path.exists()

    def test_sync_read(self, tmp_path):
        path = str(tmp_path / "data.bin")
        data = np.arange(10000, dtype=np.float32)
        data.tofile(path)
        with NativeFile(path) as f:
            assert f.native
            assert f.size == data.nbytes
            out = f.read(400, 800).view(np.float32)
            np.testing.assert_array_equal(out, data[100:300])

    def test_async_pool(self, tmp_path):
        path = str(tmp_path / "data.bin")
        data = np.arange(65536, dtype=np.float64)
        data.tofile(path)
        with NativeFile(path) as f, PrefetchPool(2) as pool:
            # Submit several requests, retrieve out of order
            for tag in range(4):
                pool.submit(f, tag * 1024 * 8, 1024 * 8, tag)
            for tag in (2, 0, 3, 1):
                out = pool.wait(tag).view(np.float64)
                np.testing.assert_array_equal(
                    out, data[tag * 1024:(tag + 1) * 1024])

    def test_python_reads_on_request(self, tmp_path):
        """``native=False`` reads through Python's file object, the same
        bytes as the synchronous and the pooled native reads; the pool
        refuses such a file."""
        path = str(tmp_path / "data.bin")
        np.arange(100, dtype=np.uint8).tofile(path)
        with NativeFile(path, native=False) as f, NativeFile(path) as g, \
                PrefetchPool(1) as pool:
            assert not f.native and g.native
            assert f.size == g.size == 100
            pool.submit(g, 10, 20, 7)
            for out in (f.read(10, 20), g.read(10, 20), pool.wait(7)):
                np.testing.assert_array_equal(
                    out, np.arange(10, 30, dtype=np.uint8))
            np.testing.assert_array_equal(f.read(90, 50), g.read(90, 50))
            with pytest.raises(ValueError, match="native"):
                pool.submit(f, 0, 10, 0)

    def test_missing_file_raises(self, tmp_path):
        for native_reads in (True, False):
            with pytest.raises(FileNotFoundError):
                NativeFile(str(tmp_path / "absent.bin"), native=native_reads)

    @pytest.mark.parametrize("native_reads", [True, False])
    def test_read_after_close_raises(self, tmp_path, native_reads):
        path = str(tmp_path / "data.bin")
        np.arange(100, dtype=np.uint8).tofile(path)
        f = NativeFile(path, native=native_reads)
        f.close()
        f.close()
        with pytest.raises(ValueError, match="closed"):
            f.read(0, 10)

    def test_close_waits_for_read_in_flight(self, tmp_path):
        """A read on another thread (a prefetch thread) holds close back
        until it has returned: the handle is never freed under it."""
        path = str(tmp_path / "data.bin")
        np.arange(1000, dtype=np.uint8).tofile(path)
        f = NativeFile(path)
        events, lib = [], f._lib

        class SlowLib:
            def sl_read(self, *args):
                events.append("read starts")
                time.sleep(0.3)
                n = lib.sl_read(*args)
                events.append("read ends")
                return n

            def sl_close(self, handle):
                events.append("close")
                lib.sl_close(handle)

        f._lib = SlowLib()
        out = []
        t = threading.Thread(target=lambda: out.append(f.read(10, 20)))
        t.start()
        while not events:
            time.sleep(0.01)
        f.close()
        t.join()
        assert events == ["read starts", "read ends", "close"]
        np.testing.assert_array_equal(out[0],
                                      np.arange(10, 30, dtype=np.uint8))

    def test_close_collects_pooled_reads(self, tmp_path):
        """Closing a file with pooled reads submitted and not waited for
        collects them first; waiting for one afterwards raises."""
        path = str(tmp_path / "data.bin")
        np.arange(1 << 20, dtype=np.uint8).tofile(path)
        with PrefetchPool(2) as pool:
            f = NativeFile(path)
            for tag in range(4):
                pool.submit(f, tag << 18, 1 << 18, tag)
            np.testing.assert_array_equal(
                pool.wait(1), (np.arange(1 << 18) + (1 << 18)) % 256)
            f.close()
            with pytest.raises(ValueError, match="closed"):
                pool.wait(2)
            with pytest.raises(ValueError, match="closed"):
                pool.submit(f, 0, 10, 9)

    @pytest.mark.parametrize("how", ["stream", "lw_spectra", "iter_blocks"])
    def test_consumer_error_with_read_in_flight(self, tmp_path, monkeypatch,
                                                how):
        """A consumer that raises while the next block is being read (by
        the prefetch thread, or by the loader's pool) closes the shard
        under that read: the consumer's error comes out, nothing crashes,
        and a read after close raises."""
        from ecckd_tpu_torch.tools import lw_spectra as lw
        rng = np.random.default_rng(5)
        nlay, nwav = 4, 1 << 16
        p_hl = np.linspace(100.0, 1.0e5, nlay + 1)
        wav = np.linspace(1.0, 2500.0, nwav)
        sp = Spectrum(p_hl, np.linspace(200.0, 290.0, nlay + 1), wav,
                      np.gradient(wav), rng.gamma(0.5, 0.4, (nlay, nwav)))
        path = write_shard(str(tmp_path / "x_000.spbin"), sp)

        class Stop(Exception):
            pass

        calls = []

        def step():
            calls.append(1)
            if len(calls) > 1:
                raise Stop

        real_rt_lw = lw.rt_lw

        def rt_lw(*args):
            step()
            return real_rt_lw(*args)

        monkeypatch.setattr(lw, "rt_lw", rt_lw)
        for _ in range(5):
            calls.clear()
            with pytest.raises(Stop):
                if how == "iter_blocks":
                    with ShardReader(path) as r:
                        for _blk in r.iter_blocks(block_wav=4096):
                            step()
                with open_spectrum_profile(path, 0) as pb:
                    if how == "stream":
                        streaming_average_od_to_gpoints(
                            pb, 2, np.arange(nwav) % 2,
                            lambda i0, nb: (step(), np.ones(nb))[1],
                            "transmission", block_wav=4096, device="cpu")
                    lw.lw_spectra_core(pb, block_wav=4096, device="cpu")
        with pytest.raises(ValueError, match="closed"):
            if how == "iter_blocks":
                r.read_block(0, 10)
            else:
                pb.read_block(0, 10)

    def test_failed_build_raises(self, tmp_path, monkeypatch):
        """A source that does not compile raises with the compiler's
        output; nothing falls back to Python reads."""
        bad = tmp_path / "shardloader.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "SOURCE", bad)
        monkeypatch.setattr(native, "_lib", None)
        with pytest.raises(RuntimeError, match="shard loader failed"):
            get_lib()
        data = tmp_path / "data.bin"
        data.write_bytes(b"abc")
        with pytest.raises(RuntimeError, match="shard loader failed"):
            NativeFile(str(data))
        assert not native.library_path().exists()


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    h5 = synth_spectrum_file(str(d / "h2o.h5"), nwav=2048, ncol=2)
    paths = convert_spectrum_file(h5, str(d / "h2o"), iprofiles=[0])
    return dict(d=d, h5=h5, shard=paths[0])


class TestShards:
    def test_roundtrip(self, shard):
        sp = jread_spectrum(shard["h5"], 0)
        with ShardReader(shard["shard"]) as r:
            assert r.nwav == len(sp.wavenumber)
            assert r.nlay == sp.optical_depth.shape[0]
            np.testing.assert_array_equal(r.wavenumber, sp.wavenumber)
            np.testing.assert_array_equal(r.pressure_hl, sp.pressure_hl)
            block = r.read_block(100, 50)
            np.testing.assert_array_equal(
                block, sp.optical_depth[:, 100:150].astype(np.float32))

    @pytest.mark.parametrize("native_reads", [True, False])
    def test_blocked_iteration_covers_spectrum(self, shard, native_reads):
        """Pooled and ``native=False`` blocks cover the spectrum and equal
        the synchronous reads bit for bit."""
        sp = read_spectrum(shard["h5"], 0)
        with ShardReader(shard["shard"], native=native_reads) as r, \
                ShardReader(shard["shard"]) as sync:
            total = np.zeros(r.nlay)
            count = 0
            for iwav0, block in r.iter_blocks(block_wav=300):
                np.testing.assert_array_equal(
                    block, sync.read_block(iwav0, block.shape[1]))
                total += block.sum(axis=1)
                count += block.shape[1]
            assert count == r.nwav
            np.testing.assert_allclose(total, sp.optical_depth.sum(1),
                                       rtol=1e-5)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_shards_byte_identical_both_ways(self, shard, tmp_path, dtype):
        """A shard written by either package is the other's byte for byte,
        and each package reads both."""
        sp = read_spectrum(shard["h5"], 0)
        jsp = jread_spectrum(shard["h5"], 0)
        a = write_shard(str(tmp_path / "port.spbin"), sp, dtype)
        b = jwrite_shard(str(tmp_path / "jax.spbin"), jsp, dtype)
        assert Path(a).read_bytes() == Path(b).read_bytes()
        for path in (a, b):
            with ShardReader(path) as r, JShardReader(path) as j:
                assert r.header == j.header
                np.testing.assert_array_equal(r.d_wavenumber,
                                              j.d_wavenumber)
                np.testing.assert_array_equal(r.read_block(0, r.nwav),
                                              j.read_block(0, j.nwav))

    def test_streaming_average_matches_dense(self, shard, tmp_path):
        """A float64 shard streamed in blocks of 500 by the port: its dense
        average at the same block size bit for bit, its dense average in
        one block and JAX's streamed average at JAX's bars."""
        sp = read_spectrum(shard["h5"], 0)
        shard64 = write_shard(str(tmp_path / "f64.spbin"), sp,
                              dtype=np.float64)
        nwav = len(sp.wavenumber)
        ng = 6
        rng = np.random.default_rng(0)
        g_point = rng.integers(0, ng, nwav)
        weight = np.abs(rng.normal(5, 1, (sp.optical_depth.shape[0],
                                          nwav)))
        wfn = lambda i0, n: weight[:, i0:i0 + n]
        with ShardReader(shard64) as r:
            got = streaming_average_od_to_gpoints(
                r, ng, g_point, wfn, "transmission", block_wav=500,
                device="cpu")
        with JShardReader(shard64) as r:
            want = jstreaming(r, ng, g_point, wfn, "transmission",
                              block_wav=500)
        _assert_avg_close(got, want)
        dense = lambda **kw: average_od_to_gpoints(
            ng, T(g_point), T(sp.optical_depth), T(weight), "transmission",
            **kw)
        for g, d in zip(got, dense(block_wav=500)):
            np.testing.assert_array_equal(g, d)
        _assert_avg_close(got, dense())

    def test_raw_float32_shard_follows_precision(self, shard):
        """A raw ShardReader's float32 blocks are widened to the precision
        asked for: float64 gives the bits of the float64 blocks of
        open_spectrum_profile (which widens on the host)."""
        nwav, ng = 2048, 5
        rng = np.random.default_rng(2)
        g_point = rng.integers(0, ng, nwav)
        weight = np.abs(rng.normal(5, 1, (15, nwav)))
        wfn = lambda i0, n: weight[:, i0:i0 + n]
        outs = []
        with ShardReader(shard["shard"]) as r:
            outs.append(streaming_average_od_to_gpoints(
                r, ng, g_point, wfn, "linear", block_wav=700, device="cpu"))
        with open_spectrum_profile(shard["shard"], 0) as pb:
            outs.append(streaming_average_od_to_gpoints(
                pb, ng, g_point, wfn, "linear", block_wav=700, device="cpu"))
        with ShardReader(shard["shard"]) as r:
            f32 = streaming_average_od_to_gpoints(
                r, ng, g_point, wfn, "linear", block_wav=700, device="cpu",
                dtype=torch.float32)
        for a, b in zip(*outs):
            assert a.dtype == np.float64
            np.testing.assert_array_equal(a, b)
        assert f32[0].dtype == np.float32
        np.testing.assert_allclose(f32[0], outs[0][0], rtol=1e-5)


@pytest.mark.parametrize("method", GPOINT_AVERAGING_METHODS)
def test_block_partials_and_finalize_match_jax(method):
    """gpoint_block_partials of two blocks on the port's block loop,
    combined and finalized: the JAX package's partials within 1e-12 of each
    key's largest value, min and max bit-identical, and its finalized fit
    within 1e-12."""
    from ecckd_tpu.ops import streaming as jax_streaming
    rng = np.random.default_rng(4)
    nz, nwav, ng = 15, 3000, 7
    od = rng.gamma(0.4, 1.0, (nz, nwav))
    od[:, :40] = 0.0
    weight = np.abs(rng.normal(1.0, 0.3, (nz, nwav)))
    g_point = rng.integers(-1, ng - 1, nwav)    # g-point ng-1 stays empty
    g_point[:8] = 2
    p_fl = np.exp(np.linspace(np.log(200.0), np.log(1.0e5), nz))

    def reduce(i0, od_block):
        sl = slice(i0, i0 + od_block.shape[1])
        return gpoint_block_partials(ng, T(g_point[sl]), od_block,
                                     T(weight[:, sl]), method)

    acc = jacc = None
    blocks = (slice(0, 1700), slice(1700, nwav))
    parts = ops_streaming.block_results(
        [(sl.start, T(od[:, sl])) for sl in blocks], reduce)
    for sl, (_, part) in zip(blocks, parts):
        jpart = {k: np.asarray(v) for k, v in jpartials(
            ng, g_point[sl], od[:, sl], weight[:, sl], method).items()}
        assert sorted(part) == sorted(jpart)
        for key in part:
            if key in ("min", "max"):
                np.testing.assert_array_equal(part[key], jpart[key])
            else:
                np.testing.assert_allclose(
                    part[key], jpart[key], rtol=1e-12,
                    atol=1e-12 * np.abs(jpart[key]).max())
        acc = part if acc is None else combine_partials(acc, part)
        jacc = jpart if jacc is None else jax_streaming._combine(jacc, jpart)
    got = finalize_gpoint_partials(acc, method, pressure_fl=p_fl)
    want = jfinalize(jacc, method, pressure_fl=p_fl)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max())
    # a tensor block gives the partials of the same arrays
    direct = gpoint_block_partials(ng, T(g_point), T(od), T(weight), method)
    assert set(direct) == set(acc)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="not understood"):
        gpoint_block_partials(3, T(np.zeros(4, np.int64)),
                              T(np.ones((2, 4))), T(np.ones((2, 4))), "mean")
    with pytest.raises(ValueError, match="does not support"):
        streaming_average_od_to_gpoints(None, 3, np.zeros(4), None, "mean",
                                        device="cpu")


# ------------------------------------------------------------ create_lut

@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A thin h2o spectrum (tests/test_create_lut.py's od_scale 1e-3) and
    a g-point file of the JAX chain."""
    from ecckd_tpu.tools.find_g_points import find_g_points
    from ecckd_tpu.tools.reorder_spectrum import reorder_spectrum
    d = tmp_path_factory.mktemp("stream_lut")
    h2o = synth_spectrum_file(str(d / "h2o.h5"), molecule="h2o", nwav=1024,
                              ncol=6, seed=3, od_scale=1e-3)
    order = str(d / "order.h5")
    reorder_spectrum(JConfig({"input": h2o, "output": order}), argv=["r"])
    gp = str(d / "gpoints.h5")
    find_g_points(JConfig({
        "output": gp, "gases": "h2o", "heating_rate_tolerance": "0.4",
        "averaging_method": "transmission", "h2o.reordering_input": order,
        "h2o.input": h2o}), argv=["f"])
    return dict(d=d, h2o=h2o, gpoints=gp)


def _lut(tool, chain, tag, method, keys):
    out = str(chain["d"] / f"{tag}_{method}.nc")
    cfg = {"input": chain["gpoints"], "output": out, "gases": "h2o",
           "averaging_method": method, "h2o.conc_dependence": "linear",
           "h2o.input": chain["h2o"], **keys}
    if tool is create_lut:
        tool(Config({**cfg, "device": "cpu"}), argv=["c"])
    else:
        tool(JConfig(cfg), argv=["c"])
    return JCkdModel.read(out).gas("h2o")


@pytest.mark.parametrize("method,rtol", [
    ("linear", 1e-10), ("transmission", 1e-2), ("logarithmic", 1e-10),
    ("hybrid-logarithmic-transmission-3", 1e-2)])
def test_create_lut_streaming_matches_jax_and_dense(chain, method, rtol):
    """streaming=1 in blocks of 300: JAX's streamed LUT at
    tests/test_torch_pipeline.py's bars; the port's dense LUT bit for bit
    at the same block size and within JAX's streaming-vs-dense 1e-6 in
    one block (tests/test_create_lut.py:147-148)."""
    stream = {"streaming": "1", "streaming_block_wav": "300",
              "sharded": "0"}
    got = _lut(create_lut, chain, "port_stream", method, stream)
    want = _lut(jcreate_lut, chain, "jax_stream", method, stream)
    for name in ("molar_abs", "min_molar_abs", "max_molar_abs"):
        a, b = getattr(got, name), getattr(want, name)
        if name == "molar_abs":
            np.testing.assert_allclose(a, b, rtol=rtol)
        else:
            np.testing.assert_array_equal(a, b)
    same_blocks = _lut(create_lut, chain, "port_dense300", method,
                       {"streaming": "0", "streaming_block_wav": "300"})
    dense = _lut(create_lut, chain, "port_dense", method, {"streaming": "0"})
    for name in ("molar_abs", "min_molar_abs", "max_molar_abs"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(same_blocks, name))
        np.testing.assert_allclose(getattr(got, name), getattr(dense, name),
                                   rtol=1e-6)


@pytest.mark.parametrize("cd", ["none", "lut"])
def test_create_lut_streaming_conc_dependence(chain, tmp_path, cd):
    """Merged and LUT gases streamed from NetCDF and from shards: JAX's
    streamed LUT (linear averaging: the same float32 values)."""
    h2o = chain["h2o"]
    h2o_2x = synth_spectrum_file(str(tmp_path / "h2o_2x.h5"), nwav=1024,
                                 ncol=6, seed=3, od_scale=1e-3,
                                 vmr_value=0.02)
    shards = [convert_spectrum_file(f, str(tmp_path / name),
                                    dtype=np.float64)[0]
              for f, name in ((h2o, "a"), (h2o_2x, "b"))]
    outs = []
    for tag, tool, cfg, files in (
            ("jax", jcreate_lut, JConfig, (h2o, h2o_2x)),
            ("torch", create_lut, Config, (h2o, h2o_2x)),
            ("torch_spbin", create_lut, Config, shards)):
        out = str(tmp_path / f"{tag}.nc")
        keys = {"input": chain["gpoints"], "output": out,
                "averaging_method": "linear", "streaming": "1",
                "streaming_block_wav": "300", "sharded": "0",
                "gases": "h2o", "h2o.conc_dependence": cd,
                "h2o.input": " ".join(files)}
        if tag != "jax":
            keys["device"] = "cpu"
        tool(cfg(keys), argv=["c"])
        outs.append(JCkdModel.read(out).gas("h2o"))
    for got in outs[1:]:
        for name in ("molar_abs", "min_molar_abs", "max_molar_abs"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(outs[0], name), rtol=1e-10)


def test_streaming_auto_rule():
    """JAX's rule (tests/test_create_lut.py:156-164), and the same choice
    as JAX's _Execution over a grid of sizes and budgets."""
    ex = _Execution.from_config(Config({"streaming_memory_mb": "0.001"}))
    assert ex.use_streaming(15, 1024)
    ex = _Execution.from_config(Config({}))           # default 1 GB budget
    assert not ex.use_streaming(15, 1024)
    assert ex.use_streaming(50, 5_600_000)            # CKDMIP scale
    assert not ex.use_streaming(50, 1 << 20)          # the smoke's 2^20
    assert _Execution.from_config(Config({"streaming": "1"})).use_streaming(
        2, 2)
    assert not _Execution.from_config(
        Config({"streaming": "no"})).use_streaming(50, 5_600_000)
    for mode in ("auto", "1", "true", "0", "false"):
        for mb in ("0.5", "64", "1024"):
            keys = {"streaming": mode, "streaming_memory_mb": mb}
            ours = _Execution.from_config(Config(keys))
            theirs = JExecution(JConfig(keys))
            for nlay, nwav in ((15, 1024), (50, 1 << 20), (50, 2_000_000),
                               (50, 5_600_000), (137, 400_000)):
                assert ours.use_streaming(nlay, nwav) \
                    == theirs.use_streaming(nlay, nwav)


def test_create_lut_core_streams_arrays():
    """create_lut_core on arrays in memory: streaming "1" reduces the same
    blocks as "0" and gives the same model bit for bit."""
    from types import SimpleNamespace
    from ecckd_tpu_torch.models import ConcDependence
    from ecckd_tpu_torch.tools.create_lut import LutGas, create_lut_core
    rng = np.random.default_rng(6)
    nlay, nwav = 6, 900
    p = np.exp(np.linspace(np.log(100.0), np.log(1.013e5), nlay + 1))
    wav = np.linspace(1.0, 2000.0, nwav)
    sp = SimpleNamespace(
        pressure_hl=p, temperature_hl=np.linspace(210.0, 284.0, nlay + 1),
        wavenumber=wav, d_wavenumber=np.gradient(wav),
        optical_depth=rng.gamma(0.5, 0.5, (nlay, nwav)), ncol=1)
    g_point = np.minimum(np.arange(nwav) // 200, 3)
    models = [create_lut_core(
        g_point, [1.0], [2000.0], np.zeros(4, np.int64),
        [LutGas("h2o", ConcDependence.LINEAR, [lambda i: (sp, 0.01)])],
        device="cpu", streaming=mode, streaming_block_wav=256)
        for mode in ("1", "0")]
    a, b = (m.single_gas_data[0] for m in models)
    for name in ("molar_abs", "min_molar_abs", "max_molar_abs"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("kind", SOURCES + ("short",))
def test_stage_keeps_bits_dtype_and_layout(tmp_path, kind):
    """The card's staging (here unpinned) of a row-strided view of an
    (nlay, nwav) array, of transposed float64 and float32 shard blocks and
    of a short last block: the block's values bit for bit in its own
    dtype, a shard block as it lies, any other in C order, in a buffer of
    its own."""
    _, source = block_sources(tmp_path, nlay=6, nwav=1000)
    reader, _ = source("arrays" if kind == "short" else kind)
    with reader:
        blocks = list(reader.iter_blocks(block_wav=300))
    _, block = blocks[-1 if kind == "short" else 1]
    assert block.shape == (6, 100 if kind == "short" else 300)
    staged = ops_streaming._stage(block, pin_memory=False)
    assert staged.dtype == T(block).dtype == (
        torch.float32 if kind == "shard32" else torch.float64)
    np.testing.assert_array_equal(staged.numpy(), block)
    if kind.startswith("shard"):
        assert staged.stride() == (1, 6)
    else:
        assert not block.flags.c_contiguous and staged.is_contiguous()
    assert not np.shares_memory(staged.numpy(), block)


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("kind", SOURCES)
def test_streaming_equals_dense_on_block_sources(tmp_path, kind, staged):
    """Streamed in blocks of 300 (the last short), from arrays and from
    float64 and float32 shards, as read or staged: the dense average at the
    same block size bit for bit, every block counted as pageable on the
    CPU."""
    _, source = block_sources(tmp_path, nlay=6, nwav=1000, seed=3)
    ng = 5
    rng = np.random.default_rng(4)
    g_point = rng.integers(-1, ng, 1000)
    weight = np.abs(rng.normal(5, 1, (6, 1000)))
    wfn = lambda i0, n: weight[:, i0:i0 + n]  # noqa: E731
    reader, od = source(kind)

    class Staged:
        def iter_blocks(self, block_wav):
            for i0, b in reader.iter_blocks(block_wav=block_wav):
                yield i0, ops_streaming._stage(b, pin_memory=False)

    with reader:
        ops_streaming.reset_transfer_counts()
        got = streaming_average_od_to_gpoints(
            Staged() if staged else reader, ng, g_point, wfn,
            "transmission", block_wav=300, device="cpu")
        assert ops_streaming.transfer_counts() == {"pinned": 0,
                                                   "pageable": 4}
    want = average_od_to_gpoints(ng, T(g_point), T(od).double(), T(weight),
                                 "transmission", block_wav=300)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ops_streaming.reset_transfer_counts()
    assert ops_streaming.transfer_counts() == {"pinned": 0, "pageable": 0}


def test_sharded_still_raises():
    """``sharded=1`` shards over cards: with device=cpu it raises, streamed
    or not, before any file is read."""
    with pytest.raises(ValueError, match="mesh of logical shards"):
        create_lut(Config({"device": "cpu", "output": "x.nc",
                           "streaming": "1", "sharded": "1"}))


# ------------------------------------------------------ tools on shards

class TestShardInputsInTools:
    def test_open_spectrum_profile_spbin(self, tmp_path):
        """.spbin inputs ride the native loader through the same
        ProfileBlocks interface as NetCDF spectra."""
        h5 = synth_spectrum_file(str(tmp_path / "h2o.h5"), nwav=1024,
                                 ncol=2, seed=9)
        paths = convert_spectrum_file(h5, str(tmp_path / "h2o"),
                                      iprofiles=[0, 1], dtype=np.float64)
        for iprof in (0, 1):
            sp = read_spectrum(h5, iprof)
            with open_spectrum_profile(paths[0], iprof) as pb:
                assert pb.ncol == 2
                assert pb.molecule == sp.molecule
                assert pb.reference_surface_vmr == sp.reference_surface_vmr
                np.testing.assert_array_equal(pb.wavenumber, sp.wavenumber)
                np.testing.assert_array_equal(pb.vmr_fl, sp.vmr_fl)
                got = pb.materialize()
                np.testing.assert_array_equal(got.optical_depth,
                                              sp.optical_depth)

    def test_merged_spectra_from_shards(self, tmp_path):
        """open_merged_spectrum_profile sums shards as it sums NetCDF
        files, scalings included."""
        from ecckd_tpu_torch.io.spectrum import read_merged_spectrum
        files = {}
        for gas, seed in (("h2o", 3), ("o3", 7)):
            h5 = synth_spectrum_file(str(tmp_path / f"{gas}.h5"),
                                     molecule=gas, nwav=512, ncol=2,
                                     seed=seed)
            files[gas] = (h5, convert_spectrum_file(
                h5, str(tmp_path / gas), dtype=np.float64)[0])
        for i in (0, 1):
            nc, sh = (read_merged_spectrum(Config({
                "input": f"{files['h2o'][k]} {files['o3'][k]}",
                "scaling": "0.5 2.0"}), i) for k in (0, 1))
            assert nc.molecule == sh.molecule == "h2o o3"
            np.testing.assert_array_equal(sh.optical_depth, nc.optical_depth)
            np.testing.assert_array_equal(sh.vmr_fl, nc.vmr_fl)

    @pytest.mark.parametrize("tool", ["reorder_spectrum", "find_g_points"])
    def test_tools_accept_spbin(self, tmp_path, tool):
        """The port's reorder_spectrum and find_g_points give the same file
        from a float64 shard as from its NetCDF original."""
        from ecckd_tpu_torch.io import NcFile
        from ecckd_tpu_torch.tools.find_g_points import find_g_points
        from ecckd_tpu_torch.tools.reorder_spectrum import reorder_spectrum
        h5 = synth_spectrum_file(str(tmp_path / "h2o.h5"), nwav=1024,
                                 ncol=1, seed=3)
        spbin = convert_spectrum_file(h5, str(tmp_path / "h2o"),
                                      iprofiles=[0], dtype=np.float64)[0]
        order = str(tmp_path / "order.h5")
        reorder_spectrum(Config({"input": h5, "output": order,
                                 "device": "cpu"}), argv=["r"])

        def run(tag, spec):
            out = str(tmp_path / f"{tool}_{tag}.h5")
            if tool == "reorder_spectrum":
                reorder_spectrum(Config({"input": spec, "output": out,
                                         "device": "cpu"}), argv=["r"])
                return out, ("rank", "band_number", "sorting_variable")
            find_g_points(Config({
                "output": out, "gases": "h2o",
                "heating_rate_tolerance": "0.4",
                "averaging_method": "transmission", "device": "cpu",
                "h2o.reordering_input": order, "h2o.input": spec,
            }), argv=["find_g_points"])
            return out, ("g_point", "h2o_rank1", "h2o_rank2", "h2o_error")

        (a, names), (b, _) = run("h5", h5), run("spbin", spbin)
        with NcFile(a) as fa, NcFile(b) as fb:
            for name in names:
                np.testing.assert_array_equal(fa.read(name), fb.read(name))


_NO_H5PY = r"""
import sys
sys.modules["h5py"] = None
import numpy as np
import torch
from ecckd_tpu_torch.io.shards import write_shard
from ecckd_tpu_torch.io.spectrum import Spectrum, open_spectrum_profile
from ecckd_tpu_torch.ops.streaming import streaming_average_od_to_gpoints
from ecckd_tpu_torch.tools.lw_spectra import lw_spectra_core
nlay, nwav = 5, 600
p = np.exp(np.linspace(np.log(100.0), np.log(1.013e5), nlay + 1))
t = np.linspace(210.0, 284.0, nlay + 1)
wav = np.linspace(1.0, 2000.0, nwav)
od = np.random.default_rng(0).gamma(0.5, 0.2, (nlay, nwav))
path = write_shard(sys.argv[1], Spectrum(p, t, wav, np.gradient(wav), od,
                                         "h2o", 0.01, np.full(nlay, 0.01)))
g = np.arange(nwav) % 4
with open_spectrum_profile(path, 0) as pb:
    fit = streaming_average_od_to_gpoints(
        pb, 4, g, lambda i0, n: np.ones(n), "transmission", block_wav=128,
        device="cpu")[0]
    out = lw_spectra_core(pb, g, block_wav=128, device="cpu")
assert np.all(np.isfinite(fit)) and fit.shape == (nlay, 4)
assert np.all(np.isfinite(out.flux_dn)) and out.spectral_flux_dn.shape == (
    nlay + 1, 4)
assert "h5py" not in sys.modules or sys.modules["h5py"] is None
print("ok")
"""


def test_shard_path_runs_without_h5py(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_H5PY, str(tmp_path / "x_000.spbin")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


# -------------------------------------------------------------- prefetch
# tests/test_prefetch.py, case for case, on the port's copy

def test_order_and_values_identical():
    items = [(i, np.full((3, 7), i, dtype=np.float64)) for i in range(17)]
    got = list(prefetch_iter(iter(items), depth=3))
    assert len(got) == len(items)
    for (i0, a), (i1, b) in zip(items, got):
        assert i0 == i1
        np.testing.assert_array_equal(a, b)


def test_depth_zero_passthrough():
    assert list(prefetch_iter(iter(range(5)), depth=0)) == [0, 1, 2, 3, 4]


def test_producer_exception_propagates():
    def gen():
        yield 1
        raise RuntimeError("disk on fire")

    it = prefetch_iter(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="disk on fire"):
        list(it)


def test_early_consumer_exit_stops_producer():
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    it = prefetch_iter(gen(), depth=2)
    for _ in range(3):
        next(it)
    it.close()
    n_at_close = len(produced)
    time.sleep(0.3)
    # Producer stops promptly: at most one extra item raced into the queue
    assert len(produced) <= n_at_close + 1


def test_reads_overlap_compute():
    """With a slow producer and a slow consumer, prefetching must beat
    the serial sum of the two (i.e. reads genuinely overlap)."""
    n, delay = 8, 0.03

    def slow_gen():
        for i in range(n):
            time.sleep(delay)
            yield i

    t0 = time.perf_counter()
    for _ in prefetch_iter(slow_gen(), depth=2):
        time.sleep(delay)           # consumer work
    dt = time.perf_counter() - t0
    serial = 2 * n * delay
    assert dt < serial * 0.85, (dt, serial)


@pytest.mark.parametrize("kind", ["netcdf", "spbin", "arrays"])
def test_prefetched_blocks_match_unprefetched(tmp_path, kind):
    """A profile's blocks through the prefetcher are its direct reads bit
    for bit, from a NetCDF file, a shard and arrays in memory."""
    h5 = synth_spectrum_file(str(tmp_path / "h2o.h5"), nwav=1024, seed=5)
    sp = read_spectrum(h5, 0)
    if kind == "spbin":
        path = convert_spectrum_file(h5, str(tmp_path / "h2o"),
                                     iprofiles=[0])[0]
        pb = open_spectrum_profile(path, 0)
    elif kind == "netcdf":
        pb = open_spectrum_profile(h5, 0)
    else:
        pb = spectrum_blocks(sp)
    with pb:
        got = np.concatenate([b for _, b in prefetch_iter(
            pb.iter_blocks(block_wav=123), depth=2)], axis=1)
    np.testing.assert_array_equal(got, sp.optical_depth)
