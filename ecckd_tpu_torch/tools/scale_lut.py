"""scale_lut: make a SW CKD model's direct flux exact for one profile.

PyTorch counterpart of ``ecckd_tpu/tools/scale_lut.py`` (ref
src/ecckd/scale_lut.cpp:22-192): the best layer optical depth of each
g-point follows from the line-by-line direct fluxes summed over the
g-point, od = -mu0 log(F_below / F_above); the CKD model's optical depth
of the same profile comes from its LUTs; every LUT is scaled by their
ratio (1 where the best od is not positive), interpolated onto the LUT's
pressures and clamped to its min/max bounds.

:func:`scale_lut_core` works on arrays: the g-point sums (a one-hot matmul
in float64), the best od, the model's od and the scaling are computed on
the device, the card unless ``device="cpu"``; the LUT's interpolation in
pressure (:meth:`~ecckd_tpu_torch.models.CkdModel.scale_optical_depth`)
stays on the host.  :func:`scale_lut` is the file tool (``python -m
ecckd_tpu_torch.tools.scale_lut input=... output=... lblfile=...
[gpointfile=...] [device=cuda|cpu]``), reading and writing the JAX tool's
files.
"""

from __future__ import annotations

import copy
import sys
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import logs
from ..config import Config
from ..models import CkdModel
from .common import find_file, resolve_device, setup, tool_prologue


class ScaledLut(NamedTuple):
    """Result of :func:`scale_lut_core`: the scaled copy of the model and
    the (nlay, ng) best od, model od and scaling."""
    model: CkdModel
    od_best: np.ndarray
    od_total: np.ndarray
    scaling: np.ndarray


def scale_lut_core(model: CkdModel, g_point, mu0: float, pressure_hl,
                   temperature_hl, mole_fraction, molecules: Sequence[str],
                   spectral_flux_dn_direct, device="cuda") -> ScaledLut:
    """Scale a copy of ``model`` so that its direct flux matches the
    line-by-line one of a profile: (nlay+1,) ``pressure_hl`` and
    ``temperature_hl``, (ngas, nlay) ``mole_fraction`` of ``molecules``
    (a name's part after "-" is dropped), the (nlay+1, nwav) spectral
    direct downwelling flux at cosine zenith angle ``mu0`` and the (nwav,)
    ``g_point`` of each wavenumber.  Float64 on ``device``, the card unless
    ``device="cpu"`` (raises without one)."""
    dev = resolve_device(device)

    def f64(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=torch.float64)
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    ng = model.ng
    pressure_hl = np.asarray(pressure_hl, np.float64)
    mole_fraction = np.asarray(mole_fraction, np.float64)

    logs.log("Computing optimal layer optical depths in each g point")
    gp = torch.as_tensor(np.asarray(g_point, np.int64), device=dev)
    onehot = (gp[:, None] == torch.arange(ng, device=dev)[None, :]).to(
        torch.float64)
    flux_g = f64(spectral_flux_dn_direct) @ onehot          # (nlay+1, ng)
    del onehot
    above, below = flux_g[:-1], flux_g[1:]
    ratio = below / torch.where(above > 0, above, 1.0)
    od_best = torch.where(below > 0.0, -float(mu0) * torch.log(
        torch.where(ratio > 0, ratio, 1.0)), -1.0)

    logs.log("Running CKD model")
    p_hl = f64(pressure_hl)[None]
    t_hl = f64(temperature_hl)
    t_fl = (0.5 * (t_hl[:-1] + t_hl[1:]))[None]
    od_total = torch.zeros_like(od_best)
    names = [m.split("-", 1)[0] for m in molecules]
    for igas in range(-1, len(names)):
        molecule = "composite" if igas == -1 else names[igas]
        gas_index = model.get_gas_index(molecule)
        if gas_index < 0:
            logs.log(f"  Gas {igas}: {molecule} not found")
            continue
        logs.log(f"  Gas {igas}: {molecule}")
        vmr = None if igas == -1 else f64(mole_fraction[igas])[None]
        od_total += model.calc_optical_depth(gas_index, p_hl, t_fl, vmr)[0]

    logs.log("Scaling coefficients in CKD look-up tables")
    scaling = torch.where(
        od_best > 0.0, od_best / torch.where(od_total > 0, od_total, 1.0),
        1.0)
    host = lambda t: t.cpu().numpy()
    scaled = copy.deepcopy(model)
    scaled.scale_optical_depth(0.5 * (pressure_hl[:-1] + pressure_hl[1:]),
                               host(scaling))
    return ScaledLut(scaled, host(od_best), host(od_total), host(scaling))


def scale_lut(cfg: Config, argv=()) -> str:
    """The file tool: read the model, its g-point map and the first
    zenith angle of the line-by-line file, write the scaled model."""
    from ..io import NcFile

    device, _ = setup(cfg)
    input_file = find_file(cfg.read_string("input"))
    output_file = cfg.read_string("output")
    model = CkdModel.read(input_file)
    g_point = model.g_point
    if g_point is None:
        gpoint_filename = cfg.read_string("gpointfile", default=None)
        if not gpoint_filename:
            raise ValueError("gpointfile not provided")
        with NcFile(find_file(gpoint_filename)) as f:
            g_point = np.asarray(f.read("g_point"), np.int64)
        if model.ng != int(g_point.max()) + 1:
            raise ValueError(f"Number of g-points in {input_file} does not "
                             f"match number in {gpoint_filename}")

    lbl_filename = cfg.read_string("lblfile")
    imu0 = 0
    logs.log(f"Reading {lbl_filename}")
    with NcFile(find_file(lbl_filename)) as f:
        mu0 = float(np.asarray(f.read("mu0")).reshape(-1)[imu0])
        molecules = (f.attribute("constituent_id", default="") or "").split()
        pressure_hl = f.read("pressure_hl", index=imu0)
        temperature_hl = f.read("temperature_hl", index=imu0)
        mole_fraction = f.read("mole_fraction_fl", index=imu0)
        flux = f.read("spectral_flux_dn_direct_sw", index=imu0)
    result = scale_lut_core(model, g_point, mu0, pressure_hl, temperature_hl,
                            mole_fraction, molecules, flux, device=device)
    result.model.write(output_file, argv=argv or sys.argv,
                       config_str=cfg.sprint())
    return output_file


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: scale_lut(tool_prologue(argv), argv=["scale_lut"] + argv),
        name="scale_lut")


if __name__ == "__main__":
    sys.exit(main())
