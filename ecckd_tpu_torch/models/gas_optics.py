"""Gas optics: LUT interpolation to optical depth, Planck and Rayleigh.

PyTorch counterpart of ``ecckd_tpu/models/gas_optics.py``
(ref ``CkdModel::calc_optical_depth``, ckd_model.cpp:923-1102).  The
functions work on tensors with a leading column axis; autograd flows
through the look-up table (``molar_abs``), which replaces the reference's
Adept-active instantiation.

Conventions (matching the reference):
* the pressure LUT is evenly spaced in log(p);
* the temperature LUT axis is an offset from a pressure-dependent
  reference profile ``temperature[0, ip]``, with uniform spacing d_t;
* the concentration LUT (conc_dependence == LUT) is evenly spaced in
  log(vmr).

The interpolation weights depend on the atmosphere only, so
:func:`lut_interpolation` computes them once and
:meth:`LutInterpolation.optical_depth` applies them to any table.  The
table's gradient is the transpose of the interpolation: one matmul of a
dense (rows, table entries) weight matrix built on first use.  It replaces
the scatter-add that the backward of an advanced-index gather does, whose
floating-point atomics sum in a different order on every CUDA run.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from ..constants import MOLES_PER_PA


class ConcDependence(enum.IntEnum):
    """Concentration-dependence codes (ref ckd_model.h:30-35 and the
    _conc_dependence_code values written at ckd_model.cpp:566-630)."""
    NONE = 0
    LINEAR = 1
    LUT = 2
    RELATIVE_LINEAR = 3


def _tensor(a, like=None, dtype=None):
    """``a`` as a tensor on ``like``'s device (float64 on the CPU when
    there is no ``like``); tensors keep their dtype unless one is given."""
    if isinstance(a, torch.Tensor):
        return a if dtype is None else a.to(dtype)
    if like is not None:
        return torch.as_tensor(a, dtype=dtype or like.dtype,
                               device=like.device)
    return torch.as_tensor(a, dtype=dtype or torch.float64)


def _pt_indices(pressure_hl, temperature_fl, log_pressure, temperature_lut):
    """Fractional (pressure, temperature) interpolation indices and weights.

    Args:
      pressure_hl: (ncol, nlev+1); temperature_fl: (ncol, nlay);
      log_pressure: (np,) LUT log-pressure grid (evenly spaced);
      temperature_lut: (nt, np) LUT temperature grid.

    Returns:
      ip0, pw1, it0, tw1: int32 / float tensors of shape (ncol, nlay).
    """
    np_ = log_pressure.shape[0]
    nt = temperature_lut.shape[0]
    log_p0 = log_pressure[0]
    d_log_p = log_pressure[1] - log_pressure[0]
    d_t = temperature_lut[1, 0] - temperature_lut[0, 0]

    log_p_fl = torch.log(0.5 * (pressure_hl[:, 1:] + pressure_hl[:, :-1]))
    pindex = torch.clamp((log_p_fl - log_p0) / d_log_p, 0.0, np_ - 1.0001)
    ip0 = pindex.to(torch.int32)
    pw1 = pindex - ip0
    ip = ip0.long()

    t_0 = ((1.0 - pw1) * temperature_lut[0, ip]
           + pw1 * temperature_lut[0, ip + 1])
    tindex = torch.clamp((temperature_fl - t_0) / d_t, 0.0, nt - 1.0001)
    it0 = tindex.to(torch.int32)
    tw1 = tindex - it0
    return ip0, pw1, it0, tw1


class _Interpolate(torch.autograd.Function):
    """The interpolated table values (ncol, nlay, ng), with the gradient
    of the table as the interpolation's transpose (one matmul)."""

    @staticmethod
    def forward(ctx, table, interp):
        ctx.interp = interp
        ctx.table_shape = table.shape
        return interp._combine(table)

    @staticmethod
    def backward(ctx, grad):
        interp = ctx.interp
        ng = grad.shape[-1]
        g = interp.matrix(grad.dtype).t() @ grad.reshape(-1, ng)
        return g.reshape(ctx.table_shape), None


class LutInterpolation:
    """Bi-linear (or, for a LUT gas, tri-linear) interpolation of a gas's
    table at an atmosphere, with the weight by which the interpolated
    value becomes an optical depth.  Built by :func:`lut_interpolation`."""

    def __init__(self, conc_dependence, weight, ip0, pw1, it0, tw1, np_, nt,
                 ic0=None, cw1=None, nconc=1):
        self.conc_dependence = conc_dependence
        self.weight = weight            # (ncol, nlay)
        self.ip0, self.pw1 = ip0.long(), pw1
        self.it0, self.tw1 = it0.long(), tw1
        self.ic0 = None if ic0 is None else ic0.long()
        self.cw1 = cw1
        self.np_, self.nt, self.nconc = np_, nt, nconc
        self._matrix = {}

    def _combine(self, table):
        """JAX's expression of the interpolation, term by term."""
        ip0, it0 = self.ip0, self.it0
        pw1e = self.pw1[..., None]
        tw1e = self.tw1[..., None]
        if self.ic0 is None:
            return ((1.0 - tw1e) * ((1.0 - pw1e) * table[it0, ip0]
                                    + pw1e * table[it0, ip0 + 1])
                    + tw1e * ((1.0 - pw1e) * table[it0 + 1, ip0]
                              + pw1e * table[it0 + 1, ip0 + 1]))

        def conc_slice(ic):
            return ((1.0 - tw1e) * ((1.0 - pw1e) * table[ic, it0, ip0]
                                    + pw1e * table[ic, it0, ip0 + 1])
                    + tw1e * ((1.0 - pw1e) * table[ic, it0 + 1, ip0]
                              + pw1e * table[ic, it0 + 1, ip0 + 1]))

        cw1 = self.cw1[..., None]
        return (1.0 - cw1) * conc_slice(self.ic0) + cw1 * conc_slice(
            self.ic0 + 1)

    def matrix(self, dtype):
        """Dense (ncol * nlay, table entries) interpolation weights: the
        4 (8) corner weights of each row at their flat table indices."""
        m = self._matrix.get(dtype)
        if m is not None:
            return m
        pw1, tw1 = self.pw1.to(dtype), self.tw1.to(dtype)
        flat = lambda it, ip: it * self.np_ + ip
        corners = [(flat(self.it0, self.ip0), (1.0 - tw1) * (1.0 - pw1)),
                   (flat(self.it0, self.ip0 + 1), (1.0 - tw1) * pw1),
                   (flat(self.it0 + 1, self.ip0), tw1 * (1.0 - pw1)),
                   (flat(self.it0 + 1, self.ip0 + 1), tw1 * pw1)]
        per_conc = self.nt * self.np_
        if self.ic0 is not None:
            cw1 = self.cw1.to(dtype)
            corners = ([(self.ic0 * per_conc + i, (1.0 - cw1) * w)
                        for i, w in corners]
                       + [((self.ic0 + 1) * per_conc + i, cw1 * w)
                          for i, w in corners])
        nentries = self.nconc * per_conc
        nrow = self.pw1.numel()
        m = torch.zeros((nrow, nentries), dtype=dtype, device=pw1.device)
        rows = torch.arange(nrow, device=pw1.device)
        # the corners of a row are distinct entries: plain assignments
        for index, w in corners:
            m[rows, index.reshape(-1)] = w.reshape(-1)
        self._matrix[dtype] = m
        return m

    def optical_depth(self, table, logarithmic_interpolation=False):
        """(ncol, nlay, ng) optical depth of ``table`` ((nt, np, ng), or
        (nconc, nt, np, ng) for a LUT gas)."""
        if logarithmic_interpolation:
            table = torch.log(table)
        v = _Interpolate.apply(table, self)
        if logarithmic_interpolation:
            v = torch.exp(v)
        return self.weight[..., None] * v


def lut_interpolation(conc_dependence: ConcDependence, pressure_hl,
                      temperature_fl, log_pressure, temperature_lut,
                      vmr_fl=None, lut_vmr=None,
                      reference_vmr: Optional[float] = None
                      ) -> LutInterpolation:
    """The interpolation of :func:`calc_optical_depth` at an atmosphere,
    apart from the table.  Arguments as there; the LUT grids and the
    concentrations take ``pressure_hl``'s device and dtype."""
    pressure_hl = _tensor(pressure_hl)
    temperature_fl = _tensor(temperature_fl, pressure_hl)
    log_pressure = _tensor(log_pressure, pressure_hl)
    temperature_lut = _tensor(temperature_lut, pressure_hl)
    ip0, pw1, it0, tw1 = _pt_indices(pressure_hl, temperature_fl,
                                     log_pressure, temperature_lut)
    np_, nt = log_pressure.shape[0], temperature_lut.shape[0]
    simple_weight = MOLES_PER_PA * (pressure_hl[:, 1:] - pressure_hl[:, :-1])

    if conc_dependence == ConcDependence.NONE:
        return LutInterpolation(conc_dependence, simple_weight, ip0, pw1,
                                it0, tw1, np_, nt)
    if vmr_fl is None:
        raise ValueError("Concentration required for this gas")
    vmr_fl = _tensor(vmr_fl, pressure_hl)

    if conc_dependence in (ConcDependence.LINEAR,
                           ConcDependence.RELATIVE_LINEAR):
        if conc_dependence == ConcDependence.RELATIVE_LINEAR:
            weight = simple_weight * (vmr_fl - reference_vmr)
        else:
            weight = simple_weight * vmr_fl
        return LutInterpolation(conc_dependence, weight, ip0, pw1, it0, tw1,
                                np_, nt)

    # LUT concentration dependence: tri-linear in (log conc, T, p)
    lut_vmr = _tensor(lut_vmr, pressure_hl)
    nconc = lut_vmr.shape[0]
    weight = simple_weight * vmr_fl
    d_log_c = torch.log(lut_vmr[1] / lut_vmr[0])
    cindex = torch.clamp((torch.log(vmr_fl) - torch.log(lut_vmr[0]))
                         / d_log_c, 0.0, nconc - 1.0001)
    ic0 = cindex.to(torch.int32)
    cw1 = cindex - ic0
    return LutInterpolation(conc_dependence, weight, ip0, pw1, it0, tw1, np_,
                            nt, ic0=ic0, cw1=cw1, nconc=nconc)


def calc_optical_depth(conc_dependence: ConcDependence,
                       molar_abs,
                       pressure_hl,
                       temperature_fl,
                       log_pressure,
                       temperature_lut,
                       vmr_fl=None,
                       lut_vmr=None,
                       reference_vmr: Optional[float] = None,
                       logarithmic_interpolation: bool = False):
    """Optical depth per g-point for multiple columns.

    Args:
      conc_dependence: how absorption depends on concentration.
      molar_abs: (nt, np, ng) table, or (nconc, nt, np, ng) for LUT mode.
      pressure_hl: (ncol, nlev+1) Pa.
      temperature_fl: (ncol, nlay) K.
      log_pressure: (np,) LUT grid; temperature_lut: (nt, np) LUT grid.
      vmr_fl: (ncol, nlay) volume mixing ratio (required unless NONE).
      lut_vmr: (nconc,) LUT concentration coordinate (LUT mode).
      reference_vmr: subtracted from vmr in RELATIVE_LINEAR mode.
      logarithmic_interpolation: interpolate log(k) instead of k.

    Returns:
      (ncol, nlay, ng) optical depth, on the device and in the dtype of
      ``molar_abs`` when it is a tensor (else of ``pressure_hl``).
    """
    if isinstance(molar_abs, torch.Tensor):
        pressure_hl = _tensor(pressure_hl, molar_abs)
    else:
        pressure_hl = _tensor(pressure_hl)
        molar_abs = _tensor(molar_abs, pressure_hl)
    interp = lut_interpolation(conc_dependence, pressure_hl, temperature_fl,
                               log_pressure, temperature_lut, vmr_fl=vmr_fl,
                               lut_vmr=lut_vmr, reference_vmr=reference_vmr)
    return interp.optical_depth(molar_abs, logarithmic_interpolation)


def planck_from_lut(temperature, temperature_planck, planck_lut):
    """Interpolate the Planck-function LUT in temperature.

    Ref CkdModel::calc_planck_function (ckd_model.cpp:1119-1145): linear
    interpolation/extrapolation above the table start; linear to zero below.

    Args:
      temperature: (...,) K; temperature_planck: (ntp,) LUT coordinate;
      planck_lut: (ntp, ng).

    Returns: (..., ng) on the device and in the dtype of ``planck_lut``
    when it is a tensor (else float64 on ``temperature``'s device).
    """
    if isinstance(planck_lut, torch.Tensor):
        lut = planck_lut
        temperature = _tensor(temperature, lut)
    else:
        temperature = _tensor(temperature)
        lut = _tensor(planck_lut, temperature)
    tp = _tensor(temperature_planck, lut)
    ntp = tp.shape[0]
    d_t = tp[1] - tp[0]
    t0 = tp[0]
    tindex = (temperature - t0) / d_t
    it0 = torch.clamp(tindex.to(torch.int32), 0, ntp - 2)
    tw1 = (tindex - it0)[..., None]
    it = it0.long()
    normal = (1.0 - tw1) * lut[it] + tw1 * lut[it + 1]
    below = (temperature / t0)[..., None] * lut[0]
    return torch.where((tindex >= 0)[..., None], normal, below)


def rayleigh_optical_depth(pressure_hl, rayleigh_molar_scat):
    """Rayleigh od per g-point (ref CkdModel::calc_rayleigh_optical_depth,
    ckd_model.h:242-252): moles of air per layer times molar coefficient."""
    if isinstance(rayleigh_molar_scat, torch.Tensor):
        pressure_hl = _tensor(pressure_hl, rayleigh_molar_scat)
    else:
        pressure_hl = _tensor(pressure_hl)
        rayleigh_molar_scat = _tensor(rayleigh_molar_scat, pressure_hl)
    moles = MOLES_PER_PA * (pressure_hl[:, 1:] - pressure_hl[:, :-1])
    return moles[..., None] * rayleigh_molar_scat


def temperature_fl_from_hl(pressure_hl, temperature_hl):
    """Full-level temperature as the pressure-weighted half-level mean
    (ref solve_adept.cpp:37-40, run_ckd.cpp:118-121)."""
    p_x_t = temperature_hl * pressure_hl
    return ((p_x_t[:, :-1] + p_x_t[:, 1:])
            / (pressure_hl[:, :-1] + pressure_hl[:, 1:]))
