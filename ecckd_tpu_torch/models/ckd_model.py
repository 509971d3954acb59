"""CkdModel: the CKD gas-optics model container and its ckd-definition
file.

PyTorch-package counterpart of ``ecckd_tpu/models/ckd_model.py``
(ref ckd_model.{h,cpp}).  The container holds numpy arrays: the LW and SW
constructor (SW models get their per-g-point Rayleigh coefficient),
:meth:`CkdModel.read` and :meth:`CkdModel.write` with the reference's exact
ckd-definition schema (ckd_model.cpp:30-641), the optical-depth, Planck
and Rayleigh wrappers over :mod:`.gas_optics`, and the optimisation state:
the LUTs of the active gases as a dict of arrays, the Markov-correlation
prior, the relative-linear cap and :meth:`CkdModel.scale_optical_depth`,
which scale_lut applies.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import logs
from ..constants import K_NAME, MOLES_PER_PA, REFERENCE_COS_SZA
from ..ops.rayleigh import rayleigh_molar_scattering_coeff
from .gas_optics import (ConcDependence, _tensor, calc_optical_depth,
                         planck_from_lut, rayleigh_optical_depth)

# Numbers below this in the inverse prior covariance are zeroed
# (ref ckd_model.cpp:649)
MIN_ERROR_COVARIANCE = 1.0e-6


@dataclasses.dataclass
class GasData:
    """Per-gas LUT and prior data (ref SingleGasData, ckd_model.h:37-103)."""
    molecule: str
    conc_dependence: ConcDependence = ConcDependence.LINEAR
    # (nt, np, ng), or (nconc, nt, np, ng) when conc_dependence == LUT
    molar_abs: Optional[np.ndarray] = None
    min_molar_abs: Optional[np.ndarray] = None
    max_molar_abs: Optional[np.ndarray] = None
    vmr: Optional[np.ndarray] = None          # LUT concentration coordinate
    reference_vmr: Optional[float] = None     # RELATIVE_LINEAR
    composite_vmr: Optional[np.ndarray] = None    # NONE: (ngas_comp, np)
    composite_molecules: str = ""
    is_active: bool = False
    # Prior machinery (ref ckd_model.h:75-90)
    inv_background_shape: Optional[np.ndarray] = None
    background_error: Optional[np.ndarray] = None

    @property
    def Molecule(self) -> str:
        return self.molecule.upper()


def _optional(a):
    return None if a is None else np.asarray(a, np.float64)


class CkdModel:
    """A correlated k-distribution model: longwave with a Planck LUT, or
    shortwave with ``solar_irradiance`` per g-point."""

    def __init__(self, single_gas_data: Sequence[GasData], pressure,
                 temperature, wavenumber1, wavenumber2, gpoint_fraction,
                 wavenumber1_band, wavenumber2_band, band_number,
                 temperature_planck=None, planck_function=None,
                 solar_irradiance=None, ssi=None, rayleigh_molar_scat=None,
                 reference_total_solar_irradiance: float = -1.0,
                 history: str = "", config: str = "", summary: str = "",
                 model_id: str = ""):
        self.single_gas_data = list(single_gas_data)
        self.log_pressure = np.log(np.asarray(pressure, np.float64))
        self.temperature = np.asarray(temperature, np.float64)
        self.wavenumber1 = np.asarray(wavenumber1, np.float64)
        self.wavenumber2 = np.asarray(wavenumber2, np.float64)
        self.gpoint_fraction = np.asarray(gpoint_fraction, np.float64)
        self.wavenumber1_band = np.asarray(wavenumber1_band, np.float64)
        self.wavenumber2_band = np.asarray(wavenumber2_band, np.float64)
        self.band_number = np.asarray(band_number, np.int32)
        self.temperature_planck = _optional(temperature_planck)
        self.planck_function = _optional(planck_function)
        self.solar_irradiance = _optional(solar_irradiance)
        # SSI per spectral interval of gpoint_fraction's grid
        self.ssi = _optional(ssi)
        self.rayleigh_molar_scat = _optional(rayleigh_molar_scat)
        self.reference_total_solar_irradiance = float(
            reference_total_solar_irradiance)
        self.history = history
        self.config = config
        self.summary = summary
        self.model_id = model_id
        self.logarithmic_interpolation = False
        self.rayleigh_is_active = False
        self.rayleigh_inv_background = None
        # Optional g-point mapping carried for scale_lut
        # (ref ckd_model.h:315-318)
        self.wavenumber_hr: Optional[np.ndarray] = None
        self.g_point: Optional[np.ndarray] = None
        self.save_min_max = True
        if self.is_sw() and self.rayleigh_molar_scat is None:
            self.calc_rayleigh_molar_scat()

    def is_sw(self) -> bool:
        return self.solar_irradiance is not None

    def calc_rayleigh_molar_scat(self):
        """Per-g-point Rayleigh coefficient: the SSI-weighted transmission
        of a 1000 hPa column at the reference zenith angle, per interval,
        mapped to g-points and back to a coefficient (ref
        ckd_model.h:368-385)."""
        wav_mid = 0.5 * (self.wavenumber1 + self.wavenumber2)
        molar_column = 1.0e5 * MOLES_PER_PA
        od_hr = molar_column * rayleigh_molar_scattering_coeff(wav_mid)
        trans_hr = np.exp(-od_hr / REFERENCE_COS_SZA)
        trans = (self.gpoint_fraction @ (self.ssi * trans_hr)
                 / (self.gpoint_fraction @ self.ssi))
        od = -np.log(np.maximum(1.0e-14, trans)) * REFERENCE_COS_SZA
        self.rayleigh_molar_scat = od / molar_column

    @property
    def molecules(self):
        return [g.molecule for g in self.single_gas_data]

    @property
    def ng(self) -> int:
        return self.gpoint_fraction.shape[0]

    @property
    def nt(self) -> int:
        return self.temperature.shape[0]

    @property
    def np_(self) -> int:
        return self.log_pressure.shape[0]

    @property
    def nwav(self) -> int:
        return self.gpoint_fraction.shape[1]

    def ngas(self) -> int:
        return len(self.single_gas_data)

    def gas(self, molecule: str) -> GasData:
        igas = self.get_gas_index(molecule)
        if igas < 0:
            raise KeyError(f"CKD model does not contain {molecule!r}")
        return self.single_gas_data[igas]

    def get_gas_index(self, gas: str) -> int:
        """Ref CkdModel::get_gas_index (ckd_model.h:211-239): empty string or
        'composite' matches the first concentration-independent gas."""
        if not gas:
            gas = "composite"
        mols = self.molecules
        if gas in mols:
            return mols.index(gas)
        if gas == "composite":
            for i, g in enumerate(self.single_gas_data):
                if g.conc_dependence == ConcDependence.NONE:
                    return i
        return -1

    # ------------------------------------------------------------------
    # Compute wrappers over gas_optics: tensors on the device of
    # ``pressure_hl`` when it is a tensor, else float64 on the CPU
    # ------------------------------------------------------------------
    def calc_optical_depth(self, gas, pressure_hl, temperature_fl,
                           vmr_fl=None, molar_abs_override=None):
        """Optical depth (ncol, nlay, ng) of one gas.

        ``molar_abs_override`` substitutes the LUT (e.g. the state during
        optimisation) while the geometry comes from the model."""
        g = self.gas(gas) if isinstance(gas, str) else self.single_gas_data[gas]
        pressure_hl = _tensor(pressure_hl)
        table = (molar_abs_override if molar_abs_override is not None
                 else _tensor(g.molar_abs, pressure_hl))
        return calc_optical_depth(
            g.conc_dependence, table, pressure_hl, temperature_fl,
            self.log_pressure, self.temperature, vmr_fl=vmr_fl,
            lut_vmr=g.vmr, reference_vmr=g.reference_vmr,
            logarithmic_interpolation=self.logarithmic_interpolation)

    def calc_planck_function(self, temperature):
        temperature = _tensor(temperature)
        return planck_from_lut(temperature, self.temperature_planck,
                               _tensor(self.planck_function, temperature))

    def calc_rayleigh_optical_depth(self, pressure_hl,
                                    rayleigh_override=None):
        pressure_hl = _tensor(pressure_hl)
        coeff = (rayleigh_override if rayleigh_override is not None
                 else _tensor(self.rayleigh_molar_scat, pressure_hl))
        return rayleigh_optical_depth(pressure_hl, coeff)

    def iband_per_g(self, wavenumber1_band, wavenumber2_band) -> np.ndarray:
        """Band index of each g-point (ref ckd_model.h:287-306)."""
        iband = np.full(self.ng, -1, np.int32)
        for ib in range(len(wavenumber1_band)):
            sel = ((self.wavenumber1 >= wavenumber1_band[ib])
                   & (self.wavenumber2 <= wavenumber2_band[ib]))
            weight = self.gpoint_fraction[:, sel].sum(axis=1)
            if np.any((weight > 0.05) & ((weight < 0.95) | (weight > 1.05))):
                raise ValueError(
                    "G-points do not lie entirely within requested bands: "
                    f"weights for band {wavenumber1_band[ib]}-"
                    f"{wavenumber2_band[ib]} cm-1 are {weight}")
            iband[weight > 0.5] = ib
        if np.any(iband < 0):
            raise ValueError("Some g-points not inside a band")
        return iband

    # ------------------------------------------------------------------
    # Optimisable state: the active gases' LUTs (and Rayleigh)
    # ------------------------------------------------------------------
    def set_active(self, active_gas_list: Optional[Sequence[str]]):
        """Flag the gases of ``active_gas_list`` (and "rayleigh" for a SW
        model) active for optimisation, as :meth:`read` does: None
        activates nothing, an empty list every gas."""
        activate_all = active_gas_list is not None and not active_gas_list
        active_set = set(active_gas_list or [])

        def is_active(mol):
            if active_gas_list is None:
                return False
            return activate_all or mol in active_set

        for g in self.single_gas_data:
            g.is_active = is_active(g.molecule)
        self.rayleigh_is_active = self.is_sw() and is_active("rayleigh")

    def active_lut_pytree(self) -> Dict[str, np.ndarray]:
        """LUT arrays of active gases (plus 'rayleigh' if active): the
        optimisation state."""
        tree = {g.molecule: g.molar_abs for g in self.single_gas_data
                if g.is_active}
        if self.rayleigh_is_active:
            tree["rayleigh"] = self.rayleigh_molar_scat
        return tree

    def set_active_lut_pytree(self, tree: Dict[str, np.ndarray]):
        for g in self.single_gas_data:
            if g.is_active:
                g.molar_abs = np.asarray(tree[g.molecule])
        if self.rayleigh_is_active:
            self.rayleigh_molar_scat = np.asarray(tree["rayleigh"])

    # ------------------------------------------------------------------
    # Prior / covariance machinery
    # ------------------------------------------------------------------
    def create_error_covariances(self, prior_error, min_prior_error=-1.0,
                                 max_prior_error=-1.0,
                                 prior_error_scaling=1.0,
                                 pressure_corr=0.5, temperature_corr=0.5,
                                 conc_corr=0.5, rayleigh_prior_error=-1.0):
        """Markov-correlation prior covariance per active gas
        (ref ckd_model.cpp:644-832): correlation^|index difference| over the
        (T, p[, conc]) grid, inverted and sparsified."""
        for g in self.single_gas_data:
            if not g.is_active:
                continue
            g.background_error = np.full(
                self.ng, prior_error if prior_error > 0.0 else 1.0)
            if g.conc_dependence == ConcDependence.LUT:
                nconc = len(g.vmr)
                c_idx, t_idx, p_idx = np.meshgrid(
                    np.arange(nconc), np.arange(self.nt), np.arange(self.np_),
                    indexing="ij")
                idx = [t_idx.ravel(), p_idx.ravel(), c_idx.ravel()]
                corrs = [temperature_corr, pressure_corr, conc_corr]
            else:
                t_idx, p_idx = np.meshgrid(np.arange(self.nt),
                                           np.arange(self.np_), indexing="ij")
                idx = [t_idx.ravel(), p_idx.ravel()]
                corrs = [temperature_corr, pressure_corr]
            nx = idx[0].size
            logs.log(f"  Creating {nx}x{nx} error covariance matrix for "
                     f"{g.Molecule}")
            background = np.ones((nx, nx))
            for iv, corr in zip(idx, corrs):
                background *= corr ** np.abs(iv[:, None] - iv[None, :])
            inv_background = np.linalg.inv(background)
            inv_background[np.abs(inv_background) < MIN_ERROR_COVARIANCE] = 0.0
            g.inv_background_shape = inv_background

            if prior_error <= 0.0:
                self._estimate_prior_error(g, prior_error_scaling)
            if min_prior_error > 0.0:
                g.background_error = np.maximum(min_prior_error,
                                                g.background_error)
            if max_prior_error > 0.0:
                g.background_error = np.minimum(g.background_error,
                                                max_prior_error)

        if rayleigh_prior_error > 0.0 and self.rayleigh_is_active:
            self.rayleigh_inv_background = np.full(
                self.ng, 1.0 / rayleigh_prior_error ** 2)
        else:
            self.rayleigh_inv_background = None

    def _estimate_prior_error(self, g: GasData, scaling: float):
        """Estimate per-g prior error of log(k) from min/max LUT bounds
        (ref ckd_model.cpp:720-745): mean over table points of
        0.25*log(max/min), or 0.5*log(max/k) where min is zero."""
        k = g.molar_abs
        flat = k.reshape(-1, k.shape[-1])
        fmin = g.min_molar_abs.reshape(-1, k.shape[-1])
        fmax = g.max_molar_abs.reshape(-1, k.shape[-1])
        pos = flat > 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            contrib = np.where(
                fmin > 0.0, 0.25 * np.log(fmax / np.where(fmin > 0, fmin, 1)),
                0.5 * np.log(np.where(flat > 0, fmax / np.where(pos, flat, 1),
                                      1.0)))
        contrib = np.where(pos, contrib, 0.0)
        count = pos.sum(axis=0)
        total = contrib.sum(axis=0)
        g.background_error = np.where(
            count > 0, scaling * total / np.maximum(count, 1),
            g.background_error)

    def calc_background_cost_function(self, delta_tree):
        """Prior cost and gradient from per-gas deltas of log(k).

        Ref CkdModel::calc_background_cost_function (ckd_model.cpp:838-877):
        per-g-point quadratic form with the shared inverse-correlation shape
        scaled by 1/background_error(g)^2, one matmul per gas: delta
        reshaped (nx, ng).  ``delta_tree`` holds tensors or arrays of each
        active gas's LUT shape; returns (cost, gradient tree) as tensors on
        the deltas' device."""
        cost = 0.0
        grads = {}
        for g in self.single_gas_data:
            if not g.is_active:
                continue
            delta = _tensor(delta_tree[g.molecule])
            ng = delta.shape[-1]
            d2 = delta.reshape(-1, ng)
            shape_mat = _tensor(g.inv_background_shape, d2)
            inv_var = 1.0 / _tensor(g.background_error, d2) ** 2
            grad = (shape_mat @ d2) * inv_var[None, :]
            cost = cost + 0.5 * torch.sum(d2 * grad)
            grads[g.molecule] = grad.reshape(delta.shape)
        if self.rayleigh_is_active and "rayleigh" in delta_tree:
            d = _tensor(delta_tree["rayleigh"])
            if self.rayleigh_inv_background is not None:
                grad = _tensor(self.rayleigh_inv_background, d) * d
                cost = cost + 0.5 * torch.sum(d * grad)
                grads["rayleigh"] = grad
            else:
                grads["rayleigh"] = torch.zeros_like(d)
        return cost, grads

    def cap_relative_linear_coeffts(self, ref_frac_trigger: float = 0.8):
        """Prevent negative od at zero concentration for relative-linear
        gases (ref ckd_model.cpp:881-917)."""
        bg = None
        rel_lin = []
        for g in self.single_gas_data:
            if g.conc_dependence == ConcDependence.NONE:
                bg = g
            elif (g.is_active
                  and g.conc_dependence == ConcDependence.RELATIVE_LINEAR):
                rel_lin.append(g)
        if not rel_lin:
            return
        if bg is None:
            logs.log("Unable to cap relative-linear coefficients: no "
                     "background composite gas found")
            return
        for g in rel_lin:
            cap = bg.molar_abs / (g.reference_vmr * ref_frac_trigger)
            nbad = int(np.sum(g.molar_abs > cap))
            if nbad > 0:
                logs.log(f"Correcting {nbad} {g.Molecule} coefficients that "
                         "could cause negative optical depth")
                g.molar_abs = np.minimum(g.molar_abs, cap)

    def scale_optical_depth(self, pressure_fl, scaling):
        """Scale every gas's LUT by a (nz, ng) factor interpolated onto the
        LUT pressure grid (ref ckd_model.cpp:1149-1176), clamped to min/max
        bounds where available.  Host numpy, as in the JAX package
        (``ecckd_tpu/models/ckd_model.py:383-400``)."""
        log_p_in = np.log(np.asarray(pressure_fl, np.float64))
        scaling = np.asarray(scaling, np.float64)
        local = np.empty((self.np_, scaling.shape[1]))
        for igcol in range(scaling.shape[1]):
            local[:, igcol] = np.interp(self.log_pressure, log_p_in,
                                        scaling[:, igcol])
        for g in self.single_gas_data:
            if g.conc_dependence == ConcDependence.LUT:
                g.molar_abs = g.molar_abs * local[None, None, :, :]
            else:
                g.molar_abs = g.molar_abs * local[None, :, :]
            if g.min_molar_abs is not None:
                g.molar_abs = np.maximum(
                    g.min_molar_abs, np.minimum(g.molar_abs, g.max_molar_abs))

    # ------------------------------------------------------------------
    # I/O: exact ckd-definition NetCDF schema
    # ------------------------------------------------------------------
    @classmethod
    def read(cls, file_name: str,
             active_gas_list: Optional[Sequence[str]] = None) -> "CkdModel":
        """Read a ckd-definition file (ref CkdModel::read,
        ckd_model.cpp:30-286).  With ``active_gas_list``, the named gases
        (and optionally "rayleigh") are flagged active for optimisation; an
        empty list activates all."""
        from ..io import NcFile

        logs.log(f"Reading CKD definition file {file_name}")
        f = NcFile(file_name)
        kwargs = {}
        is_sw = f.exist("solar_irradiance")
        if is_sw:
            kwargs["solar_irradiance"] = f.read("solar_irradiance")
            if f.exist("solar_spectral_irradiance"):
                kwargs["ssi"] = f.read("solar_spectral_irradiance")
            if f.exist("reference_total_solar_irradiance"):
                kwargs["reference_total_solar_irradiance"] = float(
                    f.read_scalar("reference_total_solar_irradiance"))
            if f.exist("rayleigh_molar_scattering_coeff"):
                kwargs["rayleigh_molar_scat"] = f.read(
                    "rayleigh_molar_scattering_coeff")
            else:
                raise ValueError("rayleigh_molar_scattering_coeff not present")
        else:
            kwargs["temperature_planck"] = f.read("temperature_planck")
            kwargs["planck_function"] = f.read("planck_function")

        temperature = f.read("temperature")
        pressure = f.read("pressure")
        molecules_str = f.attribute("constituent_id") or ""
        history = f.attribute("history", default="") or ""
        summary = f.attribute("summary", default="") or ""
        config = f.attribute("config", default="") or ""
        model_id = f.attribute("model_id", default="") or ""

        gases: List[GasData] = []
        have_min_max = None
        for molecule in molecules_str.split():
            g = GasData(molecule=molecule)
            varname = f"{molecule}_{K_NAME}"
            if have_min_max is None:
                have_min_max = f.exist(varname + "_min")
            mf_name = f"{molecule}_mole_fraction"
            if f.exist(mf_name) and len(f.size(mf_name)) == 1:
                g.conc_dependence = ConcDependence.LUT
                g.vmr = f.read(mf_name)
            else:
                code = int(f.read_scalar(
                    f"{molecule}_conc_dependence_code"))
                g.conc_dependence = ConcDependence(code)
                if g.conc_dependence == ConcDependence.NONE:
                    g.composite_vmr = f.read(mf_name)
                    g.composite_molecules = f.attribute(
                        f"{molecule}_constituent_id", default="") or ""
                elif g.conc_dependence == ConcDependence.RELATIVE_LINEAR:
                    g.reference_vmr = float(f.read_scalar(
                        f"{molecule}_reference_mole_fraction"))
            g.molar_abs = np.asarray(f.read(varname), np.float64)
            if have_min_max:
                g.min_molar_abs = np.asarray(f.read(varname + "_min"),
                                             np.float64)
                g.max_molar_abs = np.asarray(f.read(varname + "_max"),
                                             np.float64)
            gases.append(g)

        model = cls(
            gases, pressure, temperature,
            f.read("wavenumber1"), f.read("wavenumber2"),
            f.read("gpoint_fraction"),
            f.read("wavenumber1_band"), f.read("wavenumber2_band"),
            f.read("band_number"),
            history=history, config=config, summary=summary,
            model_id=model_id, **kwargs)
        if f.exist("g_point"):
            model.wavenumber_hr = f.read("wavenumber_hr")
            model.g_point = np.asarray(f.read("g_point"), np.int32)
        model.set_active(active_gas_list)
        f.close()
        return model

    def write(self, file_name: str, argv: Sequence[str] = (),
              config_str: str = ""):
        """Write a ckd-definition file with the reference's exact variable
        names, dimensions, types and attributes (ckd_model.cpp:288-641)."""
        from ..io import NcWriter, write_standard_attributes

        w = NcWriter(file_name)
        w.define_dimension("temperature", self.nt)
        w.define_dimension("pressure", self.np_)
        w.define_dimension("g_point", self.ng)
        sw = self.is_sw()
        if not sw:
            w.define_dimension("temperature_planck",
                               len(self.temperature_planck))
        w.define_dimension("wavenumber", self.nwav)
        w.define_dimension("band", len(self.wavenumber1_band))
        save_g = self.wavenumber_hr is not None
        if save_g:
            w.define_dimension("wavenumber_hr", len(self.wavenumber_hr))

        w.define_variable("n_gases", "int")
        w.write_long_name("Number of gases treated", "n_gases")
        w.write_comment('The gases are listed in the global attribute '
                        '"constituent_id".', "n_gases")
        w.define_variable("temperature", "float", "temperature", "pressure")
        w.write_long_name("Temperature", "temperature")
        w.write_units("K", "temperature")
        w.define_variable("pressure", "float", "pressure")
        w.write_long_name("Pressure", "pressure")
        w.write_units("Pa", "pressure")
        if sw:
            if self.reference_total_solar_irradiance > 0.0:
                w.define_variable("reference_total_solar_irradiance", "float")
                w.write_long_name("Reference total solar irradiance",
                                  "reference_total_solar_irradiance")
                w.write_units("W m-2", "reference_total_solar_irradiance")
            w.define_variable("solar_irradiance", "float", "g_point")
            w.write_long_name("Solar irradiance across each g point",
                              "solar_irradiance")
            w.write_units("W m-2", "solar_irradiance")
            if self.ssi is not None:
                w.define_variable("solar_spectral_irradiance", "float",
                                  "wavenumber")
                w.write_long_name("Solar irradiance in each spectral interval",
                                  "solar_spectral_irradiance")
                w.write_units("W m-2", "solar_spectral_irradiance")
        else:
            w.define_variable("temperature_planck", "float",
                              "temperature_planck")
            w.write_long_name("Temperature for Planck function look-up table",
                              "temperature_planck")
            w.write_units("K", "temperature_planck")
            w.define_variable("planck_function", "float",
                              "temperature_planck", "g_point")
            w.write_long_name("Planck function look-up table",
                              "planck_function")
            w.write_units("W m-2", "planck_function")

        w.define_variable("wavenumber1", "float", "wavenumber")
        w.write_long_name("Lower wavenumber bound of spectral interval",
                          "wavenumber1")
        w.write_units("cm-1", "wavenumber1")
        w.define_variable("wavenumber2", "float", "wavenumber")
        w.write_long_name("Upper wavenumber bound of spectral interval",
                          "wavenumber2")
        w.write_units("cm-1", "wavenumber2")
        w.define_variable("gpoint_fraction", "float", "g_point", "wavenumber")
        w.write_long_name("Fraction of spectrum contributing to each g-point",
                          "gpoint_fraction")
        w.define_variable("wavenumber1_band", "float", "band")
        w.write_long_name("Lower wavenumber bound of band", "wavenumber1_band")
        w.write_units("cm-1", "wavenumber1_band")
        w.define_variable("wavenumber2_band", "float", "band")
        w.write_long_name("Upper wavenumber bound of band", "wavenumber2_band")
        w.write_units("cm-1", "wavenumber2_band")
        w.define_variable("band_number", "short", "g_point")
        w.write_long_name("Band number of each g point", "band_number")

        if save_g:
            w.define_variable("wavenumber_hr", "double", "wavenumber_hr")
            w.write_long_name("High-resolution wavenumber", "wavenumber_hr")
            w.write_units("cm-1", "wavenumber_hr")
            w.define_variable("g_point", "short", "wavenumber_hr")
            w.write_long_name("G point", "g_point")

        xwave = "shortwave" if sw else "longwave"
        write_standard_attributes(
            w, "Definition of a correlated k-distribution model for "
            f"{xwave} gas absorption")
        if sw:
            w.define_variable("rayleigh_molar_scattering_coeff", "float",
                              "g_point")
            w.write_long_name("Rayleigh molar scattering coefficient in each "
                              "g-point", "rayleigh_molar_scattering_coeff")
            w.write_units("m2 mol-1", "rayleigh_molar_scattering_coeff")
        if self.model_id:
            w.write_attribute(self.model_id, "model_id")
        w.write_attribute(" ".join(self.molecules), "constituent_id")

        for g in self.single_gas_data:
            self._define_gas(w, g)

        if self.history:
            w.write_attribute(self.history, "history")
        w.append_history(argv)
        if self.config:
            w.write_attribute(self.config + "\n" + config_str, "config")
        else:
            w.write_attribute(config_str, "config")
        if not self.summary:
            self.summary = (
                "This file contains the description of a correlated "
                "k-distribution model for computing\n"
                f"{xwave} gas absorption in the terrestrial atmosphere.  "
                "The molar absorption coefficient\n"
                "of each gas and each g point (k term or spectral interval) "
                "is implemented as a look-up\n"
                "table versus temperature, pressure, and optionally mole "
                "fraction.  The optical depths of\n"
                "each gas should be summed.  The model was created in a "
                "multi-step process as described by\n"
                "each line of the history and config global attributes.")
        w.write_attribute(self.summary, "summary")

        w.write(self.ngas(), "n_gases")
        w.write(np.exp(self.log_pressure), "pressure")
        w.write(self.temperature, "temperature")
        if sw:
            if self.reference_total_solar_irradiance > 0.0:
                w.write(self.reference_total_solar_irradiance,
                        "reference_total_solar_irradiance")
            w.write(self.solar_irradiance, "solar_irradiance")
            w.write(self.rayleigh_molar_scat,
                    "rayleigh_molar_scattering_coeff")
            if self.ssi is not None:
                w.write(self.ssi, "solar_spectral_irradiance")
        else:
            w.write(self.temperature_planck, "temperature_planck")
            w.write(self.planck_function, "planck_function")
        w.write(self.wavenumber1, "wavenumber1")
        w.write(self.wavenumber2, "wavenumber2")
        w.write(self.gpoint_fraction, "gpoint_fraction")
        w.write(self.wavenumber1_band, "wavenumber1_band")
        w.write(self.wavenumber2_band, "wavenumber2_band")
        w.write(self.band_number, "band_number")
        if save_g:
            w.write(self.wavenumber_hr, "wavenumber_hr")
            w.write(self.g_point, "g_point")

        for g in self.single_gas_data:
            varname = f"{g.molecule}_{K_NAME}"
            w.write(int(g.conc_dependence),
                    f"{g.molecule}_conc_dependence_code")
            if g.conc_dependence == ConcDependence.NONE:
                w.write(g.composite_vmr, f"{g.molecule}_mole_fraction")
            elif g.conc_dependence == ConcDependence.RELATIVE_LINEAR:
                w.write(g.reference_vmr,
                        f"{g.molecule}_reference_mole_fraction")
            elif g.conc_dependence == ConcDependence.LUT:
                w.write(g.vmr, f"{g.molecule}_mole_fraction")
            w.write(g.molar_abs, varname)
            if self.save_min_max and g.min_molar_abs is not None:
                w.write(g.min_molar_abs, varname + "_min")
                w.write(g.max_molar_abs, varname + "_max")
        w.close()

    def _define_gas(self, w, g: GasData):
        molecule, Molecule = g.molecule, g.Molecule
        varname = f"{molecule}_{K_NAME}"
        w.define_variable(f"{molecule}_conc_dependence_code", "short")
        w.write_long_name(f"{Molecule} concentration dependence code",
                          f"{molecule}_conc_dependence_code")
        w.write_attribute(
            "0: No dependence of absorption on concentration "
            "(background gases)\n"
            "1: Absorption varies linearly with concentration\n"
            "2: Look-up table for concentration-dependence of absorption\n"
            "3: Linear dependence on concentration minus a reference "
            "value",
            "definition", f"{molecule}_conc_dependence_code")
        has_min_max = self.save_min_max and g.min_molar_abs is not None
        tp = ("temperature", "pressure", "g_point")
        if g.conc_dependence == ConcDependence.NONE:
            w.define_variable(varname, "float", *tp)
            w.write_long_name("Molar absorption coefficient of background "
                              "gases", varname)
            w.write_units("m2 mol-1", varname)
            w.write_comment("This is the absorption cross section of "
                            "background gases per mole of dry air.", varname)
            if has_min_max:
                self._define_min_max(w, varname, "background gases", tp)
            w.define_dimension(f"{molecule}_gas", g.composite_vmr.shape[0])
            w.define_variable(f"{molecule}_mole_fraction", "float",
                              f"{molecule}_gas", "pressure")
            w.write_long_name(
                f"Mole fractions of the gases that make up {Molecule}",
                f"{molecule}_mole_fraction")
            w.write_units("1", f"{molecule}_mole_fraction")
            w.write_comment(
                f"The gases that make up {Molecule} are listed in the "
                f'global attribute "{molecule}_constituent_id".',
                f"{molecule}_mole_fraction")
            w.write_attribute(g.composite_molecules,
                              f"{molecule}_constituent_id")
        elif g.conc_dependence in (ConcDependence.LINEAR,
                                   ConcDependence.RELATIVE_LINEAR):
            if g.conc_dependence == ConcDependence.RELATIVE_LINEAR:
                w.define_variable(f"{molecule}_reference_mole_fraction",
                                  "float")
                w.write_long_name(f"Reference mole fraction of {Molecule}",
                                  f"{molecule}_reference_mole_fraction")
                w.write_units("1", f"{molecule}_reference_mole_fraction")
                w.write_comment(
                    "Subtract this from input mole fractions before "
                    f"multiplying by {varname}",
                    f"{molecule}_reference_mole_fraction")
            w.define_variable(varname, "float", *tp)
            w.write_long_name(f"Molar absorption coefficient of {Molecule}",
                              varname)
            w.write_units("m2 mol-1", varname)
            if has_min_max:
                self._define_min_max(w, varname, Molecule, tp)
        else:   # LUT
            w.define_dimension(f"{molecule}_mole_fraction", len(g.vmr))
            w.define_variable(f"{molecule}_mole_fraction", "float",
                              f"{molecule}_mole_fraction")
            w.write_long_name(f"{Molecule} mole fraction for look-up table",
                              f"{molecule}_mole_fraction")
            w.write_units("1", f"{molecule}_mole_fraction")
            w.define_variable(varname, "float", f"{molecule}_mole_fraction",
                              *tp)
            w.write_long_name(f"Molar absorption coefficient of {Molecule}",
                              varname)
            w.write_units("m2 mol-1", varname)
            if has_min_max:
                self._define_min_max(w, varname, Molecule,
                                     (f"{molecule}_mole_fraction",) + tp)

    @staticmethod
    def _define_min_max(w, varname: str, label: str, dims):
        w.define_variable(varname + "_min", "float", *dims)
        w.write_long_name(f"Minimum molar absorption coefficient of {label}",
                          varname + "_min")
        w.write_units("m2 mol-1", varname + "_min")
        w.define_variable(varname + "_max", "float", *dims)
        w.write_long_name(f"Maximum molar absorption coefficient of {label}",
                          varname + "_max")
        w.write_units("m2 mol-1", varname + "_max")
