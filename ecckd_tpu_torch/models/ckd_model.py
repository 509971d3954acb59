"""CkdModel: the CKD gas-optics model container and its ckd-definition
file.

PyTorch-package counterpart of ``ecckd_tpu/models/ckd_model.py``
(ref ckd_model.{h,cpp}).  The container holds numpy arrays; what is ported
so far is what create_lut needs: :class:`GasData`, the LW and SW
constructor (SW models get their per-g-point Rayleigh coefficient) and
:meth:`CkdModel.write` with the reference's exact ckd-definition schema
(ckd_model.cpp:288-641).  Reading, optical-depth evaluation and the
optimizer state come with optimize_lut (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..constants import K_NAME, MOLES_PER_PA, REFERENCE_COS_SZA
from ..ops.rayleigh import rayleigh_molar_scattering_coeff
from .gas_optics import ConcDependence


@dataclasses.dataclass
class GasData:
    """Per-gas LUT data (ref SingleGasData, ckd_model.h:37-103)."""
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
