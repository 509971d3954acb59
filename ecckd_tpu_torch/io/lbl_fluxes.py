"""LblFluxes: container/reader of line-by-line training fluxes.

The port's own copy of ``ecckd_tpu/io/lbl_fluxes.py`` (ref
src/ecckd/lbl_fluxes.{h,cpp}): reads CKDMIP-style LBL flux files, expands
the three SW solar zenith angles into pseudo-columns (mu0 indices
{0, 2, 4}, lbl_fluxes.cpp:82), computes heating rates on read, maps narrow
to wide bands, maps high-resolution boundary fluxes to g-points, computes
the erythemal UV weighting spectrum, and provides ``subtract`` for forcing
(relative-to) mode, ``mask_rayleigh_up``, and reference CKD flux
evaluation on the port's ``rt_lw`` / ``rt_norayleigh_sw``.

Only :meth:`LblFluxes.read` touches the file (and h5py, imported inside
it); fluxes built from arrays take :meth:`LblFluxes.calc_heating_rates`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .. import constants as c
from .. import logs
from ..ops.planck import planck_function

# SW solar zenith angles used for training (ref lbl_fluxes.cpp:82)
SW_SZA_INDICES = (0, 2, 4)


@dataclasses.dataclass
class LblFluxes:
    pressure_hl: np.ndarray = None          # (ncol, nlev+1)
    temperature_hl: np.ndarray = None       # (ncol, nlev+1)
    vmr_fl: np.ndarray = None               # (ncol, ngas, nlay)
    flux_up: np.ndarray = None              # (ncol, nlev+1) broadband
    flux_dn: np.ndarray = None
    spectral_flux_up: np.ndarray = None     # (ncol, nlev+1, nspec)
    spectral_flux_dn: np.ndarray = None
    spectral_flux_dn_surf: np.ndarray = None   # (ncol, ng)
    spectral_flux_up_toa: np.ndarray = None
    heating_rate: np.ndarray = None         # (ncol, nlay) K s-1
    spectral_heating_rate: np.ndarray = None
    mu0: np.ndarray = None                  # (ncol,)
    effective_spectral_albedo: np.ndarray = None  # (nspec,)
    surf_emissivity: np.ndarray = None      # (ncol, nspec)
    surf_planck: np.ndarray = None          # (ncol, ng) filled by caller
    planck_hl: np.ndarray = None            # (ncol, nlev+1, ng) by caller
    solar_irradiance: np.ndarray = None     # (ng,) by caller
    erythemal_spectrum: np.ndarray = None   # (ng,)
    molecules: List[str] = dataclasses.field(default_factory=list)
    tsi: float = -1.0
    have_spectral_fluxes: bool = False
    have_band_fluxes: bool = False
    band_wavenumber1: np.ndarray = None
    band_wavenumber2: np.ndarray = None
    iband_per_g: np.ndarray = None
    gas_mapping: np.ndarray = None
    is_sw: bool = False

    @property
    def ncol(self):
        return self.pressure_hl.shape[0]

    def nspec(self):
        return self.spectral_flux_up.shape[2]

    # ------------------------------------------------------------------
    @classmethod
    def read(cls, file_name: str, band_mapping: Optional[np.ndarray] = None,
             g_point: Optional[np.ndarray] = None) -> "LblFluxes":
        from .ncio import NcFile

        logs.log(f"Reading LBL fluxes from {file_name}")
        self = cls()
        f = NcFile(file_name)
        self.pressure_hl = np.asarray(f.read("pressure_hl"), np.float64)
        self.temperature_hl = np.asarray(f.read("temperature_hl"),
                                         np.float64)
        self.vmr_fl = np.asarray(f.read("mole_fraction_fl"), np.float64)
        ncol, nlev1 = self.pressure_hl.shape
        nlev = nlev1 - 1

        self.is_sw = f.exist("mu0")
        if self.is_sw:
            self._read_sw(f, band_mapping, g_point, ncol, nlev)
        else:
            self._read_lw(f, band_mapping, g_point, ncol, nlev)

        molecules_str = f.attribute("constituent_id", default="") or ""
        logs.log(f"  Contains {molecules_str}")
        for molecule in molecules_str.split():
            if "-" in molecule:
                new = molecule.split("-", 1)[0]
                logs.log(f"  Renaming {molecule} to {new}")
                molecule = new
            self.molecules.append(molecule)

        self.calc_heating_rates()
        nspec = self.spectral_flux_up.shape[2] \
            if self.spectral_flux_up is not None else 0
        self.surf_emissivity = np.ones((self.ncol, max(nspec, 1)))
        f.close()
        return self

    def calc_heating_rates(self):
        """Heating rates from the fluxes; SW neglects the upwelling
        contribution (ref lbl_fluxes.cpp:355-386)."""
        conv = (-(c.ACCEL_GRAVITY / c.SPECIFIC_HEAT_AIR)
                / np.diff(self.pressure_hl, axis=1))
        if self.is_sw:
            self.heating_rate = conv * np.diff(self.flux_dn, axis=1)
            if self.have_spectral_fluxes:
                self.spectral_heating_rate = (
                    conv[:, :, None] * np.diff(self.spectral_flux_dn,
                                               axis=1))
        else:
            self.heating_rate = conv * (np.diff(self.flux_dn, axis=1)
                                        - np.diff(self.flux_up, axis=1))
            if self.have_spectral_fluxes:
                self.spectral_heating_rate = conv[:, :, None] * (
                    np.diff(self.spectral_flux_dn, axis=1)
                    - np.diff(self.spectral_flux_up, axis=1))

    # ------------------------------------------------------------------
    def _read_sw(self, f, band_mapping, g_point, ncol, nlev):
        mu0_all = np.asarray(f.read("mu0"), np.float64)
        index_sza = np.asarray(SW_SZA_INDICES)
        index_sza = index_sza[index_sza < len(mu0_all)]
        nsza = len(index_sza)
        ncol_new = ncol * nsza

        if nsza > 1:
            self.pressure_hl = np.repeat(self.pressure_hl, nsza, axis=0)
            self.temperature_hl = np.repeat(self.temperature_hl, nsza,
                                            axis=0)
            self.vmr_fl = np.repeat(self.vmr_fl, nsza, axis=0)

        fd = np.asarray(f.read("flux_dn_direct_sw"), np.float64)
        fu = np.asarray(f.read("flux_up_sw"), np.float64)
        # (col, sza, lev) -> interleaved (col*sza, lev)
        self.flux_dn = fd[:, index_sza, :].reshape(ncol_new, nlev + 1)
        self.flux_up = fu[:, index_sza, :].reshape(ncol_new, nlev + 1)
        self.mu0 = np.tile(mu0_all[index_sza], ncol)
        self.tsi = self.flux_dn[0, 0] / self.mu0[0]

        sp_dn = sp_up = None
        if f.exist("spectral_flux_dn_direct_sw"):
            sp_dn = np.asarray(f.read("spectral_flux_dn_direct_sw"),
                               np.float64)
            sp_up = np.asarray(f.read("spectral_flux_up_sw"), np.float64)
            self.have_spectral_fluxes = True
        elif f.exist("band_flux_dn_direct_sw"):
            sp_dn = np.asarray(f.read("band_flux_dn_direct_sw"), np.float64)
            sp_up = np.asarray(f.read("band_flux_up_sw"), np.float64)
            self.have_spectral_fluxes = True
            self.have_band_fluxes = True
            self.band_wavenumber1 = np.asarray(
                f.read("band_wavenumber1_sw"), np.float64)
            self.band_wavenumber2 = np.asarray(
                f.read("band_wavenumber2_sw"), np.float64)

        if self.have_spectral_fluxes:
            nspec = sp_dn.shape[3]
            self.spectral_flux_dn = sp_dn[:, index_sza].reshape(
                ncol_new, nlev + 1, nspec)
            self.spectral_flux_up = sp_up[:, index_sza].reshape(
                ncol_new, nlev + 1, nspec)
            self._update_albedo()
            if self.have_band_fluxes and band_mapping is not None \
                    and len(band_mapping):
                self._map_bands_sw(np.asarray(band_mapping))

        if (f.exist("spectral_flux_dn_direct_surf_sw")
                and f.exist("spectral_flux_up_toa_sw")):
            if g_point is None or len(g_point) == 0:
                logs.warning("Surface/TOA spectral fluxes ignored because "
                             "g-point file not provided")
            else:
                self._read_boundary_fluxes_sw(f, g_point, ncol, index_sza)

    def _update_albedo(self):
        dn = self.spectral_flux_dn[:, -1, :].sum(0)
        up = self.spectral_flux_up[:, -1, :].sum(0)
        # Guard fully-extinguished g-points (the reference divides directly,
        # lbl_fluxes.cpp:147-148, but enables FPE trapping so its inputs
        # never reach 0/0)
        self.effective_spectral_albedo = np.where(dn > 0.0, up
                                                  / np.where(dn > 0, dn, 1.0),
                                                  0.0)

    def _map_bands_sw(self, band_mapping):
        nband = int(band_mapping.max()) + 1
        logs.log(f"  Mapping fluxes from {len(band_mapping)} to {nband} "
                 "bands")
        onehot = band_mapping[:, None] == np.arange(nband)[None, :]
        self.spectral_flux_dn = self.spectral_flux_dn @ onehot
        self.spectral_flux_up = self.spectral_flux_up @ onehot
        self._update_albedo()
        self.band_wavenumber1 = np.array(
            [self.band_wavenumber1[band_mapping == j].min()
             for j in range(nband)])
        self.band_wavenumber2 = np.array(
            [self.band_wavenumber2[band_mapping == j].max()
             for j in range(nband)])

    def _read_boundary_fluxes_sw(self, f, g_point, ncol, index_sza):
        logs.log("  Mapping high-resolution boundary fluxes to g-points")
        g_point = np.asarray(g_point, np.int64)
        ng = int(g_point.max()) + 1
        nsza = len(index_sza)
        self.spectral_flux_dn_surf = np.zeros((ncol * nsza, ng))
        self.spectral_flux_up_toa = np.zeros((ncol * nsza, ng))

        # Erythemal spectrum (Webb et al. 2011), sqrt-weighted
        # (ref lbl_fluxes.cpp:196-230)
        wavenumber = np.asarray(f.read("wavenumber"), np.float64)
        wavelength_nm = 1.0e7 / wavenumber
        ery = np.zeros_like(wavenumber)
        ery[(wavelength_nm > 250.0) & (wavelength_nm <= 298.0)] = 1.0
        sel = (wavelength_nm > 298.0) & (wavelength_nm <= 328.0)
        ery[sel] = 10.0 ** (0.094 * (298.0 - wavelength_nm[sel]))
        sel = (wavelength_nm > 328.0) & (wavelength_nm <= 400.0)
        ery[sel] = 10.0 ** (0.015 * (140.0 - wavelength_nm[sel]))
        ery = np.sqrt(ery)
        d_wav = np.empty_like(wavenumber)
        d_wav[1:-1] = 0.5 * (wavenumber[2:] - wavenumber[:-2])
        d_wav[0] = 0.5 * d_wav[1]
        d_wav[-1] = 0.5 * d_wav[-2]
        planck = planck_function(np.array([5777.0]),
                                 torch.as_tensor(wavenumber),
                                 torch.as_tensor(d_wav)).numpy()[0]
        onehot = g_point[:, None] == np.arange(ng)[None, :]
        num = (ery * planck) @ onehot
        den = planck @ onehot
        self.erythemal_spectrum = num / np.where(den > 0, den, 1.0)

        icol_new = 0
        for icol in range(ncol):
            for isza in index_sza:
                up = np.asarray(f.read("spectral_flux_up_toa_sw",
                                       index=icol, index2=int(isza)),
                                np.float64)
                dn = np.asarray(f.read("spectral_flux_dn_direct_surf_sw",
                                       index=icol, index2=int(isza)),
                                np.float64)
                self.spectral_flux_dn_surf[icol_new] = dn @ onehot
                self.spectral_flux_up_toa[icol_new] = up @ onehot
                icol_new += 1

    # ------------------------------------------------------------------
    def _read_lw(self, f, band_mapping, g_point, ncol, nlev):
        self.flux_dn = np.asarray(f.read("flux_dn_lw"), np.float64)
        self.flux_up = np.asarray(f.read("flux_up_lw"), np.float64)
        if f.exist("spectral_flux_up_lw"):
            self.spectral_flux_up = np.asarray(f.read("spectral_flux_up_lw"),
                                               np.float64)
            self.spectral_flux_dn = np.asarray(f.read("spectral_flux_dn_lw"),
                                               np.float64)
            self.have_spectral_fluxes = True
        elif f.exist("band_flux_up_lw"):
            up = np.asarray(f.read("band_flux_up_lw"), np.float64)
            dn = np.asarray(f.read("band_flux_dn_lw"), np.float64)
            wn1 = np.asarray(f.read("band_wavenumber1_lw"), np.float64)
            wn2 = np.asarray(f.read("band_wavenumber2_lw"), np.float64)
            if band_mapping is not None and len(band_mapping):
                bm = np.asarray(band_mapping)
                nband = int(bm.max()) + 1
                logs.log(f"  Mapping fluxes from {up.shape[2]} to {nband} "
                         "bands")
                onehot = bm[:, None] == np.arange(nband)[None, :]
                up = up @ onehot
                dn = dn @ onehot
                wn1 = np.array([wn1[bm == j].min() for j in range(nband)])
                wn2 = np.array([wn2[bm == j].max() for j in range(nband)])
            self.spectral_flux_up = up
            self.spectral_flux_dn = dn
            self.band_wavenumber1 = wn1
            self.band_wavenumber2 = wn2
            self.have_spectral_fluxes = True
            self.have_band_fluxes = True

        if (f.exist("spectral_flux_dn_surf_lw")
                and f.exist("spectral_flux_up_toa_lw")):
            if g_point is None or len(g_point) == 0:
                logs.warning("Surface/TOA spectral fluxes ignored because "
                             "g-point file not provided")
            else:
                logs.log("  Mapping high-resolution boundary fluxes to "
                         "g-points")
                gp = np.asarray(g_point, np.int64)
                ng = int(gp.max()) + 1
                onehot = (gp[:, None]
                          == np.arange(ng)[None, :]).astype(np.float64)
                self.spectral_flux_dn_surf = np.zeros((ncol, ng))
                self.spectral_flux_up_toa = np.zeros((ncol, ng))
                for icol in range(ncol):
                    up = np.asarray(f.read("spectral_flux_up_toa_lw",
                                           index=icol), np.float64)
                    dn = np.asarray(f.read("spectral_flux_dn_surf_lw",
                                           index=icol), np.float64)
                    self.spectral_flux_dn_surf[icol] = dn @ onehot
                    self.spectral_flux_up_toa[icol] = up @ onehot

    # ------------------------------------------------------------------
    def make_gas_mapping(self, molecules: List[str]):
        """CKD gas index -> LBL concentration index, -1 if missing
        (ref lbl_fluxes.cpp:399-412)."""
        self.gas_mapping = np.full(len(molecules), -1, np.int64)
        for igas, mol in enumerate(molecules):
            for igas2, mol2 in enumerate(self.molecules):
                if mol2 == mol:
                    self.gas_mapping[igas] = igas2

    def mask_rayleigh_up(self, max_no_rayleigh_wavenumber: float):
        """Zero upwelling for bands affected by Rayleigh scattering
        (ref lbl_fluxes.cpp:414-429)."""
        if self.band_wavenumber2 is None:
            return
        index = np.nonzero(self.band_wavenumber2
                           > max_no_rayleigh_wavenumber)[0]
        if len(index):
            self.effective_spectral_albedo[index] = 0.0
            self.spectral_flux_up[:, :, index] = 0.0
            self.flux_up[:] = 0.0
            logs.log(f"Ignoring upwelling for bands {index} because "
                     "Rayleigh scattering not modelled")

    def subtract(self, source: "LblFluxes"):
        """Forcing mode: subtract a reference set of fluxes
        (ref lbl_fluxes.cpp:431-440)."""
        self.flux_up = self.flux_up - source.flux_up
        self.flux_dn = self.flux_dn - source.flux_dn
        self.spectral_flux_up = (self.spectral_flux_up
                                 - source.spectral_flux_up)
        self.spectral_flux_dn = (self.spectral_flux_dn
                                 - source.spectral_flux_dn)
        self.heating_rate = self.heating_rate - source.heating_rate
        self.spectral_heating_rate = (self.spectral_heating_rate
                                      - source.spectral_heating_rate)

    def calc_ckd_fluxes(self, optical_depth, device="cuda"):
        """Reference CKD fluxes for this scenario (ref lbl_fluxes.cpp:442-472)
        from the optical depth (nprof, nlay, ng), computed on ``device``
        (the card unless ``device="cpu"``) in the dtype of
        ``optical_depth`` when it is a tensor, else float64.

        Returns (flux_dn, flux_up), each (nprof, nlev+1, ng) numpy."""
        from ..ops import rt_lw, rt_norayleigh_sw
        from ..tools.common import resolve_device

        dev = resolve_device(device)
        od = torch.as_tensor(optical_depth, device=dev)
        if not od.is_floating_point():
            od = od.double()
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=od.dtype,
                                      device=dev)
        od = od.movedim(-2, 0)
        if self.is_sw:
            tsi_scaling = self.tsi / self.solar_irradiance.sum()
            albedo_g = f(self.effective_spectral_albedo[self.iband_per_g]
                         if self.iband_per_g is not None
                         else self.effective_spectral_albedo)
            ssi_g = f(tsi_scaling * self.solar_irradiance)
            fd, fu = rt_norayleigh_sw(f(self.mu0)[:, None], ssi_g, od,
                                      albedo_g)
        else:
            iband = (self.iband_per_g if self.iband_per_g is not None
                     else np.arange(self.nspec()))
            fd, fu = rt_lw(f(self.planck_hl).movedim(-2, 0), od,
                           f(self.surf_emissivity[:, iband]),
                           f(self.surf_planck))
        return (fd.movedim(0, -2).cpu().numpy(),
                fu.movedim(0, -2).cpu().numpy())
