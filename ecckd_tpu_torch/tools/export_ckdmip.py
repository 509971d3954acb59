"""export_ckdmip: publish CKD artifacts under CKDMIP naming.

The port's own copy of ``ecckd_tpu/tools/export_ckdmip.py``, the
equivalent of test/rename_ckd_definition.sh and
test/copy_to_ckdmip_{lw,sw}.sh: the working pipeline names models by
their heating-rate tolerance (``<app>_<band>-tol<T>``); the CKDMIP
archive names them by g-point count (``<app>_<band>-<NG>``) and sorts
files into ``<mode>_spectral-definition/``, ``<mode>_optical-depth/``
and ``<mode>_fluxes/`` directories.  The g-point count is read from the
ckd-definition file itself (copy_to_ckdmip_lw.sh:72).

Config keys:
  input            ckd-definition NetCDF file (required)
  results_dir      CKDMIP results root (required)
  mode             lw | sw (default lw)
  application      e.g. climate (required)
  band_structure   e.g. fsck (required)
  model_code       old code to substitute in companion files
                   (default "<application>_<band_structure>-tol<tolerance>")
  tolerance        used only to build the default model_code
  prefix           file prefix (default "ecckd")
  ng_suffix        training-data code appended to NG (e.g. "b", "t", "bt";
                   copy_to_ckdmip_lw.sh:75-89)
  companions       optional directories holding optical-depth / flux files
                   whose names contain model_code; each matching file is
                   copied with the code substituted
"""

from __future__ import annotations

import glob
import os
import shutil
import sys
from typing import List

from .. import logs
from ..config import Config
from .common import tool_prologue, read_string_list


def _ng_of(path: str) -> int:
    from ..io import NcFile

    with NcFile(path) as f:
        if f.exist("band_number"):
            return f.size("band_number")[0]
        if f.exist("gpoint_fraction"):
            return f.size("gpoint_fraction")[0]
    raise ValueError(f"Cannot determine g-point count of {path}")


def export_ckdmip(cfg: Config, argv=()) -> List[str]:
    input_file = cfg.read_string("input")
    results_dir = cfg.read_string("results_dir")
    mode = cfg.read_string("mode", default="lw")
    application = cfg.read_string("application")
    band = cfg.read_string("band_structure")
    prefix = cfg.read_string("prefix", default="ecckd")
    ng_suffix = cfg.read_string("ng_suffix", default="")
    tolerance = cfg.read_string("tolerance", default=None)
    model_code = cfg.read_string("model_code", default=None)
    if model_code is None:
        model_code = f"{application}_{band}"
        if tolerance is not None:
            model_code += f"-tol{tolerance}"

    ng = _ng_of(input_file)
    new_code = f"{application}_{band}-{ng}{ng_suffix}"
    logs.log(f"Model {model_code} has {ng} g points -> {new_code}")

    written: List[str] = []
    spec_dir = os.path.join(results_dir, f"{mode}_spectral-definition")
    os.makedirs(spec_dir, exist_ok=True)
    new_def = os.path.join(
        spec_dir, f"{prefix}_{mode}_{new_code}_spectral-definition.nc")
    logs.log(f"Copying {input_file} -> {new_def}")
    shutil.copyfile(input_file, new_def)
    written.append(new_def)

    companions = (read_string_list(cfg, "companions")
                  if cfg.exist("companions") else [])
    for comp_dir in companions:
        for path in sorted(glob.glob(os.path.join(comp_dir, "*.nc"))):
            name = os.path.basename(path)
            if model_code not in name:
                continue
            if "optical-depth" in name or "od" in name.split("_"):
                sub = f"{mode}_optical-depth"
            else:
                sub = f"{mode}_fluxes"
            out_dir = os.path.join(results_dir, sub)
            os.makedirs(out_dir, exist_ok=True)
            new_name = name.replace(model_code, new_code)
            dst = os.path.join(out_dir, new_name)
            logs.log(f"Copying {path} -> {dst}")
            shutil.copyfile(path, dst)
            written.append(dst)
    return written


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: export_ckdmip(tool_prologue(argv), argv=["export_ckdmip"] + argv),
        name="export_ckdmip")


if __name__ == "__main__":
    sys.exit(main())
