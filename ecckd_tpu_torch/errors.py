"""ESA exit codes, typed fatal exceptions and signal handlers.

Equivalent of the reference's Error.h:20-65 + EsaExitCodes.h:16-51
("EarthCARE PDGS Generic IPF Interface Specifications": exit codes are
part of the tool API).  Every CLI tool routes its ``main`` through
:func:`run_tool`, which maps exceptions to the ESA codes, prints the
coded message, and optionally a stack trace (``ECCKD_TRACE=1`` or
``set_trace_exceptions(True)`` — the reference re-raises to preserve the
trace for a debugger; Python can always print it).

The port's own copy of ``ecckd_tpu/errors.py``: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import os
import signal
import sys
import traceback
from typing import Callable, Dict

# -- ESA exit codes (EsaExitCodes.h:16-51) ---------------------------------
EXIT_OK = 0
JOB_ORDER_READ_ERROR = 128
PREMATURE_TERMINATION = 129
OUT_OF_MEMORY = 130
UNEXPECTED_EXCEPTION = 131
DISK_FULL = 132
XML_ERROR = 133
XML_WARNING = 1
MISSING_MANDATORY_FILE = 134
NOT_ENOUGH_INPUT_ERROR = 135
CRITICAL_FRAME_FAILURE = 136
PRODUCT_FORMAT_ERROR = 137
NO_PRODUCT_FOUND_ERROR = 138
CANNOT_OPEN_MANDATORY_FILE = 139
NO_AUX_FILE_ERROR = 140
BAD_MANDATORY_AUX_FORMAT = 141
NO_PRODUCT_MODEL = 142
READ_ERROR_PRODUCT_MODEL = 143
FINAL_PRODUCT_CREATION_ERROR = 144
TEMP_FILE_CREATION_ERROR = 145
WRITE_ERROR = 146
PARAMETER_ERROR = 147
PROCESSING_ERROR = 148

_ERROR_MSG: Dict[int, str] = {
    EXIT_OK: "OK",
    JOB_ORDER_READ_ERROR: "Job order error",
    PREMATURE_TERMINATION: "Premature termination",
    OUT_OF_MEMORY: "Out of memory",
    UNEXPECTED_EXCEPTION: "Unexpected exception",
    DISK_FULL: "Disk full",
    XML_ERROR: "XML error",
    MISSING_MANDATORY_FILE: "Missing mandatory file",
    NOT_ENOUGH_INPUT_ERROR: "Mandatory input data missing",
    CRITICAL_FRAME_FAILURE: "Critical frame failure",
    PRODUCT_FORMAT_ERROR: "Product format error",
    NO_PRODUCT_FOUND_ERROR: "No product found",
    CANNOT_OPEN_MANDATORY_FILE: "Cannot open mandatory file",
    NO_AUX_FILE_ERROR: "No auxiliary file",
    BAD_MANDATORY_AUX_FORMAT: "Bad mandatory auxiliary format",
    NO_PRODUCT_MODEL: "No product model",
    READ_ERROR_PRODUCT_MODEL: "Read error in product model",
    FINAL_PRODUCT_CREATION_ERROR: "Final product creation error",
    TEMP_FILE_CREATION_ERROR: "Temporary file creation error",
    WRITE_ERROR: "Write error",
    PARAMETER_ERROR: "Parameter error",
    PROCESSING_ERROR: "Processing error",
}


def error_code_msg(code: int) -> str:
    """Human-readable message for an ESA exit code (Error.h:62)."""
    return _ERROR_MSG.get(code, f"Unknown exit code {code}")


# -- typed fatal exceptions (Error.h:27-37) ---------------------------------
class FatalException(Exception):
    exit_code = UNEXPECTED_EXCEPTION


class SegmentationFault(FatalException):
    exit_code = CRITICAL_FRAME_FAILURE


class FloatingPointException(FatalException):
    exit_code = PROCESSING_ERROR


class Interrupt(FatalException):
    exit_code = PREMATURE_TERMINATION


class ParameterError(FatalException):
    """Bad or missing configuration parameter."""
    exit_code = PARAMETER_ERROR


class ProcessingError(FatalException):
    """Algorithmic failure (e.g. minimizer produced an invalid cost)."""
    exit_code = PROCESSING_ERROR


_trace_exceptions = [os.environ.get("ECCKD_TRACE", "") == "1"]


def set_trace_exceptions(b: bool):
    """Print a stack trace for fatal exceptions (Error.h:41)."""
    _trace_exceptions[0] = bool(b)


# -- signal handlers (Error.h:54-60) ----------------------------------------
def handle_interrupt(signum, frame):
    raise Interrupt(f"Received signal {signum}")


def handle_floating_point_exception(signum, frame):
    raise FloatingPointException(f"Received signal {signum}")


def install_interrupt_handler():
    signal.signal(signal.SIGINT, handle_interrupt)
    signal.signal(signal.SIGTERM, handle_interrupt)


def install_floating_point_exception_handler():
    """SIGFPE rarely fires for IEEE float work (only integer div-by-zero
    and explicit feenableexcept); the reference installs it anyway."""
    signal.signal(signal.SIGFPE, handle_floating_point_exception)


def install_segmentation_fault_handler():
    """Python cannot recover from a real SIGSEGV in native code; use
    faulthandler so the C-level trace is printed before death (the
    reference's handler does the same then exits)."""
    import faulthandler
    faulthandler.enable()


def exit_code_for(exc: BaseException) -> int:
    """Map an exception to its ESA exit code."""
    if isinstance(exc, FatalException):
        return exc.exit_code
    if isinstance(exc, KeyboardInterrupt):
        return PREMATURE_TERMINATION
    if isinstance(exc, MemoryError):
        return OUT_OF_MEMORY
    if isinstance(exc, FileNotFoundError):
        return CANNOT_OPEN_MANDATORY_FILE
    if isinstance(exc, PermissionError):
        return CANNOT_OPEN_MANDATORY_FILE
    if isinstance(exc, OSError):
        errno_ = getattr(exc, "errno", None)
        if errno_ == 28:        # ENOSPC
            return DISK_FULL
        return WRITE_ERROR
    if isinstance(exc, (ValueError, KeyError, TypeError)):
        return PARAMETER_ERROR
    if isinstance(exc, (ArithmeticError, RuntimeError)):
        return PROCESSING_ERROR
    return UNEXPECTED_EXCEPTION


def run_tool(func: Callable[[], object], name: str = "tool") -> int:
    """Run a tool entry point with ESA exit-code semantics.

    Returns the exit code (0 on success, the mapped ESA code on
    exception); the caller passes it to ``sys.exit``.  Installs the
    interrupt and FPE handlers first, matching the reference tools'
    ``main`` prologue.
    """
    install_interrupt_handler()
    try:
        install_floating_point_exception_handler()
    except (ValueError, OSError):
        pass    # not available on this platform/thread
    try:
        rc = func()
        return int(rc) if isinstance(rc, int) else EXIT_OK
    except SystemExit as e:
        return int(e.code) if e.code is not None else EXIT_OK
    except BaseException as e:   # noqa: BLE001 — tool boundary
        code = exit_code_for(e)
        print(f"*** {name}: {error_code_msg(code)} (exit code {code}): "
              f"{e}", file=sys.stderr)
        if _trace_exceptions[0]:
            traceback.print_exc()
        return code
