"""ecckd_tpu_torch: the PyTorch/CUDA port of ecckd_tpu for one NVIDIA H100.

A second package beside the JAX reference ``ecckd_tpu``, with the same
layout (``ops``, ``partition``, ``models``, ``tools``).  Plain tensor code is
PyTorch; the three kernels on the generation path are written by hand for
Hopper in CUDA C++ (``csrc/``) and bound with ctypes (``ops/kernels/``):

* K1, the LW broadband sweep with per-interval flux sums
  (replaces ``ecckd_tpu/ops/pallas/sweep_lw.py``);
* K2, the SW broadband sweep with per-interval flux sums
  (replaces ``ecckd_tpu/ops/pallas/sweep_sw.py``);
* K3, the fused multi-row interval sum
  (replaces ``ecckd_tpu/ops/segments.py:_isum_pallas_kernel``).

Each kernel wrapper runs its plain PyTorch version for tensors on the CPU
and launches the kernel for CUDA tensors; nothing falls back.  Host-only
modules are shared with the JAX package (``config``, ``logs``, ``errors``,
``constants``, and ``partition/equipartition.py`` and ``gas_data.py``
through :mod:`ecckd_tpu_torch._shared`).  This package never imports jax.
"""

__version__ = "0.1.0"
