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
  (replaces ``ecckd_tpu/ops/segments.py:_isum_pallas_kernel``);

and two more on the round-5 experiment path
(:mod:`ecckd_tpu_torch.scripts.exp_kernels`, replacing the kernels of
``scripts/exp_kernels.py``): E1, the LW sweep by affine scans across
layers, and E2, the LW fit and truth interval sums in one pass.

Each kernel wrapper runs its plain PyTorch version for tensors on the CPU
and launches the kernel for CUDA tensors; nothing falls back.  The host
modules it needs are its own copies of the JAX package's (``config``,
``logs``, ``errors``, ``constants``, ``tools/common.py``,
``partition/equipartition.py`` and ``gas_data.py``, and ``io`` with the
``.spbin`` shards and their native loader, ``csrc/shardloader.cpp``).  This
package imports neither jax nor ``ecckd_tpu``.
"""

__version__ = "0.1.0"
