"""CUDA graphs of the training step: the port's counterparts of ``jax.jit``
and of ``_solve_on_device``'s jitted ``lax.while_loop`` chunks.

JAX compiles ``jax.value_and_grad(total_cost)`` into one program
(``ecckd_tpu/optimize/solver.py:401``) and runs 100 L-BFGS iterations in
one jitted while loop (``:236-238``).  PyTorch runs eagerly: one value and
gradient at production size launches some 2300 kernels.  A CUDA graph
records those launches once, in their order, and replays them with one
launch from the host.  It replays the port's own kernels with their
arguments: nothing is fused or recompiled, so a replay computes the eager
code's bits, and the eager code stays the plain version that the CPU tests
hold against JAX.

:func:`capture` follows PyTorch's whole-network capture recipe: warm-up
calls on a side stream (they fill the caches that the eager code fills at
first use: model constants on the device, the interpolation matrices of
the LUT gradient), then one call recorded into a graph with its own memory
pool.  Nothing in it synchronises the host, so it may run under
``torch.cuda.set_sync_debug_mode("error")``.  A capture that fails raises;
nothing falls back to the eager code.  :class:`GraphedStep` is the captured
value and gradient of a flat state.
"""

from __future__ import annotations

from typing import Callable

import torch

#: Eager calls before the capture: the first fills the caches, the second
#: runs as every later call does.
WARMUP_CALLS = 2


def capture(fn: Callable, device, warmup: int = WARMUP_CALLS):
    """(graph, outputs) of ``fn()`` captured on a side stream of ``device``
    after ``warmup`` eager calls there.  The outputs are the graph's own
    tensors: every replay overwrites them."""
    with torch.cuda.device(device):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            for _ in range(warmup):
                fn()
            graph.capture_begin()
            try:
                out = fn()
            except BaseException:
                # end the broken capture, so that the stream is usable
                # again, and raise what broke it
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
    return graph, out


class GraphedStep:
    """``jax.jit(jax.value_and_grad(f))`` on the card.

    ``fn(x)`` is the eager value and gradient of a flat tensor (it makes
    ``x`` a leaf that requires grad and runs ``torch.autograd.grad``);
    it is captured at ``like``'s shape, dtype and device.  A call copies
    its argument into the graph's static input, replays, and returns the
    graph's value and gradient: the next call overwrites them, so a caller
    that keeps one past it copies it first."""

    def __init__(self, fn: Callable, like):
        self.x = like.detach().clone()
        self.graph, (self.value, self.grad) = capture(
            lambda: fn(self.x), self.x.device)

    def __call__(self, x):
        self.x.copy_(x)
        self.graph.replay()
        return self.value, self.grad
