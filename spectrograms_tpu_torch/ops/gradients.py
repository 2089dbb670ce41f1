"""Differentiable fused path: kernel forward, plain PyTorch backward.

Counterpart of ``spectrograms_tpu.ops.gradients``. The fused kernels have no
backward (nor had the TPU kernel), so the forward runs a kernel (the f32 one
or, at the bf16 tiers, the tensor-core one) and the backward differentiates
the plan's plain f32 torch path (the twin), which computes the same function
from the same constants, as the JAX package's ``pallas_forward_xla_grad``.
"""

from __future__ import annotations

import torch

__all__ = ["kernel_forward_twin_grad"]


class _KernelForwardTwinGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel_fn, twin_fn):
        ctx.twin_fn = twin_fn
        ctx.save_for_backward(x)
        return kernel_fn(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(ctx.twin_fn(xd), xd, grad)
        return gx, None, None


def kernel_forward_twin_grad(kernel_fn, twin_fn):
    """Wrap ``kernel_fn`` so gradients flow through ``twin_fn``.

    Both take one tensor and compute the same function (to kernel
    precision); only ``twin_fn`` is differentiated.
    """

    def f(x):
        return _KernelForwardTwinGrad.apply(x, kernel_fn, twin_fn)

    return f
