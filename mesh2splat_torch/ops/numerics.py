"""Float32 arithmetic that rounds as the reference's does: a fused
multiply-add rounded once, and a correctly rounded square root.

The JAX package's numbers come from XLA, which on the CPU contracts
``a * b + c`` into one fused multiply-add wherever LLVM's x86 rules allow it:
an fmul with one use that feeds an fadd/fsub is fused, and of two such
fmuls the left one is. The port repeats those roundings where a float feeds
an integer decision (a texel column, coverage, a dominant axis, a mip level,
a tap index), so its integers agree with the reference's; its CUDA kernels
call ``__fmaf_rn`` at the same places.

PyTorch has no fma operator, so ``fma`` computes in float64: the product of
two floats is exact there, the sum is rounded to odd (TwoSum error, then the
last bit forced), and the final cast to float32 then rounds exactly as a
hardware fma does.

``torch.sqrt`` of a float32 CPU tensor is not always correctly rounded (its
vectorised path is off by an ulp for some inputs), while XLA's and CUDA's
``sqrtf`` are; ``sqrt`` takes the root in float64 and rounds once more,
which is exact for float32 inputs.

Both are differentiable: ``fma`` is an autograd Function whose backward is
that of ``a * b + c`` (the bit-level view of its forward has no gradient of
its own), and ``sqrt`` differentiates through its float64 cast.
"""

from __future__ import annotations

import numpy as np
import torch


def _f64(x, like):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    # Python scalars enter as the float32 value XLA gives a weak-typed scalar
    return torch.tensor(float(np.float32(x)), dtype=torch.float64,
                        device=like.device)


def _fma_f32(a, b, c):
    like = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = _f64(a, like), _f64(b, like), _f64(c, like)
    p = a * b                      # exact: 24 + 24 bits < 53
    s = p + c
    bv = s - p                     # TwoSum: s + err == p + c exactly
    err = (p - (s - bv)) + (c - bv)
    bits = s.view(torch.int64)
    # round to odd: an inexact even result moves one ulp toward the exact sum
    step = torch.where((err > 0) == (s > 0), 1, -1)
    fix = (err != 0) & ((bits & 1) == 0)
    bits = torch.where(fix, bits + step, bits)
    return bits.view(torch.float64).to(torch.float32)


class _Fma(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c):
        # a Python number stays in ctx as itself; a tensor's shape is kept
        # to reduce its broadcast gradient back onto it
        ctx.scalars = tuple(None if isinstance(x, torch.Tensor) else x
                            for x in (a, b))
        ctx.shapes = tuple(x.shape if isinstance(x, torch.Tensor) else None
                           for x in (a, b, c))
        ctx.save_for_backward(*[x for x in (a, b)
                                if isinstance(x, torch.Tensor)])
        return _fma_f32(a, b, c)

    @staticmethod
    def backward(ctx, g):
        saved = iter(ctx.saved_tensors)
        a, b = (next(saved) if s is None else s for s in ctx.scalars)
        grads = (g * b, g * a, g)
        return tuple(
            (gi.sum_to_size(shape) if gi.shape != shape else gi)
            if need else None
            for gi, shape, need in zip(grads, ctx.shapes,
                                       ctx.needs_input_grad))


def fma(a, b, c):
    """round_f32(a * b + c) with a single rounding; at least one argument
    must be a float32 tensor, the others may be Python numbers. Its gradient
    is that of ``a * b + c``."""
    return _Fma.apply(a, b, c)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)
