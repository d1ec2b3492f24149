"""RMSNorm: a Triton kernel and its plain version.

Replaces ``k8s_runpod_kubelet_tpu/ops/rmsnorm.py:_rms_kernel`` (launched
by ``_rms_pallas``): y = x * rsqrt(mean(x^2) + eps) * w over the last
axis, statistics and the weight applied in f32, the result cast back to
x's dtype.

What bounds it on an H100: bytes. It reads x and w once and writes y once
with a handful of flops per element. The kernel is one Triton program per
row holding the whole row (E=4096 at the 8B) in registers: one read, one
reduction, one write, so it moves the least bytes the function allows. At
the serving shapes (8 rows at decode, up to 1024 at prefill) the launch,
not the bytes, is what the card spends most of the time on.

``triton`` is imported when the kernel is first launched, never when this
module is imported: the kernel body below is plain Python until
``_triton_kernel`` hands it to ``triton.jit``, and it finds ``tl`` as a
module global that the same call binds.
"""

from __future__ import annotations

import functools

import torch

tl = None  # triton.language, bound by _triton_kernel at first launch


def _rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                    eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def _rms_kernel(x_ptr, w_ptr, y_ptr, n_cols, eps, BLOCK: tl.constexpr):
    """One program per row: the row and the weight in registers, f32 math,
    the result stored in y's dtype."""
    row = tl.program_id(0)
    offs = tl.arange(0, BLOCK)
    mask = offs < n_cols
    x = tl.load(x_ptr + row * n_cols + offs, mask=mask,
                other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / n_cols
    y = x * tl.rsqrt(var + eps)
    w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    tl.store(y_ptr + row * n_cols + offs, (y * w).to(y_ptr.dtype.element_ty),
             mask=mask)


@functools.cache
def _triton_kernel():
    global tl
    import triton
    import triton.language

    tl = triton.language
    return triton, triton.jit(_rms_kernel)


class _RmsNorm(torch.autograd.Function):
    """The forward is the Triton kernel on the card and the plain version
    on the CPU; the backward is the vjp of
    ``_rms_norm_plain`` in plain torch (dx in x's dtype, dw in the weight's
    f32), as the JAX package takes the XLA vjp of its plain math: there is
    no backward kernel there either."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        if x.device.type == "cpu":
            return _rms_norm_plain(x, weight, eps)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        return _rms_launch(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            wd = weight.detach().requires_grad_()
            y = _rms_norm_plain(xd, wd, ctx.eps)
            dx, dw = torch.autograd.grad(y, (xd, wd), g)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * weight over the last axis, with
    gradients. A CUDA tensor launches the Triton kernel (bf16 x, f32
    weight) or raises; a CPU tensor takes the plain version. Either way
    the backward is ``_RmsNorm``'s (autograd records no node when no input
    needs a gradient, as on the serving path)."""
    if weight.shape != x.shape[-1:]:
        raise ValueError(f"weight {tuple(weight.shape)} does not match "
                         f"x's last axis {x.shape[-1]}")
    return _RmsNorm.apply(x, weight, eps)


def _rms_launch(x: torch.Tensor, weight: torch.Tensor,
                eps: float) -> torch.Tensor:
    """One launch of the Triton kernel, counted on ``rms_norm.launches``."""
    if weight.device != x.device:
        raise ValueError(f"weight is on {weight.device}, x on {x.device}")
    if x.dtype != torch.bfloat16 or weight.dtype != torch.float32:
        raise TypeError(f"the Triton kernel takes bf16 x and f32 weight, "
                        f"got {x.dtype} and {weight.dtype}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("x and weight must be contiguous")
    e = x.shape[-1]
    if e > 65536:
        raise ValueError(f"row width {e} exceeds the one-block row kernel")
    y = torch.empty_like(x)
    rows = x.numel() // e
    if rows == 0:
        return y
    triton, kernel = _triton_kernel()
    block = triton.next_power_of_2(e)
    kernel[(rows,)](x, weight, y, e, eps, BLOCK=block,
                    num_warps=8 if block >= 2048 else 4)
    rms_norm.launches += 1
    return y


# kernel launches made through the wrapper (the plain path never counts)
rms_norm.launches = 0
