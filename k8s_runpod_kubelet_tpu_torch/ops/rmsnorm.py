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


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * weight over the last axis. A CUDA
    tensor launches the Triton kernel (bf16 x, f32 weight) or raises; a
    CPU tensor takes the plain version."""
    if weight.shape != x.shape[-1:]:
        raise ValueError(f"weight {tuple(weight.shape)} does not match "
                         f"x's last axis {x.shape[-1]}")
    if x.device.type == "cpu":
        return _rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
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
