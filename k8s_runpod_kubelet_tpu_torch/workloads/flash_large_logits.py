"""Read the flash kernels at scores toward a soft cap, against float64:
each capped case of ``chip_smoke.py``'s ``GEMMA_FLASH_CASES`` (Gemma 2's
train-step heads under its cap of 50: 16 q heads over 8 kv heads of 256)
on the same seeded inputs, with q drawn 3 and 8 times larger, so that the
scores' sigma is 3 or 8 and their largest reach toward the cap.

For each scale and each of o, dq, dk and dv: the kernel against its plain
f32 version (relative L2 error, the per-element check's largest share,
how many elements exceed it and the plain value there, the largest
absolute error beside the largest plain magnitude); and dK of kv head 0
computed in float64 from the same bf16 inputs, lse and delta
(``dk_float64``), against which both the kernel's dK and the plain f32
version's are read: whose error the per-element misses are.

With ``--variants``, each named build of ``csrc/flash_attention.cu``
(``VARIANTS``: the shipped kernel, whose two-pass dK/dV block sums each q
tile's product apart from the band's sum and takes dS in three bf16
terms, and the ``FLASH_DKV_STRAIGHT`` build, the block before that) runs
dQ and dK/dV on the same inputs, lse and delta, and is read the same
way, with its misses against float64 and its dQ and dK/dV times at
q x 1.

Run from the repository root on a machine with one NVIDIA card:

    python -m k8s_runpod_kubelet_tpu_torch.workloads.flash_large_logits \\
        [--scales 3 8] [--variants shipped straight] \\
        [--out large_logits.json]

Prints one line per case and scale, then one JSON object (also written to
``--out``) with the card's name and power limit. It gates nothing:
``chip_smoke.py`` holds these cases at q x 8 by relative L2 and
``tests/test_torch_cuda.py`` bounds the per-element misses.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def dk_float64(q, k, v, do, lse, delta, args) -> torch.Tensor:
    """dK of kv head 0 (its group's q heads) in float64 from the bf16
    inputs and the kernel's lse and delta: the plain version's recipe
    (scale, soft cap, mask, P = exp(s - lse), dS = P (dP - delta) (1 -
    tanh^2)) at twice f32's precision, (B, 1, S, D)."""
    from ..ops.attention import _flash_mask

    g = q.shape[1] // k.shape[1]
    s_q, s_k = q.shape[2], k.shape[2]
    qd, dod = q[:, :g].double(), do[:, :g].double()
    kd, vd = k[:, :1].double(), v[:, :1].double()
    sc = torch.einsum("bhqd,bkd->bhqk", qd * args["sm_scale"], kd[:, 0])
    cap = args["logit_soft_cap"]
    jac = 1.0
    if cap is not None:
        th = torch.tanh(sc / cap)
        sc, jac = cap * th, 1 - th * th
        del th
    p = torch.exp(sc - lse[:, :g, :, None].double())
    mask = _flash_mask(s_q, s_k, args["causal"], args["sliding_window"],
                       q.device, args["q_offset"])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    del sc
    dp = torch.einsum("bhqd,bkd->bhqk", dod, vd[:, 0])
    ds = p * (dp - delta[:, :g, :, None].double()) * jac
    del p, dp, jac
    return (torch.einsum("bhqk,bhqd->bkd", ds, qd)
            * args["sm_scale"])[:, None]


# builds of csrc/flash_attention.cu: the shipped one (in the two-pass
# dK/dV block each q tile's product summed apart, dS in three bf16 terms)
# and the block before it (the straight sum, two terms)
VARIANTS = {"shipped": (), "straight": ("FLASH_DKV_STRAIGHT=1",)}


def backward_calls(defines: tuple, q, k, v, do, lse, delta, args):
    """(dq, dk, dv) outputs and the dQ and dK/dV launches that fill them,
    from the build of the kernel source with ``defines`` (the wrappers'
    launches, without their checks or counts)."""
    from ..ops import _cuda
    from ..ops.attention import _flash_dims, _flash_launchers

    _, dq_fn, dkv_fn = _flash_launchers(defines)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dims = _flash_dims(q, k, stream=stream, **args)
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    return ((dq, dk, dv),
            lambda: _cuda.check(dq_fn(*ptrs, dq.data_ptr(), *dims),
                                "flash_dq"),
            lambda: _cuda.check(dkv_fn(*ptrs, dk.data_ptr(), dv.data_ptr(),
                                       *dims), "flash_dkv"))


def readings(cs, q, k, v, do, args, mult: float,
             defines: tuple | None = None) -> dict:
    """The kernels at q times ``mult`` against their plain versions, and
    dK of kv head 0 of both against float64 (see the module docstring);
    with ``defines``, dQ and dK/dV from that build of the source."""
    from ..ops import flash_dkv, flash_dq, flash_fwd
    from ..ops.attention import (_flash_dkv_plain, _flash_dq_plain,
                                 _flash_fwd_plain)

    q = (q.float() * mult).bfloat16()
    o, lse = flash_fwd(q, k, v, **args)
    delta = (do.float() * o.float()).sum(-1)
    if defines is None:
        got = (o, flash_dq(q, k, v, do, lse, delta, **args),
               *flash_dkv(q, k, v, do, lse, delta, **args))
    else:
        outs, run_dq, run_dkv = backward_calls(defines, q, k, v, do, lse,
                                               delta, args)
        run_dq()
        run_dkv()
        got = (o, *outs)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    refs = (_flash_fwd_plain(qf, kf, vf, **args)[0],
            _flash_dq_plain(qf, kf, vf, dof, lse, delta, **args),
            *_flash_dkv_plain(qf, kf, vf, dof, lse, delta, **args))
    out = {}
    for name, g, r in zip(("o", "dq", "dk", "dv"), got, refs):
        diff = (g.float() - r).abs()
        share = diff / (cs.BF16_ATOL + cs.BF16_RTOL * r.abs())
        at = int(share.argmax())
        out[name] = {"rel_l2": ((g.float() - r).norm() / r.norm()).item(),
                     "max_share": share.max().item(),
                     "elements_over": int((share > 1).sum()),
                     "elements": share.numel(),
                     "plain_at_max_share": r.flatten()[at].item(),
                     "max_abs_err": diff.max().item(),
                     "max_abs_plain": r.abs().max().item()}
    exact = dk_float64(q, k, v, do, lse, delta, args)
    for who, t in (("kernel", got[2]), ("plain", refs[2])):
        share = ((t[:, :1].double() - exact).abs()
                 / (cs.BF16_ATOL + cs.BF16_RTOL * exact.abs()))
        out["dk"][f"{who}_vs_f64_kv_head_0_max_share"] = share.max().item()
        out["dk"][f"{who}_vs_f64_kv_head_0_over"] = int((share > 1).sum())
    return out


def backward_ms(cs, defines: tuple, q, k, v, do, args) -> dict:
    """dQ's and dK/dV's CUDA-event medians of the build with ``defines``
    at q x 1 (``chip_smoke.time_ms``, the L2 flushed)."""
    from ..ops import flash_fwd

    o, lse = flash_fwd(q, k, v, **args)
    delta = (do.float() * o.float()).sum(-1)
    _, run_dq, run_dkv = backward_calls(defines, q, k, v, do, lse, delta,
                                        args)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=q.device)
    return {"dq_ms": cs.time_ms(torch, run_dq, 10, flush),
            "dkv_ms": cs.time_ms(torch, run_dkv, 10, flush)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scales", nargs="+", type=float, default=[3.0, 8.0],
                   help="the multiples of the unit-scale q to read")
    p.add_argument("--variants", nargs="*", choices=sorted(VARIANTS),
                   help="read these builds of the kernel source's knobs "
                        "(VARIANTS) in place of the wrappers' build")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_large_logits: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"card: {card}")
    rows = []
    for (name, b, hq, hkv, s, d, causal, window, cap, q_offset,
         _) in cs.GEMMA_FLASH_CASES:
        if cap is None:
            continue
        # chip_smoke.flash_case's draw for this shape
        gen = torch.Generator().manual_seed(cs.SEED + s + d + hkv)
        q, do = (torch.randn((b, hq, s, d), generator=gen) for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen) for _ in range(2))
        q, k, v, do = (t.to(dev, torch.bfloat16) for t in (q, k, v, do))
        fa = dict(causal=causal, sm_scale=d ** -0.5, sliding_window=window,
                  logit_soft_cap=cap, q_offset=q_offset)
        for variant, mult in [(vn, m) for vn in (args.variants or [None])
                              for m in args.scales]:
            r = readings(cs, q, k, v, do, fa, mult,
                         None if variant is None else VARIANTS[variant])
            row = {"case": name, "q_scale": mult, "readings": r}
            if variant is not None:
                row["variant"] = variant
                if mult == args.scales[0]:
                    row["times_q_x1"] = backward_ms(cs, VARIANTS[variant],
                                                    q, k, v, do, fa)
                    cs.log(f"{variant} times at q x 1: {row['times_q_x1']}")
            rows.append(row)
            cs.log(f"{name}{'' if variant is None else f' [{variant}]'} "
                   f"at q x {mult:g}: " + "; ".join(
                f"{n} rel L2 {x['rel_l2']:.2e}, max share "
                f"{x['max_share']:.2f} ({x['elements_over']} of "
                f"{x['elements']} over, plain {x['plain_at_max_share']:.2e} "
                "there)" for n, x in r.items())
                + "; dK of kv head 0 against float64: kernel "
                f"{r['dk']['kernel_vs_f64_kv_head_0_max_share']:.2f}, plain "
                f"{r['dk']['plain_vs_f64_kv_head_0_max_share']:.2f} of the "
                f"check ({r['dk']['kernel_vs_f64_kv_head_0_over']} and "
                f"{r['dk']['plain_vs_f64_kv_head_0_over']} elements over)")
            torch.cuda.empty_cache()
    result = {"card": card, "tolerance": cs.TOLERANCE, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
