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

Run from the repository root on a machine with one NVIDIA card:

    python -m k8s_runpod_kubelet_tpu_torch.workloads.flash_large_logits \\
        [--scales 3 8] [--out large_logits.json]

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


def readings(cs, q, k, v, do, args, mult: float) -> dict:
    """The kernels at q times ``mult`` against their plain versions, and
    dK of kv head 0 of both against float64 (see the module docstring)."""
    from ..ops import flash_dkv, flash_dq, flash_fwd
    from ..ops.attention import (_flash_dkv_plain, _flash_dq_plain,
                                 _flash_fwd_plain)

    q = (q.float() * mult).bfloat16()
    o, lse = flash_fwd(q, k, v, **args)
    delta = (do.float() * o.float()).sum(-1)
    got = (o, flash_dq(q, k, v, do, lse, delta, **args),
           *flash_dkv(q, k, v, do, lse, delta, **args))
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
        t = t[:, :1].double()
        out["dk"][f"{who}_vs_f64_kv_head_0_max_share"] = (
            (t - exact).abs() / (cs.BF16_ATOL + cs.BF16_RTOL * exact.abs())
        ).max().item()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scales", nargs="+", type=float, default=[3.0, 8.0],
                   help="the multiples of the unit-scale q to read")
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
        for mult in args.scales:
            r = readings(cs, q, k, v, do, fa, mult)
            rows.append({"case": name, "q_scale": mult, "readings": r})
            cs.log(f"{name} at q x {mult:g}: " + "; ".join(
                f"{n} rel L2 {x['rel_l2']:.2e}, max share "
                f"{x['max_share']:.2f} ({x['elements_over']} of "
                f"{x['elements']} over, plain {x['plain_at_max_share']:.2e} "
                "there)" for n, x in r.items())
                + "; dK of kv head 0 against float64: kernel "
                f"{r['dk']['kernel_vs_f64_kv_head_0_max_share']:.2f}, plain "
                f"{r['dk']['plain_vs_f64_kv_head_0_max_share']:.2f} of the "
                "check")
            torch.cuda.empty_cache()
    result = {"card": card, "tolerance": cs.TOLERANCE, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
