"""Time this tree's kernels against another tree's, in turns on one card:
``flash_fwd``, ``flash_dq`` and ``flash_dkv`` at every case of
``chip_smoke.py``'s phase 8 (its inputs; the backward kernels of both trees
take the lse of this tree's forward and delta = rowsum(dO o) of its o);
``paged_attention_multi`` and ``paged_attention_multi_quant`` (decode K=1
B=8, K=4 B=8, a 1024-token prefill chunk) and ``paged_attention`` and
``paged_attention_quant`` (decode B=8) at phase 3's shapes and inputs (the
int8 pages that the model's ``_kv_quant`` makes from the bf16 ones);
``int4_matmul`` at phase 3's projection shapes (``INT4_SHAPES``) at 8 and
1024 rows; ``int4_expert_matmul`` at phase 3's six Mixtral cases
(``INT4_EXPERT_ROWS`` x ``INT4_EXPERT_SHAPES``: the same counts, weights and
buffers, with the counts), beside the instructions each tree's expert
kernel spends to unpack a staged q4 byte (``chip_smoke.sass_unpack_mix``);
and the four
MLA entries at phase 3b's shapes (``paged_attention_multi_mla`` and
``paged_attention_multi_mla_quant`` at decode K=1 B=8 and a 1024-token
chunk, the single-token forms at decode).

Run from the repository root on a machine with one NVIDIA card, with the
other tree unpacked somewhere (for example ``git archive <commit> | tar -x
-C .archive/parent``):

    python -m k8s_runpod_kubelet_tpu_torch.workloads.kernel_ab \
        --other .archive/parent [--kernels paged flash int4 int4_expert mla] \
        [--out ab.json]

The other tree's package is imported under another name and builds its
own kernels into its own ``_build``. Each shape is timed other, this,
this, other (``chip_smoke.time_ms``: median of CUDA-event times, the L2
flushed before each launch), and the two outputs' largest difference is
printed beside the times. Prints one JSON object (also written to
``--out``) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import threading
from pathlib import Path

import torch

PKG = "k8s_runpod_kubelet_tpu_torch"


KINDS = ("paged", "flash", "int4", "int4_expert", "mla")
# the sources a kind may launch, in either tree (a tree builds those it has:
# before its own source, int4_expert_matmul lived in int4_matmul.cu)
SOURCES = {"paged": ("paged_attention_multi", "paged_attention_multi_quant"),
           "flash": ("flash_attention",), "int4": ("int4_matmul",),
           "int4_expert": ("int4_matmul", "int4_expert_matmul"),
           "mla": ("paged_attention_multi_mla",
                   "paged_attention_multi_mla_quant")}


def _other_ops(root: str):
    """The other tree's ``ops.attention``, ``ops.int4_matmul`` and
    ``ops._cuda``, its package imported as ``ab_other_<pkg>``."""
    pkg_dir = Path(root).resolve() / PKG
    alias = f"ab_other_{PKG}"
    spec = importlib.util.spec_from_file_location(
        alias, pkg_dir / "__init__.py",
        submodule_search_locations=[str(pkg_dir)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(f"{alias}.ops.attention"),
            importlib.import_module(f"{alias}.ops.int4_matmul"),
            importlib.import_module(f"{alias}.ops._cuda"))


def _build_all(cudas, names) -> None:
    """Both trees' sources of the kernels compared (those each tree has),
    one nvcc each, all at once."""
    errors = []

    def build(cuda, name):
        try:
            cuda.load(name)
        except Exception as e:   # re-raised after the join
            errors.append(e)

    threads = [threading.Thread(target=build, args=(c, n)) for c in cudas
               for n in names if (c.CSRC / f"{n}.cu").exists()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", required=True,
                   help="root of the tree to compare against")
    p.add_argument("--kernels", nargs="+", choices=KINDS, default=KINDS,
                   help="the kernel families to compare (default all)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from ..models.llama import _kv_quant
    from ..models.quant import _quantize_leaf_int4
    from ..ops import _cuda
    from ..ops import attention as this

    this_int4 = importlib.import_module(f"{PKG}.ops.int4_matmul")

    other, other_int4, other_cuda = _other_ops(args.other)
    _build_all([_cuda, other_cuda],
               [n for kind in args.kernels for n in SOURCES[kind]])
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"card: {card}")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = []

    def turns(kernel, case, call, mods=(other, this)):
        other_m, this_m = mods
        outs = [call(m) for m in mods]
        torch.cuda.synchronize()
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(*[o if isinstance(o, tuple) else (o,)
                                     for o in outs]))
        times = [cs.time_ms(torch, lambda m=m: call(m), reps, flush)
                 for m in (other_m, this_m, this_m, other_m)]
        rec = {"kernel": kernel, "case": case,
               "other_ms": [times[0], times[3]], "this_ms": times[1:3],
               "max_abs_diff": diff}
        rows.append(rec)
        cs.log(f"  {kernel} {case}: other {times[0]:.4f}, this "
               f"{times[1]:.4f}, this {times[2]:.4f}, other {times[3]:.4f} "
               f"ms; outputs differ by at most {diff:.3e}")

    decode = [1, 17, 300, 511, 1024, 1500, 1999, 2048]
    for case, b, kq, lengths in () if "paged" not in args.kernels else (
            ("decode K=1 B=8", 8, 1, decode),
            ("K=4 B=8", 8, 4, [4, 40, 333, 700, 1029, 1600, 1999, 2048]),
            ("prefill K=1024 B=1", 1, 1024, [100 + 1024])):
        q, k, v, table, lens, _ = cs.attention_inputs(torch, dev, b, kq,
                                                      lengths)
        (kp, ks), (vp, vs) = _kv_quant(k), _kv_quant(v)
        scale = q.shape[3] ** -0.5
        q1 = q[:, 0].contiguous()
        reps = 50
        for kind, pages in (("", (k, v)), ("_quant", (kp, vp, ks, vs))):
            turns(f"paged_attention_multi{kind}", case,
                  lambda m: getattr(m, f"paged_attention_multi{kind}")(
                      q, *pages, table, lens, sm_scale=scale))
            if kq == 1:
                turns(f"paged_attention{kind}", case.replace("K=1 ", ""),
                      lambda m: getattr(m, f"paged_attention{kind}")(
                          q1, *pages, table, lens, sm_scale=scale))
    for name, b, hq, hkv, s, d, causal, window, cap in (
            cs.FLASH_CASES if "flash" in args.kernels else ()):
        gen = torch.Generator().manual_seed(cs.SEED + s + d + hkv)
        q, do = (torch.randn((b, hq, s, d), generator=gen) for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen) for _ in range(2))
        q, k, v, do = (t.to(dev, torch.bfloat16) for t in (q, k, v, do))
        fa = dict(causal=causal, sm_scale=d ** -0.5, sliding_window=window,
                  logit_soft_cap=cap)
        reps = 5 if b * hq * s * s > 2 ** 31 else 10
        turns("flash_fwd", name, lambda m: m.flash_fwd(q, k, v, **fa))
        o, lse = this.flash_fwd(q, k, v, **fa)
        delta = (do.float() * o.float()).sum(-1)
        del o
        turns("flash_dq", name,
              lambda m: m.flash_dq(q, k, v, do, lse, delta, **fa))
        turns("flash_dkv", name,
              lambda m: m.flash_dkv(q, k, v, do, lse, delta, **fa))
    for n_rows in (8, 1024) if "int4" in args.kernels else ():
        for kin, out, leaves in cs.INT4_SHAPES:
            gen = torch.Generator(device=dev).manual_seed(cs.SEED + kin + out)
            leaf = _quantize_leaf_int4(
                torch.randn((kin, out), generator=gen, device=dev) * 0.02)
            q4, scale = leaf["q4"], leaf["scale"]
            h = torch.randn((n_rows, kin), generator=gen,
                            device=dev).bfloat16()
            reps = 5 if n_rows * kin * out > 2**34 else 30
            turns("int4_matmul", f"{n_rows} x ({kin} -> {out}) [{leaves}]",
                  lambda m: m.int4_matmul(h, q4, scale),
                  (other_int4, this_int4))
            del leaf, q4, scale, h
    unpack_mix = {}
    if "int4_expert" in args.kernels:
        # each tree's expert kernel: the library that holds it
        for tree, cuda in (("other", other_cuda), ("this", _cuda)):
            lib = next(n for n in ("int4_expert_matmul", "int4_matmul")
                       if (cuda.CSRC / f"{n}.cu").exists()
                       and "int4_expert_matmul_kernel" in (
                           cuda.CSRC / f"{n}.cu").read_text())
            unpack_mix[tree] = cs.sass_unpack_mix(
                cuda.load(lib)._name, "int4_expert_matmul_kernel")
            for kernel, mix in sorted(unpack_mix[tree].items()):
                cs.log(f"  sass unpack ({tree}) {kernel}: "
                       f"{mix['unpack_instructions']} instructions for "
                       f"{mix['q4_bytes']} q4 bytes a thread, "
                       f"{mix['per_byte']} a byte ({mix['ops']})")
    for n_rows, path in cs.INT4_EXPERT_ROWS if "int4_expert" in args.kernels \
            else ():
        for kin, out, leaves in cs.INT4_EXPERT_SHAPES:
            h, q4, scale, counts, _ = cs.int4_expert_inputs(torch, dev,
                                                            n_rows, kin, out)
            reps = 10 if n_rows >= 1024 else 30
            turns("int4_expert_matmul",
                  f"{path}: 8 x {n_rows} x ({kin} -> {out}) [{leaves}], "
                  f"counts {counts.tolist()}",
                  lambda m: m.int4_expert_matmul(h, q4, scale, counts),
                  (other_int4, this_int4))
            del h, q4, scale, counts
    for case, b, kq, lengths in () if "mla" not in args.kernels else (
            ("decode K=1 B=8", 8, 1, cs.MLA_DECODE_LENGTHS),
            ("prefill K=1024 B=1", 1, 1024, [100 + 1024])):
        q_lat, q_rope, c, kr, table, lens, _ = cs.mla_inputs(torch, dev, b,
                                                             kq, lengths)
        scale = (128 + kr.shape[2]) ** -0.5
        (cq, c_s), (krq, kr_s) = _kv_quant(c), _kv_quant(kr)
        q1 = (q_lat[:, 0].contiguous(), q_rope[:, 0].contiguous())
        reps = 50 if kq == 1 else 10
        for kind, pages in (("", (c, kr)), ("_quant", (cq, krq, c_s, kr_s))):
            turns(f"paged_attention_multi_mla{kind}", case,
                  lambda m: getattr(m, f"paged_attention_multi_mla{kind}")(
                      q_lat, q_rope, *pages, table, lens, sm_scale=scale))
            if kq == 1:
                turns(f"paged_attention_mla{kind}", case.replace("K=1 ", ""),
                      lambda m: getattr(m, f"paged_attention_mla{kind}")(
                          *q1, *pages, table, lens, sm_scale=scale))
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "other": args.other, "ab": rows}
    if unpack_mix:
        result["int4_expert_unpack_mix"] = unpack_mix
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
