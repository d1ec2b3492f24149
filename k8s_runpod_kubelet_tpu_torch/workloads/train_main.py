"""Pretrain workload on one card (port of the JAX package's
``workloads/train_main.py``): the pod command of a training job. Trains
the dense Llama decoder, or an MLA model (``--model mla-8b``, ``tiny-mla``,
its direct form through the flash kernels at head_dim + rope_dim), on the
synthetic token stream, checkpoints with
``torch.save`` and resumes from the newest checkpoint, then prints one
JSON summary line.

Run: python -m k8s_runpod_kubelet_tpu_torch.workloads.train_main \\
        --model tiny --steps 100 [--device cpu]

The kubelet's preemption recovery works as for the JAX workload:
``TPU_CHECKPOINT_DIR`` stands in for ``--checkpoint-dir`` when that is not
given, ``TPU_RESTART_ATTEMPT`` > 0 marks a relaunch, and ``restore`` logs
``resumed from checkpoint step N``, the marker the kubelet parses (a
checkpoint wins over ``--hf-checkpoint DIR``, which starts from a Hugging
Face model directory's weights instead of random init). Meshes, LoRA,
``--data``, the profiler and telemetry are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from ..device import resolve_device

log = logging.getLogger("train-main")


def main(argv=None) -> int:
    from ..models import MODEL_CONFIGS

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="llama3-8b",
                   choices=list(MODEL_CONFIGS))
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--z-loss", type=float, default=0.0,
                   help="z-loss coefficient (MaxText uses 1e-4 at scale)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatches per optimizer step")
    p.add_argument("--eval-steps", type=int, default=0,
                   help="held-out eval batches at the end (0 = none)")
    p.add_argument("--hf-checkpoint", default="", metavar="DIR",
                   help="initial weights from a Hugging Face model "
                        "directory (empty: random init)")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    restart_attempt = int(os.environ.get("TPU_RESTART_ATTEMPT", "0") or 0)
    if not args.checkpoint_dir and os.environ.get("TPU_CHECKPOINT_DIR"):
        args.checkpoint_dir = os.environ["TPU_CHECKPOINT_DIR"]
        log.info("checkpoint dir from TPU_CHECKPOINT_DIR: %s",
                 args.checkpoint_dir)
    if restart_attempt:
        log.info("restart attempt %d (post-preemption relaunch)",
                 restart_attempt)

    from .train import TrainConfig, Trainer

    device = resolve_device(args.device)
    cfg = MODEL_CONFIGS[args.model]()
    accum = max(1, args.grad_accum)
    batch = -(-args.batch // accum) * accum
    if batch != args.batch:
        log.info("batch %d -> %d (must divide grad_accum=%d)", args.batch,
                 batch, accum)
    tc = TrainConfig(learning_rate=args.lr, batch_size=batch,
                     seq_len=args.seq_len, steps=args.steps,
                     z_loss_coef=args.z_loss, grad_accum_steps=accum,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every)
    initial = None
    if args.hf_checkpoint:
        from ..models.convert import load_hf
        initial = load_hf(cfg, args.hf_checkpoint, device=device,
                          master=True)
        log.info("initializing from HF checkpoint %s", args.hf_checkpoint)
    trainer = Trainer(cfg, tc, initial_params=initial, device=device)
    log.info("model=%s layers=%d device=%s", cfg.name, cfg.n_layers, device)
    if args.checkpoint_dir:
        restored = trainer.restore()
        if restart_attempt:
            if restored:
                log.info("preemption recovery: attempt %d resumes at step "
                         "%d", restart_attempt, trainer.step)
            else:
                log.warning("preemption recovery: attempt %d found NO "
                            "checkpoint in %s — training restarts at step 0",
                            restart_attempt, args.checkpoint_dir)
    out = trainer.run(steps=args.steps)
    if args.checkpoint_dir:
        trainer.save()
    if args.eval_steps > 0:
        out.update(trainer.evaluate(steps=args.eval_steps))
    out.update({"workload": "pretrain", "model": cfg.name, "devices": 1,
                "device": str(device),
                "tokens_per_s_per_chip": round(out["tokens_per_s"], 1)})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
