"""Pretrain and fine-tune workload on one card (port of the JAX package's
``workloads/train_main.py``): the pod command of a training job. Trains
the dense Llama decoder (Gemma 2 and 3 among its families: ``--model
gemma2-9b``, ``gemma3-12b``), an MLA model (``--model mla-8b``,
``tiny-mla``, its direct form through the flash kernels at head_dim +
rope_dim) or a sparse-MoE model (``--model mixtral-8x7b``,
``deepseek-v2-lite``, ``deepseek-v3``, ``tiny-moe``: the router's
load-balance and z losses in the objective, capacity drops), on the
synthetic token stream or a pre-tokenized int32 file (``--data``, read
through the native loader), fully or as a LoRA fine-tune (``--lora-rank``;
``--export-adapter`` writes the trained adapter for the serving engine's
``/adapters``), with the LM-head loss fused over vocab chunks
(``--fused-ce-chunks``), checkpoints with ``torch.save`` (the loop's saves
written in the background) and resumes from the newest checkpoint, then
prints one JSON summary line.

Run: python -m k8s_runpod_kubelet_tpu_torch.workloads.train_main \\
        --model tiny --steps 100 [--device cpu]

Training telemetry works as for the JAX workload: every step prints a
``TPU_STEP_HEARTBEAT`` line and every ``--telemetry-every`` steps a
``TPU_TELEMETRY {json}`` line to stderr (the lines the kubelet scrapes),
and ``--telemetry-port`` serves ``/metrics``, ``/debug/train``,
``/debug/traces`` and ``POST /heartbeat``. The kubelet's preemption
recovery works as for the JAX workload too: ``TPU_CHECKPOINT_DIR`` stands
in for ``--checkpoint-dir`` when that is not given, ``TPU_RESTART_ATTEMPT``
> 0 marks a relaunch (the goodput ledger charges the lost work to
``restart_lost``), and ``restore`` logs ``resumed from checkpoint step
N``, the marker the kubelet parses (a checkpoint wins over
``--hf-checkpoint DIR``, which starts from a Hugging Face model
directory's weights instead of random init).

``--profile-dir DIR`` traces steps 3-5 as the JAX main does: with
``--steps`` over 4 it runs two steps, captures three under
``torch.profiler`` (CPU activity, and CUDA's on a card) into
``DIR/train_steps.pt.trace.json`` (Chrome trace format, the file
``step_profile.trace_kernel_events`` reads), then runs the rest; fewer
steps run untraced.

Refused by name: ``--profiler-port`` (PyTorch has no profiler server; as
for serving), ``--elastic-batch-mode`` and an elastic-resize relaunch (ROADMAP
Queue 1 #7.5), ``--fsdp``, ``--tensor``, ``--stage`` and a multi-process
gang (#7.8, #8). ``--seq N`` shards the sequence over an in-process mesh
on the one card (ring flash attention, ``ring_flash``), as
``Trainer(mesh=)`` does.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from ..device import resolve_device

log = logging.getLogger("train-main")


def _refusals(args) -> list[str]:
    """The JAX flags and environment this port does not serve, each with
    the item that brings it."""
    out = []
    if args.profiler_port:
        out.append("--profiler-port: PyTorch has no profiler server (a "
                   "deliberate difference, as for serving)")
    if args.elastic_batch_mode is not None or int(
            os.environ.get("TPU_ELASTIC_RESIZE", "0") or 0):
        out.append("--elastic-batch-mode / TPU_ELASTIC_RESIZE: elastic "
                   "resize is not ported (ROADMAP Queue 1 #7.5)")
    # --fsdp 0 or -1 is the JAX flag's "auto": one device here; --seq
    # shards the sequence over an in-process mesh (one card)
    for flag in ("fsdp", "tensor", "stage"):
        if getattr(args, flag) not in (-1, 0, 1):
            out.append(f"--{flag}: training over a mesh of processes is not "
                       "ported (ROADMAP Queue 1 #7.8, #8)")
    if int(os.environ.get("JAX_NUM_PROCESSES", "1") or 1) > 1:
        out.append("a multi-process gang: training over a process group is "
                   "not ported (ROADMAP Queue 1 #7.8)")
    return out


def mfu_accelerator(device) -> str:
    """The accelerator whose peak is the MFU denominator: the card's own
    row on the card, else the accelerator the environment names (a CPU run
    without one reads the cpu floor)."""
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return os.environ.get("TPU_ACCELERATOR_TYPE", "")


PROFILE_TRACE = "train_steps.pt.trace.json"


def profile_steps(trainer, steps: int, batches, out_dir: str) -> dict:
    """``trainer.run(steps)`` under ``torch.profiler`` (CPU activity, and
    CUDA's on a card), its Chrome trace exported to ``out_dir/``
    ``PROFILE_TRACE``; the run's summary with the trace's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = trainer.device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        out = trainer.run(steps=steps, batches=batches)
        if cuda:
            torch.cuda.synchronize(trainer.device)
    path = os.path.join(out_dir, PROFILE_TRACE)
    prof.export_chrome_trace(path)
    return dict(out, trace=path)


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
                   help="z-loss coefficient (MaxText uses 1e-4 at scale): "
                        "keeps LM-head logit magnitudes bounded in bf16")
    p.add_argument("--tensor", type=int, default=1,
                   help="refused: tensor-parallel training is not ported")
    p.add_argument("--seq", type=int, default=1,
                   help="sequence-parallel degree: ring flash attention "
                        "over this many sequence shards of an in-process "
                        "mesh (one card; the process-group ring is not "
                        "ported)")
    p.add_argument("--stage", type=int, default=1,
                   help="refused: pipeline parallelism is not ported")
    p.add_argument("--fsdp", type=int, default=0,
                   help="refused: FSDP is not ported")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatches per optimizer step (grad accumulation)")
    p.add_argument("--fused-ce-chunks", type=int, default=0,
                   help="stream the LM-head loss over this many vocab chunks "
                        "(0 = materialize logits); frees the (B,S,V) logits "
                        "memory for batch at one extra head matmul in "
                        "backward")
    p.add_argument("--eval-steps", type=int, default=0,
                   help="run a held-out eval of this many batches at the end "
                        "(and report eval_loss/eval_ppl)")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="enable LoRA fine-tuning at this rank (0 = full "
                        "fine-tune); base weights freeze, only adapters train")
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--lora-targets", default="wq,wv",
                   help="comma list of projections to adapt "
                        "(wq,wk,wv,wo,w_gate,w_up,w_down)")
    p.add_argument("--export-adapter", default="",
                   help="after a --lora-rank run, write the trained adapter "
                        "alone to this .npz (a few MB) — POST it to the "
                        "serving /adapters endpoint for multi-LoRA serving")
    p.add_argument("--hf-checkpoint", default="", metavar="DIR",
                   help="initial weights from a Hugging Face model "
                        "directory (empty: random init); a checkpoint in "
                        "--checkpoint-dir still wins on resume")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--data", default="",
                   help="pre-tokenized int32 corpus file (empty = synthetic); "
                        "read through the native loader")
    p.add_argument("--data-threads", type=int, default=2)
    p.add_argument("--profile-dir", default="",
                   help="trace three post-warmup steps (3-5) with "
                        "torch.profiler into this directory (Chrome trace "
                        "format, TensorBoard-readable)")
    p.add_argument("--profiler-port", type=int, default=0,
                   help="refused: PyTorch has no profiler server")
    p.add_argument("--telemetry-port", type=int,
                   default=int(os.environ.get("TPU_TELEMETRY_PORT", "0") or 0),
                   help="serve /metrics + /debug/train + POST /heartbeat on "
                        "this port (0 = off)")
    p.add_argument("--straggler-factor", type=float,
                   default=float(os.environ.get("TPU_STRAGGLER_FACTOR",
                                                "3.0") or 3.0),
                   help="flag a host whose mean step time exceeds this "
                        "multiple of the across-host median")
    p.add_argument("--stall-timeout-s", type=float,
                   default=float(os.environ.get("TPU_STALL_TIMEOUT_S",
                                                "120") or 120),
                   help="flag a host whose step counter stops advancing "
                        "for this many seconds")
    p.add_argument("--telemetry-every", type=int, default=1,
                   help="emit the TPU_TELEMETRY state line every N steps "
                        "(heartbeats go every step regardless)")
    p.add_argument("--trace-export",
                   default=os.environ.get("TPU_TRACE_EXPORT_PATH", ""),
                   help="append training.* spans to this JSONL file; render "
                        "with tools/goodput_summary.py / trace_summary.py")
    p.add_argument("--elastic-batch-mode", default=None,
                   choices=("global", "per_host"),
                   help="refused: elastic resize is not ported")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if args.export_adapter and args.lora_rank <= 0:
        # fail at arg time, not after a multi-hour run
        p.error("--export-adapter needs --lora-rank")
    refused = _refusals(args)
    if refused:
        p.error("not ported: " + "; ".join(refused))
    logging.basicConfig(level=logging.INFO)

    restart_attempt = int(os.environ.get("TPU_RESTART_ATTEMPT", "0") or 0)
    if not args.checkpoint_dir and os.environ.get("TPU_CHECKPOINT_DIR"):
        args.checkpoint_dir = os.environ["TPU_CHECKPOINT_DIR"]
        log.info("checkpoint dir from TPU_CHECKPOINT_DIR: %s",
                 args.checkpoint_dir)
    if restart_attempt:
        log.info("restart attempt %d (post-preemption relaunch)",
                 restart_attempt)

    from ..health import HealthServer
    from ..metrics import Metrics
    from ..tracing import Tracer
    from .telemetry import TrainingTelemetry, state_path_for
    from .train import TrainConfig, Trainer

    device = resolve_device(args.device)
    cfg = MODEL_CONFIGS[args.model]()
    mesh = None
    if args.seq > 1:
        import dataclasses

        from ..parallel import MeshConfig, make_mesh
        if args.seq_len % args.seq:
            p.error(f"--seq-len {args.seq_len} must divide into --seq "
                    f"{args.seq} shards")
        mesh = make_mesh(MeshConfig(seq=args.seq))
        # each ring step through the flash kernels (their plain versions
        # on the CPU), not the plain online-softmax ring: the same function
        cfg = dataclasses.replace(cfg, ring_flash=True)
    accum = max(1, args.grad_accum)
    batch = -(-args.batch // accum) * accum
    if batch != args.batch:
        log.info("batch %d -> %d (must divide grad_accum=%d)", args.batch,
                 batch, accum)
    tc = TrainConfig(learning_rate=args.lr, batch_size=batch,
                     seq_len=args.seq_len, steps=args.steps,
                     z_loss_coef=args.z_loss, grad_accum_steps=accum,
                     fused_ce_chunks=args.fused_ce_chunks,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every)
    initial = None
    if args.hf_checkpoint:
        from ..models.convert import load_hf
        initial = load_hf(cfg, args.hf_checkpoint, device=device,
                          master=True)
        log.info("initializing from HF checkpoint %s", args.hf_checkpoint)
    lora = None
    if args.lora_rank > 0:
        from ..models.lora import LoraConfig
        lora = LoraConfig(rank=args.lora_rank, alpha=args.lora_alpha,
                          targets=tuple(t for t in
                                        args.lora_targets.split(",") if t))

    # -- training telemetry: the protocol lines go to stderr (the kubelet
    # scrapes them from the pod's logs); the telemetry port serves
    # /metrics, /debug/train and POST /heartbeat
    tel_metrics = Metrics()
    tracer = Tracer(export_path=args.trace_export)

    def emit_line(line: str):
        print(line, file=sys.stderr, flush=True)

    tel = TrainingTelemetry(
        tokens_per_step=batch * args.seq_len,
        model_params=cfg.param_count, n_chips=1,
        accelerator_type=mfu_accelerator(device), num_hosts=1, host_id=0,
        metrics=tel_metrics, tracer=tracer,
        straggler_factor=args.straggler_factor,
        stall_timeout_s=args.stall_timeout_s,
        attempt=restart_attempt, dp_width=1,
        state_path=state_path_for(args.checkpoint_dir),
        telemetry_every=args.telemetry_every,
        emit_line=emit_line)
    if restart_attempt and tel.restart_lost_s > 0:
        log.info("goodput ledger: %.1fs charged to restart_lost "
                 "(attempt %d, prior step %d)",
                 tel.restart_lost_s, restart_attempt, tel.resumed_from_step)
    tel_server = None
    if args.telemetry_port:
        tel_server = HealthServer(f":{args.telemetry_port}",
                                  metrics=tel_metrics, tracer=tracer,
                                  train_status=tel.snapshot,
                                  heartbeat_sink=tel.ingest_heartbeat).start()
        log.info("telemetry server on :%d (/metrics /debug/train "
                 "POST /heartbeat)", tel_server.port)

    loader = None
    try:
        trainer = Trainer(cfg, tc, initial_params=initial, device=device,
                          mesh=mesh, lora=lora, telemetry=tel)
        log.info("model=%s layers=%d device=%s seq=%d", cfg.name,
                 cfg.n_layers, device, args.seq)
        if lora is not None:
            from ..models.lora import lora_param_count
            log.info("LoRA r=%d: %.2fM trainable of %.2fB total",
                     args.lora_rank, lora_param_count(trainer.params) / 1e6,
                     cfg.param_count / 1e9)
        if args.checkpoint_dir:
            # resume-from-preemption path (wins over --hf-checkpoint)
            restored = trainer.restore()
            if restart_attempt:
                if restored:
                    log.info("preemption recovery: attempt %d resumes at "
                             "step %d", restart_attempt, trainer.step)
                else:
                    log.warning("preemption recovery: attempt %d found NO "
                                "checkpoint in %s — training restarts at "
                                "step 0", restart_attempt,
                                args.checkpoint_dir)
        batches = None
        if args.data:
            from ..data import device_batches, make_loader
            # start_batch seeks past the data a resumed run consumed
            loader = make_loader(args.data, seq_len=args.seq_len,
                                 batch_size=batch, vocab_size=cfg.vocab_size,
                                 threads=args.data_threads,
                                 start_batch=trainer.step)
            batches = device_batches(loader, device)
        if args.profile_dir and args.steps > 4:
            # steady-state steps only: the first ones build the kernels
            trainer.run(steps=2, batches=batches)
            out = profile_steps(trainer, 3, batches, args.profile_dir)
            log.info("profiler trace written to %s", out["trace"])
            if args.steps > 5:  # steps=0 would mean "tc.steps more"
                out = trainer.run(steps=args.steps - 5, batches=batches)
        else:
            out = trainer.run(steps=args.steps, batches=batches)
        if args.checkpoint_dir:
            trainer.save()  # blocks: the final checkpoint is durable
        if args.export_adapter:
            from ..models.lora import save_adapter
            written = save_adapter(args.export_adapter, trainer.params)
            log.info("adapter written to %s", written)
        if args.eval_steps > 0:
            out.update(trainer.evaluate(steps=args.eval_steps))
    finally:
        if loader is not None:
            loader.close()
        if tel_server is not None:
            tel_server.stop()
        tracer.close()  # flush the JSONL span export
    out.update({"workload": "pretrain", "model": cfg.name, "devices": 1,
                "device": str(device),
                "tokens_per_s_per_chip": round(out["tokens_per_s"], 1)})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
