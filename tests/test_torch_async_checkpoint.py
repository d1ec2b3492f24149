"""The trainer's checkpoints (``workloads/train.py``: ``CheckpointWriter``,
``Trainer.save(block=)``, ``wait_pending``, ``restore``) on the CPU.

- the loop's staged saves, and a direct
  ``save(block=False)`` followed by ``wait_pending``, restore into a fresh
  trainer bit for bit: every parameter, both moments, the count and the
  step; a LoRA trainer's too (its file holds the adapters, the moments
  and the frozen base's fingerprint; a resume over another base, or by a
  full trainer, is refused);
- the telemetry's ``unsaved_work_s`` resets only when the staged write is
  durable (``wait_pending`` -> ``checkpoint_durable``), to the productive
  time since the staging point, as in the JAX trainer; a blocking save
  resets it to 0 at once;
- a write that raises before its rename (the writer's test hook) leaves
  no temporary file, fails the save with the error, and leaves the
  previous checkpoint the newest and loadable;
- pruning keeps the newest three; a step already saved is not written
  again (orbax's skip), and the loop's logs carry the staged and saved
  markers.
"""

import logging
import threading

import pytest
import torch

from k8s_runpod_kubelet_tpu_torch.models import tiny_llama
from k8s_runpod_kubelet_tpu_torch.models.lora import LoraConfig
from k8s_runpod_kubelet_tpu_torch.workloads.telemetry import \
    TrainingTelemetry
from k8s_runpod_kubelet_tpu_torch.workloads.train import (TrainConfig,
                                                          Trainer, _leaves,
                                                          trainable)

CFG = tiny_llama(vocab_size=64, embed_dim=32, n_layers=2, n_heads=2,
                 n_kv_heads=1, mlp_dim=64, max_seq_len=32,
                 dtype=torch.float32)
B, S = 2, 8


def _tc(ck, **kw):
    return TrainConfig(learning_rate=1e-2, warmup_steps=1, steps=3,
                       batch_size=B, seq_len=S, checkpoint_dir=str(ck), **kw)


def _batches(seed=0):
    gen = torch.Generator().manual_seed(seed)
    while True:
        yield torch.randint(0, CFG.vocab_size, (B, S + 1), generator=gen)


def _state(tr):
    return (_leaves(tr.params) + _leaves(tr.opt_state["mu"])
            + _leaves(tr.opt_state["nu"]))


def _same(a, b):
    assert a.step == b.step
    assert a.opt_state["count"] == b.opt_state["count"]
    sa, sb = _state(a), _state(b)
    assert len(sa) == len(sb)
    assert all(torch.equal(x, y) for x, y in zip(sa, sb))


@pytest.mark.parametrize("lora", [None, LoraConfig(rank=2, alpha=4.0)])
def test_staged_saves_restore_bit_for_bit(tmp_path, lora, caplog):
    a = Trainer(CFG, _tc(tmp_path / "ck", checkpoint_every=1), device="cpu",
                lora=lora)
    with caplog.at_level(logging.INFO):
        a.run(steps=3, batches=_batches())
    assert "checkpoint staged at step 3 (write in background)" in caplog.text
    assert "checkpoint saved at step 3" in caplog.text
    b = _fresh(tmp_path, lora, 9)
    assert b.restore()
    _same(a, b)
    # a direct staged save, then the wait
    a.step_fn(a.params, a.opt_state, next(_batches(1)))
    a.step += 1
    a.save(block=False)
    a.wait_pending()
    c = _fresh(tmp_path, lora, 8)
    assert c.restore() and c.step == 4
    _same(a, c)


def _fresh(tmp_path, lora, seed):
    """A trainer to restore into, every trainable leaf different from the
    saved one's. A LoRA trainer takes the base of seed 0 (the resume
    rebuilds the base the checkpoint names) and redrawn adapters."""
    if lora is None:
        return Trainer(CFG, _tc(tmp_path / "ck"), device="cpu", seed=seed)
    tr = Trainer(CFG, _tc(tmp_path / "ck"), device="cpu", lora=lora)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in _leaves(trainable(tr.params, tr.trainable_mask)):
            p.copy_(torch.randn(p.shape, generator=gen))
    return tr


def test_a_lora_checkpoint_holds_the_adapters_and_names_its_base(tmp_path):
    lora = LoraConfig(rank=2, alpha=4.0, targets=("wq", "w_down"))
    a = Trainer(CFG, _tc(tmp_path / "ck"), device="cpu", lora=lora)
    a.run(steps=1, batches=_batches())
    a.save()
    state = torch.load(a.checkpoints.checkpoints()[-1][1],
                       weights_only=True)
    assert set(state) == {"step", "params", "opt_state", "frozen"}
    assert set(state["params"]) == {"layers"}
    assert {k: set(v) for k, v in state["params"]["layers"].items()} == {
        "wq": {"lora_a", "lora_b"}, "w_down": {"lora_a", "lora_b"}}
    frozen = [p for p in _leaves(a.params) if not p.requires_grad]
    assert state["frozen"] == a.frozen_fingerprint()
    assert len(state["frozen"]) == len(frozen)
    # a resume over another base (another seed) is refused by name
    other = Trainer(CFG, _tc(tmp_path / "ck"), device="cpu", seed=1,
                    lora=lora)
    with pytest.raises(ValueError, match="other frozen weights"):
        other.restore()
    # and a full trainer cannot read it either
    with pytest.raises(ValueError, match="other frozen weights"):
        Trainer(CFG, _tc(tmp_path / "ck"), device="cpu").restore()


class _Mono:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_unsaved_work_resets_only_when_the_write_is_durable(tmp_path):
    mono = _Mono()
    tel = TrainingTelemetry(tokens_per_step=B * S, clock=mono, mono=mono)
    tr = Trainer(CFG, _tc(tmp_path / "ck"), device="cpu", telemetry=tel)
    gate = threading.Event()
    tr.checkpoints.before_rename = lambda tmp: gate.wait(10)
    tel.run_started()
    mono.t += 1.0
    tel.record_step(1, 1.0)           # the compile bucket closes
    mono.t += 5.0                     # 5 s productive
    tr.step = 1
    tr.save(block=False)              # staged at productive 5
    mono.t += 3.0                     # training on while the write is out
    assert tel.telemetry_payload()["unsaved_work_s"] == pytest.approx(8.0)
    assert tr.checkpoints.checkpoints() == []
    gate.set()
    tr.wait_pending()
    assert [s for s, _ in tr.checkpoints.checkpoints()] == [1]
    # the baseline moved to the staging point: 3 s since are exposed
    assert tel.telemetry_payload()["unsaved_work_s"] == pytest.approx(3.0)
    tr.checkpoints.before_rename = None
    tr.step = 2
    tr.save()                         # blocking: durable at once
    assert tel.telemetry_payload()["unsaved_work_s"] == pytest.approx(0.0)


def test_a_write_that_fails_leaves_the_previous_checkpoint(tmp_path):
    ck = tmp_path / "ck"
    a = Trainer(CFG, _tc(ck), device="cpu")
    batches = _batches()
    a.run(steps=1, batches=batches)
    a.save()
    saved = [t.clone() for t in _state(a)]
    a.run(steps=1, batches=batches)

    def interrupted(tmp):
        with open(tmp, "r+b") as f:
            f.truncate(100)               # a torn write
        raise OSError("disk went away")

    a.checkpoints.before_rename = interrupted
    a.save(block=False)
    with pytest.raises(RuntimeError, match="previous one") as err:
        a.wait_pending()
    assert isinstance(err.value.__cause__, OSError)
    assert [s for s, _ in a.checkpoints.checkpoints()] == [1]
    assert sorted(p.name for p in ck.iterdir()) == ["step_00000001.pt"]
    b = Trainer(CFG, _tc(ck), device="cpu", seed=5)
    assert b.restore() and b.step == 1
    assert all(torch.equal(x, y) for x, y in zip(_state(b), saved))


def test_pruning_keeps_three_and_a_saved_step_is_not_written_again(
        tmp_path, caplog):
    tr = Trainer(CFG, _tc(tmp_path / "ck", checkpoint_every=1),
                 device="cpu")
    tr.run(steps=5, batches=_batches())
    assert [s for s, _ in tr.checkpoints.checkpoints()] == [3, 4, 5]
    path = tr.checkpoints.checkpoints()[-1][1]
    before = path.stat().st_mtime_ns
    with caplog.at_level(logging.INFO):
        tr.save()
    assert path.stat().st_mtime_ns == before
    assert [s for s, _ in tr.checkpoints.checkpoints()] == [3, 4, 5]
