"""``train_main --profile-dir`` (ROADMAP Queue 1 #7.9) and the flags the
port's training CLI still refuses, each by its item.

- ``--profile-dir`` mirrors the JAX ``test_train_main_profile_trace``
  (``tests/test_workload_mains.py``): with 6 steps it traces steps 3-5
  into a Chrome trace under the directory, three ``train_step`` ranges,
  and the summary still reports every step's tokens/s; with 4 steps it
  traces nothing, as the JAX main does.
- ``--profiler-port`` (no PyTorch counterpart), ``--elastic-batch-mode``
  and ``TPU_ELASTIC_RESIZE`` (#7.5), ``--fsdp``/``--tensor``/``--stage``
  and a multi-process gang (#7.8, #8) stay refused by name, before any
  weight.
"""

from __future__ import annotations

import json
import os

import pytest

from k8s_runpod_kubelet_tpu_torch.workloads import train_main
from k8s_runpod_kubelet_tpu_torch.workloads.train import STEP_RANGE

TINY = ["--model", "tiny", "--batch", "2", "--seq-len", "32",
        "--device", "cpu"]


def _trace_ranges(path: str) -> list[str]:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("name") == STEP_RANGE
            and e.get("cat") == "user_annotation"]


def test_profile_dir_traces_steps_three_to_five(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    assert train_main.main([*TINY, "--steps", "6",
                            "--profile-dir", str(trace_dir)]) == 0
    found = [os.path.join(r, f) for r, _, fs in os.walk(trace_dir)
             for f in fs]
    assert found == [str(trace_dir / train_main.PROFILE_TRACE)]
    assert len(_trace_ranges(found[0])) == 3
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 1      # the run after the traced three
    assert summary["tokens_per_s_per_chip"] > 0


def test_profile_dir_under_five_steps_traces_nothing(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    assert train_main.main([*TINY, "--steps", "4",
                            "--profile-dir", str(trace_dir)]) == 0
    assert not trace_dir.exists()
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 4


@pytest.mark.parametrize("argv,env,item", [
    (["--profiler-port", "9999"], {}, "profiler server"),
    (["--elastic-batch-mode", "global"], {}, "#7.5"),
    ([], {"TPU_ELASTIC_RESIZE": "1"}, "#7.5"),
    (["--fsdp", "2"], {}, "#7.8, #8"),
    (["--tensor", "2"], {}, "#7.8, #8"),
    (["--stage", "2"], {}, "#7.8, #8"),
    ([], {"JAX_NUM_PROCESSES": "2"}, "#7.8"),
], ids=["profiler_port", "elastic_flag", "elastic_env", "fsdp", "tensor",
        "stage", "gang"])
def test_refusals_name_their_item(argv, env, item, monkeypatch, capsys):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as exc:
        train_main.main([*TINY, "--steps", "1", *argv])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported" in err and item in err


@pytest.mark.parametrize("env,device,want", [
    ("v5litepod-8", "cuda", "NVIDIA H100 80GB HBM3"),
    ("", "cuda", "NVIDIA H100 80GB HBM3"),
    ("v6e-4", "cpu", "v6e-4"),
    ("", "cpu", ""),
])
def test_the_mfu_peak_reads_the_card_first(env, device, want, monkeypatch):
    import torch

    monkeypatch.setenv("TPU_ACCELERATOR_TYPE", env)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert train_main.mfu_accelerator(torch.device(device)) == want
