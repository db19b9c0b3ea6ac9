"""repro_torch.launch.train, the training CLI, in process on the CPU.

A smoke run prints the reference's lines (params, the plan's stash
bound against autodiff's, each step's loss, grad norm and lr, the final
loss with s/step, restarts and stragglers); ``--resume`` from a
checkpoint continues to the same history as a straight run; the CLI
refuses what it cannot train and runs on the card unless told
otherwise.
"""
import re
import shutil
import signal

import numpy as np
import pytest
import torch

from repro_torch.launch import train as launch

ARGS = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--d-model", "64", "--layers", "2",
        "--global-batch", "4", "--seq-len", "16", "--microbatches", "2", "--warmup", "2",
        "--lr", "1e-3", "--log-every", "1"]


def test_smoke_run_prints_the_reference_lines(tmp_path, capsys):
    prev = signal.getsignal(signal.SIGTERM)
    history = launch.main(ARGS + ["--steps", "4", "--checkpoint-dir", str(tmp_path),
                                  "--pipeline-schedule", "one_f_one_b",
                                  "--pipeline-backward", "planned", "--kernels", "auto",
                                  "--attn-impl", "chunked"])
    out = capsys.readouterr().out
    assert [h["step"] for h in history] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert re.search(r"arch=olmo-1b params=\d+\.\dM device=cpu", out)
    assert "combined-plan stash bound 2/2 microbatches per stage at a 4-stage split" in out
    assert "autodiff keeps 2/2 live" in out
    assert len(re.findall(r"^step +\d+  loss \d+\.\d{4}  gnorm \d+\.\d{3}  lr \d\.\d\de-\d\d$",
                          out, re.M)) == 4
    assert re.search(r"final loss \d+\.\d{4}  \(\d+\.\d\ds/step, restarts=0, stragglers=\d+\)",
                     out)
    assert (tmp_path / "heartbeat").exists()
    assert signal.getsignal(signal.SIGTERM) is prev  # main hands SIGTERM back


def test_resume_continues_the_straight_history(tmp_path, capsys):
    straight = launch.main(ARGS + ["--steps", "4", "--checkpoint-every", "2",
                                   "--checkpoint-dir", str(tmp_path / "a")])
    launch.main(ARGS + ["--steps", "4", "--checkpoint-every", "2",
                        "--checkpoint-dir", str(tmp_path / "b")])
    # preempted after step 2: the newest checkpoint is step 2's
    shutil.rmtree(tmp_path / "b" / "step_00000004")
    capsys.readouterr()
    resumed = launch.main(ARGS + ["--steps", "4", "--checkpoint-every", "2", "--resume",
                                  "--checkpoint-dir", str(tmp_path / "b")])
    assert "resumed from step 2" in capsys.readouterr().out
    assert [h["step"] for h in resumed] == [2, 3]
    assert resumed == straight[2:]


@pytest.mark.parametrize("arch", ["musicgen-medium", "llama-3.2-vision-90b"])
def test_embedding_inputs_exit_with_a_message(arch, tmp_path):
    with pytest.raises(SystemExit, match="synthetic source makes tokens only"):
        launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1",
                     "--checkpoint-dir", str(tmp_path)])


def test_refuses_cuda_kernels_and_needs_a_card_by_default(tmp_path, monkeypatch):
    with pytest.raises(SystemExit):  # argparse: "cuda" is not a choice
        launch.main(ARGS + ["--kernels", "cuda", "--checkpoint-dir", str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.main([a for a in ARGS if a not in ("--device", "cpu")]
                    + ["--steps", "1", "--checkpoint-dir", str(tmp_path)])
