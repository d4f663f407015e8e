"""``repro_torch.launch.train`` on the CPU (``--device cpu``), reduced
qwen2-1.5b (the printed lines and the resume also for the MoE, Mamba2,
Zamba2, audio and vlm configs): the reference's printed lines, losses equal to a loop over
``make_train_step`` from the same seed (which ``test_torch_train.py``
holds to the reference), a kill after a checkpoint and a resume bit-exact
against an unbroken run, the QAT and gradient-compression flags, and the
default device, the card."""
import re

import numpy as np
import pytest
import torch

from repro.launch import train as j_train
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.launch import train
from repro_torch.models import get_model
from repro_torch.optim import AdamW
from repro_torch.train import init_train_state, make_train_step
from repro_torch.tree import leaves

ARGV = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--batch",
        "4", "--seq", "32"]
#: the archs the launcher's lines and resume are held on: every registered
#: config (qwen2, the MoE, Mamba2, Zamba2, audio and vlm families, and the
#: dense glm4-9b, granite-3-2b and gemma2-2b)
ARCHS = ["qwen2-1.5b", "granite-moe-3b-a800m", "qwen2-moe-a2.7b",
         "mamba2-780m", "zamba2-2.7b", "musicgen-medium", "internvl2-26b",
         "glm4-9b", "granite-3-2b", "gemma2-2b"]


def _argv(arch):
    """ARGV for ``arch``; Mamba2 and Zamba2 on 8-token sequences, where
    the reference launcher's SSD gradient stays finite over six steps
    (from 16 tokens on its gnorm turns NaN: reference fault 12,
    ``tests/test_torch_family_train.py``)."""
    seq = "8" if arch in ("mamba2-780m", "zamba2-2.7b") else "32"
    return ["--arch", arch] + ARGV[2:-1] + [seq]


def _shape_of(text):
    """The printed lines with every number replaced by N (and the verdict
    of the last line dropped: the two packages draw other weights)."""
    return [re.sub(r"\d+", "N", line.replace("NOT improved", "improved"))
            for line in text.splitlines()]


@pytest.mark.parametrize("arch", ARCHS)
def test_main_prints_the_reference_lines(arch, capsys):
    argv = _argv(arch) + ["--steps", "3", "--log-every", "1"]
    assert train.main(argv) == 0
    got = capsys.readouterr().out
    assert j_train.main([a for a in argv if a not in ("--device", "cpu")]) \
        == 0
    want = capsys.readouterr().out
    assert _shape_of(got) == _shape_of(want)
    assert len(got.splitlines()) == 4
    assert re.fullmatch(r"step +0 loss \d+\.\d{4} gnorm \d+\.\d{3} lr "
                        r"\d\.\d{2}e[-+]\d{2} \(\d+\.\ds\)",
                        got.splitlines()[0])


def test_losses_equal_a_loop_over_make_train_step(capsys):
    run = train.run(ARGV + ["--steps", "6"])
    cfg = get_config("qwen2-1.5b", reduced=True)
    model = get_model(cfg, device="cpu")
    opt = AdamW(lr=3e-3, warmup_steps=5, total_steps=6)
    state = init_train_state(model, opt, torch.Generator().manual_seed(0))
    step = make_train_step(model, opt, remat=False)
    pipe = TokenPipeline(32, 4, cfg.vocab, seed=0)
    losses = []
    for i in range(6):
        state, metrics = step(state, pipe.batch_at(i))
        losses.append(float(metrics["loss"]))
    assert run.start_step == 0 and run.losses == losses
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(run.state.params), leaves(state.params)))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step     0 loss") and "->" in out[-1]


class _Killed(Exception):
    pass


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_after_a_kill_is_bit_exact(arch, tmp_path, monkeypatch,
                                          capsys):
    """Checkpoints every 3 steps; one run is killed when it reaches step 4
    (after the step-3 checkpoint), and the same command resumes it from
    there: its state and its step-6 checkpoint equal an unbroken run's."""
    argv = _argv(arch) + ["--steps", "6", "--ckpt-every", "3"]
    straight = train.run(argv + ["--ckpt-dir", str(tmp_path / "a")])

    class Killed(TokenPipeline):
        def batch_at(self, step):
            if step == 4:
                raise _Killed
            return super().batch_at(step)
    monkeypatch.setattr(train, "TokenPipeline", Killed)
    with pytest.raises(_Killed):
        train.run(argv + ["--ckpt-dir", str(tmp_path / "b")])
    monkeypatch.setattr(train, "TokenPipeline", TokenPipeline)
    capsys.readouterr()
    resumed = train.run(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert capsys.readouterr().out.startswith(
        f"resumed from {tmp_path / 'b' / 'ckpt_00000003.npz'} at step 3")
    assert resumed.start_step == 3
    assert resumed.losses == straight.losses[3:]
    pairs = list(zip(leaves((straight.state.params, straight.state.opt)),
                     leaves((resumed.state.params, resumed.state.opt))))
    assert pairs and all(torch.equal(a, b) for a, b in pairs)
    with np.load(tmp_path / "a" / "ckpt_00000006.npz") as x, \
            np.load(tmp_path / "b" / "ckpt_00000006.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        assert all(np.array_equal(x[f], y[f]) for f in x.files)


@pytest.mark.parametrize("flags", [["--quant-bits", "8"],
                                   ["--compress-grads"],
                                   ["--quant-bits", "8", "--compress-grads",
                                    "--microbatches", "2"]])
def test_qat_and_compression_flags_run(flags, capsys):
    run = train.run(ARGV + ["--steps", "3"] + flags)
    assert len(run.losses) == 3 and all(np.isfinite(run.losses))
    assert (run.state.error_feedback is not None) == \
        ("--compress-grads" in flags)


def test_device_defaults_to_the_card():
    assert train.parse_args(["--arch", "qwen2-1.5b"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default trains on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "1"])
