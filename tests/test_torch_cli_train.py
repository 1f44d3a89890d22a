"""The port's ``cli.train_cas`` on the CPU: small models (ESPCN x2 +
ResDeconv) on a 32^2 synthetic set.

The tool is held to its own invariants: checkpoints and logs, an exact
resume, K steps per call equal to the plain loop on the same batches,
preemption (SIGTERM saves the full state and the caller's handler comes
back), the non-finite stop, retention and early stopping; and its
checkpoints load in the JAX package's ``test_cas`` and score the same there
(PSNR 0.01 dB, SSIM 1e-4, MSE and AE rtol 1e-4).
"""
import json
import os
import signal

import numpy as np
import pytest
import torch

from srcgan_tpu.cli import test_cas as jax_test_cas
from srcgan_tpu_torch import data
from srcgan_tpu_torch.cli import test_cas, train_cas
from srcgan_tpu_torch.data.dataset import _read_png
from srcgan_tpu_torch.train.cas import CasTrainer
from srcgan_tpu_torch.train.state import load_params, load_train_state


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These sizes are tiny: intra-op threads only contend with the other
    test workers' (the suite runs several processes side by side)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("ds")
    data.make_synthetic_dataset(str(d / "Sat2Aerx1"), n_train=6, n_val=1, n_test=3,
                                size=32, colorizable=True)
    return str(d)


def eval_args(ckpts, synth, result, *extra):
    return ["--netGA", ckpts[0], "--netGB", ckpts[1], "--data-dir", synth,
            "--result-dir", str(result), *extra]


def train_args(synth, ckpt, run, *extra):
    return ["--data-dir", synth, "--SRModel", "ESPCN", "--CModel", "ResDeconv", "--up", "2",
            "--checkpoints", str(ckpt), "--run-dir", str(run), "--device", "cpu",
            "--workers", "0", *extra]


@pytest.fixture(scope="module")
def trained(synth, tmp_path_factory):
    """Two epochs of the plain loop, batch 2, checkpoints at both."""
    d = tmp_path_factory.mktemp("train")
    state = train_cas.main(train_args(synth, d / "ckpt", d / "run", "--num-epochs", "2",
                                      "--save-every", "1", "--batch-size", "2",
                                      "--log-every", "2", "--live-port", "0"))
    return d, state


def test_train_cas_leaves_checkpoints_and_logs(trained):
    d, state = trained
    assert sorted(os.listdir(d / "ckpt")) == [
        "ESPCN_A2C_x2_0001.npz", "ESPCN_A2C_x2_0002.npz", "ResDeconv_C2B_x2_0001.npz",
        "ResDeconv_C2B_x2_0002.npz", "casstate_latest.npz", "retention.json"]
    assert state.sr.step == state.c.step == 6
    run = sorted(os.listdir(d / "run"))
    assert "losses.jsonl" in run and {"fake_BB.png", "real_B.png", "fake_AB.png"} <= set(run)
    assert len((d / "run" / "losses.jsonl").read_text().splitlines()) == 2
    saved = load_params(str(d / "ckpt" / "ESPCN_A2C_x2_0002.npz"))
    live = dict(state.sr.model.named_parameters())
    np.testing.assert_array_equal(saved["conv1"]["b"], live["conv1.bias"].detach().numpy())


def test_port_trained_checkpoints_load_in_jax_test_cas(trained, synth, tmp_path):
    d, _ = trained
    ckpts = (str(d / "ckpt" / "ESPCN_A2C_x2_0002.npz"), str(d / "ckpt" / "ResDeconv_C2B_x2_0002.npz"))
    theirs = jax_test_cas.main(eval_args(ckpts, synth, tmp_path / "jax")).iloc[-1]
    ours = test_cas.main(eval_args(ckpts, synth, tmp_path / "port", "--device", "cpu"))
    assert theirs["checkpoint"] == "ESPCN_A2C_x2_0002"
    assert abs(ours["PSNR"] - float(theirs["PSNR"])) <= 0.01
    assert abs(ours["SSIM"] - float(theirs["SSIM"])) <= 1e-4
    np.testing.assert_allclose(ours["MSE"], float(theirs["MSE"]), rtol=1e-4)
    np.testing.assert_allclose(ours["AE"], float(theirs["AE"]), rtol=1e-4)


def params_of(state):
    return [p.detach().clone() for ts in (state.sr, state.c) for p in ts.model.parameters()]


def test_resume_continues_at_the_right_epoch(trained, synth, tmp_path, capsys):
    """Epoch 1, then --resume to epoch 2, equals the two epochs run at once."""
    d, whole = trained
    first = train_args(synth, tmp_path / "ckpt", tmp_path / "run", "--save-every", "1",
                       "--batch-size", "2", "--log-every", "2")
    train_cas.main(first + ["--num-epochs", "1"])
    _, extra = load_train_state(str(tmp_path / "ckpt" / "casstate_latest.npz"),
                                CasTrainer("ESPCN", "ResDeconv", device="cpu").init(0))
    assert extra["epoch"] == 1
    capsys.readouterr()
    # the schedule depends on --num-epochs: resume under the whole run's
    resumed = train_cas.main(first + ["--num-epochs", "2", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from" in out and "at epoch 2" in out and "Epoch 01" not in out
    assert resumed.sr.step == 6
    assert os.path.exists(tmp_path / "ckpt" / "ESPCN_A2C_x2_0002.npz")
    # epoch 1 ran at lr(1) of a 1-epoch schedule, the whole run's at lr(1) of 2
    for a, b in zip(params_of(resumed), params_of(whole)):
        assert a.shape == b.shape
    again = train_cas.main(first + ["--num-epochs", "2", "--resume"])
    assert again.sr.step == 6                                    # nothing left to do


def test_resume_is_exact(synth, tmp_path):
    """Interrupted after epoch 1 of 2 (same schedule) and resumed == uninterrupted."""
    base = ["--save-every", "1", "--batch-size", "3", "--num-epochs", "2"]
    whole = train_cas.main(train_args(synth, tmp_path / "a", tmp_path / "ra", *base))
    calls = {"n": 0}
    real = CasTrainer.train_step_u8

    def die_after_epoch_one(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:                                      # before epoch 2's first step
            raise KeyboardInterrupt
        return real(self, *a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(CasTrainer, "train_step_u8", die_after_epoch_one)
    try:
        with pytest.raises(KeyboardInterrupt):
            train_cas.main(train_args(synth, tmp_path / "b", tmp_path / "rb", *base))
    finally:
        mp.undo()
    resumed = train_cas.main(train_args(synth, tmp_path / "b", tmp_path / "rb", *base, "--resume"))
    assert resumed.sr.step == whole.sr.step == 4
    for a, b in zip(params_of(resumed), params_of(whole)):
        assert torch.equal(a, b)


def test_steps_per_dispatch_equals_the_plain_loop(synth, tmp_path):
    """K=2 stacked blocks (and a ragged tail block of one) give the same
    weights and the same logged losses as one step per call."""
    base = ["--num-epochs", "1", "--save-every", "1", "--batch-size", "2", "--log-every", "1"]
    plain = train_cas.main(train_args(synth, tmp_path / "p", tmp_path / "rp", *base))
    blocks = train_cas.main(train_args(synth, tmp_path / "k", tmp_path / "rk", *base,
                                       "--steps-per-dispatch", "2"))
    assert plain.sr.step == blocks.sr.step == 3
    for a, b in zip(params_of(plain), params_of(blocks)):
        assert torch.equal(a, b)
    rows = [[json.loads(l)["losses"] for l in (tmp_path / r / "losses.jsonl").read_text().splitlines()]
            for r in ("rp", "rk")]
    assert rows[0] == rows[1] and len(rows[0]) == 3


def test_stacked_blocks_flush_on_ragged_tails():
    def it():
        for n in (2, 2, 2, 2, 2, 1):
            yield np.zeros((n, 4, 4, 3), np.uint8), np.ones((n, 8, 8, 3), np.uint8), None

    shapes = [(s.shape, t.shape) for s, t in train_cas._stacked_blocks(it(), 2)]
    assert shapes == [((2, 2, 4, 4, 3), (2, 2, 8, 8, 3))] * 2 + [
        ((1, 2, 4, 4, 3), (1, 2, 8, 8, 3)), ((1, 1, 4, 4, 3), (1, 1, 8, 8, 3))]


def test_sigterm_saves_the_state_and_restores_the_handler(synth, tmp_path, capsys):
    seen = []
    previous = signal.signal(signal.SIGTERM, lambda *a: seen.append("outer"))
    real = CasTrainer.train_step_u8

    def term_on_second(self, *a, **kw):
        if self.calls == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        self.calls += 1
        return real(self, *a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(CasTrainer, "calls", 0, raising=False)
    mp.setattr(CasTrainer, "train_step_u8", term_on_second)
    try:
        state = train_cas.main(train_args(synth, tmp_path / "ckpt", tmp_path / "run",
                                          "--num-epochs", "3", "--batch-size", "2"))
        assert state.sr.step == 2 and "SIGTERM: train state saved" in capsys.readouterr().out
        _, extra = load_train_state(str(tmp_path / "ckpt" / "casstate_latest.npz"),
                                    CasTrainer("ESPCN", "ResDeconv", device="cpu").init(0))
        assert extra["epoch"] == 0                               # redo epoch 1
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == ["outer"]                                 # the caller's handler is back
    finally:
        mp.undo()
        signal.signal(signal.SIGTERM, previous)


def test_non_finite_loss_stops_the_run(synth, tmp_path):
    real = CasTrainer.train_step_u8

    def poisoned(self, *a, **kw):
        state, m = real(self, *a, **kw)
        return state, {**m, "loss_C": m["loss_C"] * float("nan")}

    mp = pytest.MonkeyPatch()
    mp.setattr(CasTrainer, "train_step_u8", poisoned)
    handler = signal.getsignal(signal.SIGTERM)
    try:
        with pytest.raises(RuntimeError, match="non-finite loss at epoch 1 it 1.*--resume"):
            train_cas.main(train_args(synth, tmp_path / "ckpt", tmp_path / "run",
                                      "--num-epochs", "1"))
    finally:
        mp.undo()
    assert signal.getsignal(signal.SIGTERM) is handler


@pytest.mark.parametrize("flags,leaves", [
    (["--ema-decay", "0.9"], "ema"),
    (["--grad-accum", "2"], None),
    (["--remat", "--augment", "--cache", "--workers", "2", "--bf16"], None),
    (["--bf16-acts", "--steps-per-dispatch", "3"], None),
], ids=["ema", "grad-accum", "remat-augment-cache-bf16", "bf16-acts-blocks"])
def test_train_options_run(synth, tmp_path, flags, leaves):
    state = train_cas.main(train_args(synth, tmp_path / "ckpt", tmp_path / "run", "--num-epochs",
                                      "1", "--save-every", "1", "--batch-size", "2", *flags))
    assert state.sr.step == 3
    net_a = load_params(str(tmp_path / "ckpt" / "ESPCN_A2C_x2_0001.npz"))
    assert all(np.isfinite(v).all() for layer in net_a.values() for v in layer.values())
    if leaves == "ema":
        ema = load_params(str(tmp_path / "ckpt" / "ema" / "ESPCN_A2C_x2_0001.npz"))
        assert ema.keys() == net_a.keys()
        assert not np.array_equal(ema["conv1"]["w"], net_a["conv1"]["w"])
    assert next(state.sr.model.parameters()).dtype == torch.float32     # fp32 masters


def test_const_pipeline_trains_and_both_test_cas_score_it(synth, tmp_path):
    """--const with a size-preserving SR net (SRCNN): train_cas, then both
    test_cas tools with --const on its checkpoints."""
    state = train_cas.main(train_args(synth, tmp_path / "ckpt", tmp_path / "run", "--SRModel",
                                      "SRCNN", "--const", "--num-epochs", "1", "--save-every",
                                      "1", "--batch-size", "3"))
    assert state.sr.step == 2
    ckpts = (str(tmp_path / "ckpt" / "SRCNN_A2C_x2_0001.npz"),
             str(tmp_path / "ckpt" / "ResDeconv_C2B_x2_0001.npz"))
    ours = test_cas.main(eval_args(ckpts, synth, tmp_path / "port", "--const", "--device", "cpu"))
    theirs = jax_test_cas.main(eval_args(ckpts, synth, tmp_path / "jax", "--const")).iloc[-1]
    assert abs(ours["PSNR"] - float(theirs["PSNR"])) <= 0.01
    assert abs(ours["SSIM"] - float(theirs["SSIM"])) <= 1e-4
    assert _read_png(str(tmp_path / "port" / "B_SRCNN_x2_0001" / "test-0.png")).shape == (32, 32, 3)


def test_retention_and_early_stop(synth, tmp_path, capsys):
    train_cas.main(train_args(synth, tmp_path / "ckpt", tmp_path / "run", "--num-epochs", "3",
                              "--save-every", "1", "--batch-size", "3", "--keep-last", "1"))
    kept = sorted(f for f in os.listdir(tmp_path / "ckpt") if f.startswith("ESPCN"))
    assert kept == ["ESPCN_A2C_x2_0003.npz"]
    train_cas.main(train_args(synth, tmp_path / "c2", tmp_path / "r2", "--num-epochs", "5",
                              "--batch-size", "3", "--early-stop-patience", "1",
                              "--early-stop-delta", "100"))
    assert "early stop at epoch 2" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "c2" / "ESPCN_A2C_x2_0002.npz")
