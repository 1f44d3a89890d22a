"""The port's GAN command-line tools on the CPU, and the satellite registry
entries through train_cas.

train_cyclegan --device cpu for one tiny epoch on a 32^2 synthetic
Sat2Aerx2 set (small generators: RDDBNetB/D at nf=16, nb=1, gc=8; PatchGANs
at ndf=16), with --eval-after-save; its netG_A2B checkpoint loads into the
JAX RDDBNetB and gives the port's output (max|diff| <= 1e-5 * max|ref|);
test_cyclegan --device cpu writes the PNGs and a Performs.csv row; the
device pool with K steps per call, --resume and SIGTERM; --perceptual
random, and --mesh-size 2 (with and without --zero-opt) over two gloo
ranks; without --device both tools raise on a host with no card.
"""
import csv
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srcgan_tpu import config as jax_config
from srcgan_tpu import models as jax_models
from srcgan_tpu.train import state as jstate
from srcgan_tpu_torch import data, models
from srcgan_tpu_torch.cli import test_cyclegan, train_cas, train_cyclegan
from srcgan_tpu_torch.interop import load_params_any
from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc
from srcgan_tpu_torch.train.cyclegan import CycleGANTrainer
from srcgan_tpu_torch.train.state import load_train_state

SMALL = dict(nf=16, nb=1, gc=8)
HW, N_TEST = 32, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These sizes are tiny: intra-op threads only contend with the other
    test workers' (the suite runs several processes side by side)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _small_rddb(cls):
    def make(in_nc, out_nc, nf=64, nb=3, gc=32, mode="x2", **kw):
        return cls(in_nc, out_nc, mode=mode, **SMALL, **kw)
    return make


@pytest.fixture(scope="module", autouse=True)
def small_models():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(models.REGISTRY, "RDDBNetB", _small_rddb(models.RDDBNetB))
        mp.setitem(models.REGISTRY, "RDDBNetD", _small_rddb(models.RDDBNetD))
        mp.setitem(models.REGISTRY, "NLayerDiscriminator",
                   lambda c, ndf=64, n=3, **kw: models.NLayerDiscriminator(c, 16, n, **kw))
        yield


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("gan_data")
    data.make_synthetic_dataset(str(root / "Sat2Aerx2"), n_train=3, n_val=1, n_test=N_TEST,
                                size=HW, scale=2, seed=0)
    return str(root)


def gan_args(synth, ck, run, *extra):
    return ["--data-dir", synth, "--num-epochs", "1", "--save-every", "1", "--log-every", "1",
            "--checkpoints", str(ck), "--run-dir", str(run), "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def trained(synth, tmp_path_factory):
    """One epoch of train_cyclegan with --eval-after-save, from the result directory."""
    tmp = tmp_path_factory.mktemp("gan_run")
    cwd = os.getcwd()
    os.chdir(tmp)                     # --eval-after-save writes ./result
    try:
        state = train_cyclegan.main(gan_args(synth, tmp / "ck", tmp / "run",
                                             "--eval-after-save"))
    finally:
        os.chdir(cwd)
    return state, tmp


def test_train_cyclegan_one_epoch_with_eval(trained):
    state, tmp = trained
    assert state.g.step == state.d.step == 3
    ck = tmp / "ck"
    for name in ("netG_A2B_SRtask_x2_0001.npz", "netG_B2A_SRtask_x2_0001.npz",
                 "cyclestate_latest.npz"):
        assert (ck / name).exists(), name
    assert (tmp / "run" / "losses.jsonl").exists()
    with open(tmp / "result" / "Performs.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and rows[0]["checkpoint"] == "netG_A2B_SRtask_x2_0001"
    assert len(os.listdir(tmp / "result" / "cyc_fakeB_netG_A2B_SRtask_x2_0001")) == N_TEST


def test_port_checkpoint_loads_in_jax(trained):
    _, tmp = trained
    path = str(tmp / "ck" / "netG_A2B_SRtask_x2_0001.npz")
    port = load_params_any(models.RDDBNetB(3, 3, mode="x2", **SMALL), path).eval()
    params = jstate.load_params(path)
    jm = jax_models.RDDBNetB(3, 3, mode="x2", **SMALL)
    x = np.random.default_rng(0).uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    with jax_config.matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, train=False)[0])(
            params, jnp.asarray(x)))
    with torch.no_grad():
        got = to_nhwc(port(to_nchw(torch.from_numpy(x)))).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_test_cyclegan_writes_pngs_and_a_row(trained, synth, tmp_path):
    _, tmp = trained
    ck = tmp / "ck"
    out = test_cyclegan.main(["--netGA", str(ck / "netG_A2B_SRtask_x2_0001.npz"),
                              "--netGB", str(ck / "netG_B2A_SRtask_x2_0001.npz"),
                              "--data-dir", synth, "--result-dir", str(tmp_path),
                              "--device", "cpu"])
    assert out["images"] == N_TEST and out["device"] == "cpu"
    assert all(np.isfinite(out[k]) for k in ("MSE", "PSNR", "AE", "SSIM"))
    from PIL import Image
    for side, shape in (("fakeB", (HW, HW)), ("fakeA", (HW // 2, HW // 2))):
        d = tmp_path / f"cyc_{side}_netG_A2B_SRtask_x2_0001"
        names = sorted(os.listdir(d))
        assert len(names) == N_TEST
        with Image.open(d / names[0]) as im:
            assert im.size == shape and im.mode == "RGB"
    with open(tmp_path / "Performs.csv") as f:
        assert f.readline().strip() == "time,checkpoint,MSE,PSNR,AE,SSIM"


def test_device_pool_k_steps_resume_and_sigterm(synth, tmp_path, capsys):
    """--device-pool with 2 iterations a call, then SIGTERM during a resumed
    run: the state is saved for the epoch to be redone, and the caller's
    handler comes back."""
    flags = ("--device-pool", "--steps-per-dispatch", "2", "--bf16-acts", "--no-remat")
    state = train_cyclegan.main(gan_args(synth, tmp_path / "ck", tmp_path / "run", *flags))
    assert state.g.step == 3
    seen = []
    previous = signal.signal(signal.SIGTERM, lambda *a: seen.append("outer"))
    real = CycleGANTrainer.gd_steps_pooled_u8

    def term_then_step(self, *a, **kw):
        os.kill(os.getpid(), signal.SIGTERM)
        return real(self, *a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(CycleGANTrainer, "gd_steps_pooled_u8", term_then_step)
    try:
        state = train_cyclegan.main(gan_args(synth, tmp_path / "ck", tmp_path / "run",
                                             *flags, "--resume", "--num-epochs", "3"))
        out = capsys.readouterr().out
        assert "resumed from" in out and "SIGTERM: train state saved" in out
        assert state.g.step == 3 + 2
        _, extra = load_train_state(str(tmp_path / "ck" / "cyclestate_latest.npz"),
                                    CycleGANTrainer(device="cpu").init(0))
        assert extra["epoch"] == 1                               # redo epoch 2
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == ["outer"]
    finally:
        mp.undo()
        signal.signal(signal.SIGTERM, previous)


@pytest.mark.parametrize("flags,item", [
    (["--perceptual", "random", "--perceptual-weight", "0.1"], "A13"),
    (["--mesh-size", "2", "--net", "SRdens", "--batch-size", "2"], "A14"),
    (["--mesh-size", "2", "--zero-opt", "--pool-size", "0", "--net", "SRdens",
      "--batch-size", "2"], "A14")])
def test_unported_flags_exit_naming_their_item(flags, item, synth, tmp_path):
    """The flags that ROADMAP ``item`` brought, now run: the VGG16 term on the
    cycle reconstructions (random VGG weights), and two gloo ranks spawned by
    the tool (the registry's full-width nets there; net SRdens keeps them
    small) with plain data parallelism through the host pools, and with
    ZeRO-1; each writes its checkpoints and full state."""
    train_cyclegan.main(gan_args(synth, tmp_path / "ck", tmp_path / "run", *flags))
    for name in ("netG_A2B_SRtask_x2_0001.npz", "netG_B2A_SRtask_x2_0001.npz",
                 "cyclestate_latest.npz"):
        assert (tmp_path / "ck" / name).exists(), name


def test_tools_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cyclegan.main(["--num-epochs", "0"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        test_cyclegan.main(["--netGA", "a_x2.npz", "--netGB", "b.npz"])


@pytest.mark.parametrize("model", ["EDSR", "SRDN"])
def test_train_cas_builds_the_satellite_models(model, tmp_path, monkeypatch):
    """--SRModel EDSR / SRDN parse and build (no epochs run)."""
    monkeypatch.setitem(models.REGISTRY, "EDSR",
                        lambda *a, **kw: models.EDSR(*a, num_residuals=2, **kw))
    data.make_synthetic_dataset(str(tmp_path / "Sat2Aerx1"), n_train=2, n_val=1, n_test=1,
                                size=16)
    state = train_cas.main(["--data-dir", str(tmp_path), "--SRModel", model, "--up", "2",
                            "--num-epochs", "0", "--checkpoints", str(tmp_path / "ck"),
                            "--run-dir", str(tmp_path / "run"), "--device", "cpu"])
    assert type(state.sr.model).__name__ == model
