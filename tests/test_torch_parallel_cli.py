"""train_cas over the data axis from one command line: ``--mesh-size 2
--device cpu`` spawns two gloo ranks (``parallel.launch``), each training on
its half of every batch.

ESPCN x2 + SRCNN on a 32^2 synthetic Sat2Aerx1 set (4 training pairs, batch
2).  Plain data parallelism (with K=2 steps per call), ZeRO-1 and FSDP give
the checkpoints of one process on the same seed within rtol 1e-5 (their
gradients differ by reduction order only); a ZeRO-1 run keeps its full state
in step directories (``--orbax-dir``, ``--keep-last 1``) and an FSDP run in
the npz file, and both resume from it; the compositions the JAX tool
refuses exit with its messages before any worker starts.
"""
import os

import numpy as np
import pytest
import torch

from srcgan_tpu_torch import data
from srcgan_tpu_torch.cli import train_cas


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_data")
    data.make_synthetic_dataset(str(root / "Sat2Aerx1"), n_train=4, n_val=1, n_test=1,
                                size=32, seed=0, colorizable=True)
    return str(root)


def cas_args(synth, tmp, *extra, epochs=1):
    return ["--data-dir", synth, "--SRModel", "ESPCN", "--CModel", "SRCNN",
            "--num-epochs", str(epochs), "--save-every", "1", "--batch-size", "2",
            "--checkpoints", str(tmp / "ck"), "--run-dir", str(tmp / "run"), "--workers", "0",
            "--seed", "5", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def one_process(synth, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    train_cas.main(cas_args(synth, tmp))
    return tmp / "ck"


def assert_same_checkpoints(a, b, epoch=1):
    for name in (f"ESPCN_A2C_x2_{epoch:04d}.npz", f"SRCNN_C2B_x2_{epoch:04d}.npz"):
        with np.load(a / name) as x, np.load(b / name) as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                np.testing.assert_allclose(y[k], x[k], rtol=1e-5, atol=1e-6, err_msg=name + k)


def test_dp_steps_per_dispatch_equal_one_process(synth, one_process, tmp_path, capfd):
    train_cas.main(cas_args(synth, tmp_path, "--mesh-size", "2", "--steps-per-dispatch", "2"))
    out = capfd.readouterr().out
    assert "2 ranks" in out and out.count("Starting Training Loop") == 1   # rank 0 prints
    assert_same_checkpoints(one_process, tmp_path / "ck")
    assert (tmp_path / "ck" / "casstate_latest.npz").exists()


def test_fsdp_equals_one_process_and_resumes_from_npz(synth, one_process, tmp_path, capfd):
    train_cas.main(cas_args(synth, tmp_path, "--mesh-size", "2", "--fsdp"))
    assert_same_checkpoints(one_process, tmp_path / "ck")
    capfd.readouterr()
    train_cas.main(cas_args(synth, tmp_path, "--mesh-size", "2", "--fsdp", "--resume",
                            epochs=2))
    assert "at epoch 2" in capfd.readouterr().out
    assert (tmp_path / "ck" / "ESPCN_A2C_x2_0002.npz").exists()


def test_zero_opt_orbax_dir_and_resume(synth, one_process, tmp_path, capfd):
    ock = tmp_path / "steps"
    flags = ("--mesh-size", "2", "--zero-opt", "--orbax-dir", str(ock), "--keep-last", "1")
    train_cas.main(cas_args(synth, tmp_path, *flags))
    assert_same_checkpoints(one_process, tmp_path / "ck")
    assert sorted(os.listdir(ock)) == ["1"]
    assert not (tmp_path / "ck" / "casstate_latest.npz").exists()
    capfd.readouterr()
    train_cas.main(cas_args(synth, tmp_path, *flags, "--resume", epochs=2))
    assert f"resumed from {ock} at epoch 2" in capfd.readouterr().out
    assert sorted(os.listdir(ock)) == ["2"]                  # keep-last 1
    assert sorted(os.listdir(tmp_path / "ck")) == ["ESPCN_A2C_x2_0002.npz",
                                                   "SRCNN_C2B_x2_0002.npz", "retention.json"]


@pytest.mark.parametrize("flags,message", [
    (["--zero-opt", "--fsdp", "--mesh-size", "2"], "mutually exclusive"),
    (["--zero-opt"], "--zero-opt requires a 1-D --mesh-size data mesh"),
    (["--fsdp", "--mesh-size", "2", "--ema-decay", "0.9"], "composes with the plain DP loop"),
    (["--mesh-size", "2", "--batch-size", "3"], "--batch-size divisible"),
    (["--mesh-size", "2", "--batch-size", "2", "--grad-accum", "2"],
     "--grad-accum composes with the single-device"),
    (["--mesh-size", "2", "--batch-size", "2", "--ema-decay", "0.9"],
     "--ema-decay currently composes"),
])
def test_refused_compositions_exit_before_spawning(flags, message, tmp_path):
    with pytest.raises(SystemExit, match=message):
        train_cas.main(["--data-dir", str(tmp_path / "none"), "--device", "cpu", *flags])
    assert not (tmp_path / "none").exists()
