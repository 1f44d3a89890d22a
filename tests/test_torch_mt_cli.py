"""The port's train_multitask and prepare_data tools on the CPU.

train_multitask --device cpu for one epoch on a 32^2 synthetic Sat2Aerx2
set (ngf 8, resnet_6blocks): the three checkpoints
``netG_{G_A,G_B,G_C}_MTtask_x2_0001.npz`` load into the port's nets with
``strict=True``, and G_A's into the JAX generator, which gives the port's
output (rel-L2 1e-5); the logged losses are the JAX tool's four.  A second
run with --device-pool, --pack-passes and --bf16-acts; --mesh-size 2 over
two gloo ranks; without --device the tool raises on a host with no card.
prepare_data writes the JAX tool's lists for the same seed.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srcgan_tpu import config as jax_config
from srcgan_tpu import models as jax_models
from srcgan_tpu.cli import prepare_data as jax_prepare
from srcgan_tpu.train import state as jstate
from srcgan_tpu_torch import data, models
from srcgan_tpu_torch.cli import prepare_data, train_multitask
from srcgan_tpu_torch.interop import load_params_any
from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc

HW, NGF, NET = 32, 8, "resnet_6blocks"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These sizes are small: intra-op threads only contend with the other
    test workers' (the suite runs several processes side by side)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("mt_data")
    data.make_synthetic_dataset(str(root / "Sat2Aerx2"), n_train=3, n_val=1, n_test=1,
                                size=HW, scale=2, seed=0)
    return str(root)


def mt_args(synth, tmp, *extra):
    return ["--data-dir", synth, "--num-epochs", "1", "--save-every", "1", "--log-every", "1",
            "--ngf", str(NGF), "--netG", NET, "--checkpoints", str(tmp / "ck"),
            "--run-dir", str(tmp / "run"), "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def trained(synth, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mt_run")
    return train_multitask.main(mt_args(synth, tmp)), tmp


def test_one_epoch_writes_three_loadable_checkpoints(trained):
    state, tmp = trained
    assert state.g.step == state.d.step == 3
    nets = {"G_A": models.define_G(1, 3, NGF, NET, "instance"),
            "G_B": models.define_G(3, 1, NGF, NET, "instance"),
            "G_C": models.SRDenseNetA(1, 1, mode="x2", num_blocks=2, num_layers=2)}
    for name, net in nets.items():
        load_params_any(net, str(tmp / "ck" / f"netG_{name}_MTtask_x2_0001.npz"))
        for k, v in net.state_dict().items():
            assert torch.equal(v, state.g.model[name].state_dict()[k]), (name, k)
    with open(tmp / "run" / "losses.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 3
    assert set(rows[0]["losses"]) == {"loss_G", "loss_G_C", "loss_D_A", "loss_D_B"}


def test_checkpoint_loads_in_jax(trained):
    _, tmp = trained
    path = str(tmp / "ck" / "netG_G_A_MTtask_x2_0001.npz")
    port = load_params_any(models.define_G(1, 3, NGF, NET, "instance"), path)
    jm = jax_models.define_G(1, 3, NGF, NET, "instance")
    x = np.random.default_rng(0).uniform(0, 1, (1, HW, HW, 1)).astype(np.float32)
    with jax_config.matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, v: jm.fwd(p, v, train=True))(
            jstate.load_params(path), jnp.asarray(x)))
    with torch.no_grad():
        got = to_nhwc(port.train()(to_nchw(torch.from_numpy(x)))).numpy()
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def test_device_pool_pack_passes_bf16(synth, tmp_path):
    state = train_multitask.main(mt_args(synth, tmp_path, "--device-pool", "--pack-passes",
                                         "--bf16-acts"))
    assert state.g.step == 3
    assert all(p.dtype == torch.float32 for p in state.g.model.parameters())
    assert (tmp_path / "ck" / "netG_G_C_MTtask_x2_0001.npz").exists()


def test_mesh_size_exits_naming_a14(synth, tmp_path):
    """--mesh-size (brought by ROADMAP A14) now runs: two gloo ranks spawned
    by the tool, BatchNorm on the global batch, the host pools on the
    gathered fakes; rank 0 writes the three checkpoints."""
    train_multitask.main(mt_args(synth, tmp_path, "--mesh-size", "2", "--batch-size", "2"))
    for name in ("G_A", "G_B", "G_C"):
        assert (tmp_path / "ck" / f"netG_{name}_MTtask_x2_0001.npz").exists()
    with pytest.raises(SystemExit, match="divisible"):
        train_multitask.main(mt_args(synth, tmp_path, "--mesh-size", "2", "--batch-size", "3"))


def test_tool_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_multitask.main(["--num-epochs", "0"])


def test_prepare_data_lists_equal_the_jax_tools(tmp_path):
    rng = np.random.default_rng(0)
    names = [f"p{i:02d}.png" for i in range(23)]
    for side in ("ours", "theirs"):
        for sub in ("src", "tar"):
            os.makedirs(tmp_path / side / sub)
            for n in names + ([f"only_{sub}.png"] if sub == "src" else []):
                (tmp_path / side / sub / n).write_bytes(rng.bytes(8))
    prepare_data.main(["--dir", str(tmp_path / "ours"), "--val", "0.15", "--seed", "7"])
    jax_prepare.main(["--dir", str(tmp_path / "theirs"), "--val", "0.15", "--seed", "7"])
    for split in ("train", "val", "test", "all"):
        ours = (tmp_path / "ours" / f"{split}.txt").read_text()
        assert ours == (tmp_path / "theirs" / f"{split}.txt").read_text(), split
    assert len((tmp_path / "ours" / "all.txt").read_text().split()) == 23
    with pytest.raises(SystemExit, match="--force"):
        prepare_data.main(["--dir", str(tmp_path / "ours")])
