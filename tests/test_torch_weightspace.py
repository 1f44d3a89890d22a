"""The port's weight-space blending (``weightspace`` + ``cli.blend``) against
the JAX package's on the same checkpoints.

Both sum in float64 and round once to float32: the blended tensors agree
within 1e-7.  A ``cli.blend`` output loads in both packages.
"""
import os

import numpy as np
import pytest
import torch

from srcgan_tpu import models as jax_models
from srcgan_tpu import weightspace as jax_ws
from srcgan_tpu.cli import blend as jax_blend
from srcgan_tpu.train.state import checkpoint_name, load_params as jax_load_params, save_params
from srcgan_tpu_torch import interop, models, weightspace
from srcgan_tpu_torch.cli import blend
from tests.torch_params import numpy_params


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Three ESPCN x2 epoch saves and an SRCNN colorizer, JAX .npz layout."""
    d = tmp_path_factory.mktemp("blend")
    sr = jax_models.create("ESPCN", 1, 1, 2)
    paths = []
    for epoch in (30, 40, 50):
        paths.append(str(d / checkpoint_name("ESPCN", "A2C", 2, epoch)))
        save_params(paths[-1], numpy_params(sr, epoch))
    other = str(d / checkpoint_name("SRCNN", "C2B", 2, 50))
    save_params(other, numpy_params(jax_models.create("SRCNN", 1, 3, 1), 1))
    return d, paths, other


def as_port(tree):
    model = models.create("ESPCN", 1, 1, 2)
    return interop.state_dict_from_jax(model, tree)


def assert_close(port_sd, jax_tree):
    want = as_port(jax_tree)
    assert sorted(port_sd) == sorted(want)
    for k in want:
        assert port_sd[k].dtype == torch.float32
        np.testing.assert_allclose(port_sd[k].numpy(), want[k].numpy(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("weights", [None, [1.0, 1.0, 2.0]], ids=["mean", "weighted"])
def test_blend_params_matches_jax(ckpts, weights):
    _, paths, _ = ckpts
    ours = [weightspace.load_checkpoint_params(p)[0] for p in paths]
    theirs = [jax_ws.load_checkpoint_params(p)[0] for p in paths]
    assert_close(weightspace.blend_params(ours, weights), jax_ws.blend_params(theirs, weights))


def test_interpolate_params_matches_jax(ckpts):
    _, paths, _ = ckpts
    (a, info), (b, _) = (weightspace.load_checkpoint_params(p) for p in paths[:2])
    ja, jb = (jax_ws.load_checkpoint_params(p)[0] for p in paths[:2])
    assert info["model"] == "ESPCN" and info["role"] == "A2C" and info["up"] == 2
    assert_close(weightspace.interpolate_params(a, b, 0.3), jax_ws.interpolate_params(ja, jb, 0.3))
    with pytest.raises(ValueError, match="alpha"):
        weightspace.interpolate_params(a, b, 1.5)


@pytest.mark.parametrize("mode", [["--alpha", "0.8"], ["--weights", "1", "3"]],
                         ids=["alpha", "weights"])
def test_cli_blend_output_loads_in_both_packages(ckpts, tmp_path, mode):
    _, paths, _ = ckpts
    ours = str(tmp_path / "port" / "ESPCN_A2C_x2_0050.npz")
    theirs = str(tmp_path / "jax" / "ESPCN_A2C_x2_0050.npz")
    os.makedirs(os.path.dirname(ours))
    os.makedirs(os.path.dirname(theirs))
    blend.main([*paths[:2], "--out", ours, *mode, "--device", "cpu"])
    jax_blend.main([*paths[:2], "--out", theirs, *mode])
    jax_tree, _ = jax_ws.load_checkpoint_params(ours)        # the JAX loader's template check
    want = jax_load_params(theirs)
    assert_close(as_port(jax_tree), want)
    model, _ = weightspace.load_checkpoint_model(ours)
    assert_close({k: p.detach() for k, p in model.named_parameters()}, want)


def test_blend_refusals(ckpts, tmp_path):
    d, paths, other = ckpts
    out = str(tmp_path / "ESPCN_A2C_x2_0001.npz")
    with pytest.raises(SystemExit, match="share the architecture"):
        blend.main([paths[0], other, "--out", out, "--device", "cpu"])
    with pytest.raises(SystemExit, match="exactly 2"):
        blend.main([*paths, "--out", out, "--alpha", "0.5", "--device", "cpu"])
    with pytest.raises(SystemExit, match="2 weights for 3"):
        blend.main([*paths, "--out", out, "--weights", "1", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        blend.main([*paths[:2], "--out", out, "--alpha", "0.5", "--weights", "1", "2"])
    with pytest.raises(SystemExit, match="already exists"):
        blend.main([*paths[:2], "--out", paths[2], "--device", "cpu"])
    assert not os.path.exists(out)


def test_blend_params_refuses_counters_and_shapes():
    a = {"w": torch.ones(2), "n": torch.tensor(3)}
    out = weightspace.blend_params([a, {"w": torch.zeros(2), "n": torch.tensor(3)}], [1, 3])
    assert torch.equal(out["w"], torch.full((2,), 0.25)) and int(out["n"]) == 3
    with pytest.raises(ValueError, match="counter"):
        weightspace.blend_params([a, {"w": torch.ones(2), "n": torch.tensor(4)}])
    with pytest.raises(ValueError, match="shape"):
        weightspace.blend_params([a, {"w": torch.ones(3), "n": torch.tensor(3)}])
    with pytest.raises(ValueError, match="SAME architecture"):
        weightspace.blend_params([a, {"w": torch.ones(2)}])
    with pytest.raises(ValueError, match="positive"):
        weightspace.blend_params([a, a], [0, 0])
