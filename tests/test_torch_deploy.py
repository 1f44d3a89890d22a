"""``torch.export`` deployment artifacts (``deploy`` + ``cli.export``) on the CPU.

The artifact is the predictor's own program traced with the kernels scoped
off, so on the CPU (where the kernels' plain versions run anyway) it is
bit-equal to ``predict``; against the JAX predictor on the same weights it
is within 1 LSB (fp32 convolutions sum in other orders).  An x4 RDDBNet
cascade exports too: its folded tail weights and the per-device constants
are built in the traced graph and the predictor's caches keep real tensors.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from srcgan_tpu import models as jax_models
from srcgan_tpu import serving as jax_serving
from srcgan_tpu.train.state import checkpoint_name, save_params
from srcgan_tpu_torch import interop, models
from srcgan_tpu_torch.cli import export as cli_export
from srcgan_tpu_torch.deploy import export_cascade, load_exported
from srcgan_tpu_torch.serving import CascadePredictor
from tests.torch_params import numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture(scope="module")
def weights():
    sr, c = jax_models.create("ESPCN", 1, 1, 2), jax_models.create("SRCNN", 1, 3, 1)
    return sr, numpy_params(sr, 0), c, numpy_params(c, 1)


def port_pred(weights, **kw):
    _, pa, _, pb = weights
    psr, pc = models.create("ESPCN", 1, 1, 2), models.create("SRCNN", 1, 3, 1)
    psr.load_state_dict(interop.state_dict_from_jax(psr, pa), strict=True)
    pc.load_state_dict(interop.state_dict_from_jax(pc, pb), strict=True)
    return CascadePredictor(psr, pc, 2, device="cpu", **kw)


@pytest.fixture(scope="module")
def pred(weights):
    return port_pred(weights)


@pytest.fixture(scope="module")
def symbolic(pred):
    """One artifact with a symbolic batch, loaded on the CPU."""
    return load_exported(export_cascade(pred, h=16, w=16), device="cpu")


def test_roundtrip_is_bit_equal_to_the_predictor(pred):
    blob = export_cascade(pred, h=16, w=16, batch=2, platforms=("cpu",))
    assert isinstance(blob, bytes) and len(blob) > 1000
    run = load_exported(blob, device="cpu")
    x = u8(0, (2, 16, 16, 1))
    got = run(x)
    assert got.dtype == np.uint8 and got.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(got, pred.predict(x))


def test_symbolic_batch_serves_any_size(pred, symbolic):
    for n in (1, 3, 5):
        x = u8(n, (n, 16, 16, 1))
        got = symbolic(x)
        assert got.shape == (n, 32, 32, 3)
        np.testing.assert_array_equal(got, pred.predict(x))


def test_artifact_matches_jax(weights, symbolic):
    sr, pa, c, pb = weights
    x = u8(7, (3, 16, 16, 1))
    want = jax_serving.CascadePredictor(sr, pa, c, pb, up=2).predict(x)
    got = symbolic(x)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_rddbnet_x4_cascade_exports_and_keeps_its_caches_real():
    """The x4 tail folds conv_last in the trace (no data_ptr of a traced
    tensor), and an RGB input's luma constant is made in the graph: after the
    export the predictor itself still runs, with real cached tensors."""
    pred = CascadePredictor(models.RDDBNet(1, 1, 4, nf=16, nb=1), models.SRCNN(1, 3, 1), 4,
                            device="cpu")
    x = u8(9, (2, 8, 8, 3))
    before = pred.predict(x)
    assert pred.sr_model._prepared[0] is not None
    key = pred.sr_model._prepared[0]
    run = load_exported(export_cascade(pred, h=8, w=8, c=3), device="cpu")
    assert pred.sr_model._prepared[0] == key            # the trace cached nothing
    np.testing.assert_array_equal(run(x), before)
    np.testing.assert_array_equal(pred.predict(x), before)


def test_load_checks_the_platforms(pred):
    blob = export_cascade(pred, h=16, w=16, batch=1, platforms=("cuda",))
    with pytest.raises(ValueError, match="made for"):
        load_exported(blob, device="cpu")
    with pytest.raises(ValueError, match="cuda / cpu"):
        export_cascade(pred, h=16, w=16, platforms=("tpu",))


def test_export_rejects_int8_predictor(weights):
    with pytest.raises(NotImplementedError, match="int8"):
        export_cascade(port_pred(weights, int8=True), h=16, w=16, batch=1)


def test_cli_export_runs_without_the_package(tmp_path):
    """cli.export writes an artifact that torch.export.load runs in a fresh
    process where srcgan_tpu_torch is never imported."""
    sr, c = jax_models.ESPCN(1, 1, 2), jax_models.create("SRCNN", 1, 3, 1)
    ga = str(tmp_path / checkpoint_name("ESPCN", "A2C", 2, 3))
    gb = str(tmp_path / checkpoint_name("SRCNN", "C2B", 2, 3))
    save_params(ga, numpy_params(sr, 3))
    save_params(gb, numpy_params(c, 4))
    out = str(tmp_path / "cascade.pt2")
    cli_export.main(["--netGA", ga, "--netGB", gb, "--out", out, "--size", "16x16",
                     "--platforms", "cpu", "--device", "cpu"])
    x = u8(11, (3, 16, 16, 1))
    np.save(tmp_path / "x.npy", x)
    script = (
        "import sys, numpy as np, torch\n"
        f"program = torch.export.load({out!r})\n"
        f"y = program.module()(torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r})))\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, y.numpy())\n"
        "assert not any(m.startswith('srcgan_tpu') for m in sys.modules), 'imported'\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", script], check=True, timeout=120, cwd=str(tmp_path),
                   env={**env, "OMP_NUM_THREADS": "1"})
    want = CascadePredictor.from_checkpoints(ga, gb, device="cpu").predict(x)
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want)
    with pytest.raises(SystemExit, match="no TPU target"):
        cli_export.main(["--netGA", ga, "--netGB", gb, "--out", out, "--platforms", "tpu,cpu",
                         "--device", "cpu"])
