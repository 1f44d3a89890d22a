"""The port's command-line tools on the CPU, against the JAX package's.

One 32^2 synthetic set and small models (ESPCN x2 + ResDeconv).  The same
name-encoded checkpoints go through both ``test_cas`` tools: the
Performs.csv means agree within PSNR 0.01 dB, SSIM 1e-4, MSE and AE rtol
1e-4 (fp32 on both sides; convolutions sum in different orders), and the
PNGs within 1 LSB (a value at a truncation boundary may fall either way).
``train_cas`` itself is in tests/test_torch_cli_train.py.
"""
import csv
import io
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from srcgan_tpu import models as jmodels
from srcgan_tpu.cli import test_cas as jax_test_cas
from srcgan_tpu.cli import vis_cas as jax_vis_cas
from srcgan_tpu.train.state import save_params as jax_save_params
from srcgan_tpu_torch import config, data, models
from srcgan_tpu_torch.cli import test_cas, train_cas, vis_cas
from srcgan_tpu_torch.data.dataset import _read_png
from srcgan_tpu_torch.serving import CascadePredictor
from srcgan_tpu_torch.train.cas import CasTrainer

COLUMNS = ["time", "checkpoint", "MSE", "PSNR", "AE", "SSIM"]


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


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """JAX-initialised ESPCN x2 + ResDeconv under name-encoded .npz names; the
    colorizer's last conv is scaled so the outputs span [0, 1]."""
    d = tmp_path_factory.mktemp("ckpt")
    sr, c = jmodels.ESPCN(1, 1, 2), jmodels.ResDeconv(1, 3)
    pa = jax.device_get(sr.init(jax.random.PRNGKey(0)))
    pb = jax.device_get(c.init(jax.random.PRNGKey(1)))
    pb = {**pb, "pred": {**pb["pred"], "w": pb["pred"]["w"] * 0.03}}
    net_a, net_b = str(d / "ESPCN_A2C_x2_0007.npz"), str(d / "ResDeconv_C2B_x2_0007.npz")
    jax_save_params(net_a, pa)
    jax_save_params(net_b, pb)
    return net_a, net_b


def eval_args(ckpts, synth, result, *extra):
    return ["--netGA", ckpts[0], "--netGB", ckpts[1], "--data-dir", synth,
            "--result-dir", str(result), *extra]


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def both_evals(jax_ckpts, synth, tmp_path_factory):
    """One run of each test_cas tool on the same checkpoints and set."""
    d = tmp_path_factory.mktemp("res")
    ours = test_cas.main(eval_args(jax_ckpts, synth, d / "port", "--batch-size", "2",
                                   "--device", "cpu"))
    theirs = jax_test_cas.main(eval_args(jax_ckpts, synth, d / "jax", "--batch-size", "2"))
    return d, ours, theirs.iloc[-1]


def test_performs_rows_agree(both_evals):
    d, ours, theirs = both_evals
    assert ours["images"] == 3 and ours["batches"] == 2 and ours["device"] == "cpu"
    assert abs(ours["PSNR"] - float(theirs["PSNR"])) <= 0.01
    assert abs(ours["SSIM"] - float(theirs["SSIM"])) <= 1e-4
    np.testing.assert_allclose(ours["MSE"], float(theirs["MSE"]), rtol=1e-4)
    np.testing.assert_allclose(ours["AE"], float(theirs["AE"]), rtol=1e-4)
    assert ours["checkpoint"] == theirs["checkpoint"] == "ESPCN_A2C_x2_0007"
    assert 0 < ours["PSNR"] < 40 and 0 < abs(ours["SSIM"]) < 1   # unsaturated outputs
    port_rows, jax_rows = read_csv(d / "port" / "Performs.csv"), read_csv(d / "jax" / "Performs.csv")
    assert list(port_rows[0]) == list(jax_rows[0]) == COLUMNS
    for k in COLUMNS[2:]:
        assert abs(float(port_rows[0][k]) - float(jax_rows[0][k])) <= 0.0011, k


@pytest.mark.parametrize("side", ["A", "B"])
def test_pngs_agree_within_one_lsb(both_evals, side):
    d, _, _ = both_evals
    sub = f"{side}_ESPCN_x2_0007"
    names = sorted(os.listdir(d / "jax" / sub))
    assert sorted(os.listdir(d / "port" / sub)) == names == [f"test-{i}.png" for i in range(3)]
    for name in names:
        a = _read_png(str(d / "port" / sub / name)).astype(int)
        b = _read_png(str(d / "jax" / sub / name)).astype(int)
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(a - b).max() <= 1 and (a != b).mean() < 0.02
        assert len(np.unique(a)) > 8                             # not a saturated image


def test_performs_csv_is_byte_equal_to_pandas(tmp_path):
    """Header, float format, an appended row, NaN and a quoted cell: the file
    is the one pandas' to_csv(index=False, float_format='%.3f') writes."""
    rows = [{"time": "Oct_16", "checkpoint": "RDDBNet_A2C_x2_0050", "MSE": 0.00123456,
             "PSNR": 29.0854999, "AE": 3.0005, "SSIM": 0.91},
            {"time": "Oct_17", "checkpoint": "ESPCN, v2", "MSE": 12.5, "PSNR": -10.9996,
             "AE": float("nan"), "SSIM": 1.0}]
    path = tmp_path / "Performs.csv"
    for i, row in enumerate(rows):
        test_cas.append_performs(str(path), row)
        want = io.StringIO()
        pd.DataFrame(rows[:i + 1], columns=COLUMNS).to_csv(want, index=False,
                                                           float_format="%.3f")
        assert path.read_text() == want.getvalue()
    assert path.read_text().splitlines()[0] == "time,checkpoint,MSE,PSNR,AE,SSIM"
    back = pd.read_csv(path)
    assert len(back) == 2 and back["PSNR"].iloc[0] == 29.085


def test_appends_under_a_file_the_jax_tool_wrote(both_evals, jax_ckpts, synth):
    d, _, _ = both_evals
    before = (d / "jax" / "Performs.csv").read_text()
    test_cas.main(eval_args(jax_ckpts, synth, d / "jax", "--device", "cpu"))
    after = (d / "jax" / "Performs.csv").read_text()
    assert after.startswith(before) and len(after.splitlines()) == 3
    assert len(pd.read_csv(d / "jax" / "Performs.csv")) == 2


@pytest.mark.parametrize("row", [
    {"time": "Oct_16", "checkpoint": "RDDBNet_A2C_x2_0001", "MSE": 52.435238,
     "PSNR": -17.196069, "AE": 83.796787, "SSIM": 0.000044},
    {"time": "Jan_02", "checkpoint": "ESPCN_A2C_x4_0050", "MSE": 0.00251, "PSNR": 26.0035,
     "AE": 4.125, "SSIM": 0.8765432109},
])
def test_stdout_row_is_what_pandas_prints(row):
    """For values wider than their column's name, as six-decimal metrics are."""
    want = pd.DataFrame([row], columns=COLUMNS).tail(1).to_string(index=False)
    assert test_cas.format_row(row) == want


def test_batch_size_does_not_change_the_means(jax_ckpts, synth, tmp_path):
    """Per-sample scoring: batch 1 (the protocol) and batch 3 give one row."""
    one = test_cas.main(eval_args(jax_ckpts, synth, tmp_path / "b1", "--device", "cpu"))
    three = test_cas.main(eval_args(jax_ckpts, synth, tmp_path / "b3", "--batch-size", "3",
                                    "--device", "cpu", "--precision", "high"))
    for k in COLUMNS[2:]:
        np.testing.assert_allclose(one[k], three[k], rtol=1e-5, err_msg=k)


def test_bf16_eval_runs(jax_ckpts, synth, tmp_path):
    bf16 = test_cas.main(eval_args(jax_ckpts, synth, tmp_path / "h", "--precision", "default",
                                   "--device", "cpu"))
    fp32 = test_cas.main(eval_args(jax_ckpts, synth, tmp_path / "f", "--device", "cpu"))
    assert abs(bf16["PSNR"] - fp32["PSNR"]) < 1.0 and bf16["PSNR"] != fp32["PSNR"]


def test_vis_cas_matches_jax(jax_ckpts, synth, tmp_path):
    assert vis_cas.main(eval_args(jax_ckpts, synth, tmp_path / "port", "--threshold", "100",
                                  "--device", "cpu")) == 0
    assert vis_cas.main(eval_args(jax_ckpts, synth, tmp_path / "port", "--threshold", "-100",
                                  "--device", "cpu")) == 3
    assert jax_vis_cas.main(eval_args(jax_ckpts, synth, tmp_path / "jax", "--threshold",
                                      "-100")) == 3
    for name in ("test-0.png", "test-2.png"):
        a = _read_png(str(tmp_path / "port" / "vis_ESPCN_x2_0007" / name)).astype(int)
        b = _read_png(str(tmp_path / "jax" / "vis_ESPCN_x2_0007" / name)).astype(int)
        assert a.shape == b.shape == (256 + 4, 4 * (256 + 4), 3)
        assert np.abs(a - b).max() <= 1


# The space axis is still to be ported; the flags of the data axis, the
# perceptual term and distillation run in tests/test_torch_parallel_cli.py and
# tests/test_torch_distill.py.
UNPORTED_TRAIN = [(["--space-size", "2"], "A14"), (["--mesh-size", "2", "--space-size", "2"], "A14")]


@pytest.mark.parametrize("flags,item", UNPORTED_TRAIN, ids=[f[0][0] + f"-{i}" for i, f in
                                                            enumerate(UNPORTED_TRAIN)])
def test_unported_train_flags_exit_naming_the_roadmap(flags, item, tmp_path):
    with pytest.raises(SystemExit) as e:
        train_cas.main(["--data-dir", str(tmp_path / "none"), "--device", "cpu", *flags])
    assert f"ROADMAP {item}" in str(e.value)
    assert not (tmp_path / "none").exists()


def test_int8_eval_matches_jax(jax_ckpts, synth, tmp_path, capsys):
    """--precision int8: calibrated on the first two eval batches through the
    both-domain cascade, fp32 between the convolutions.  Both tools count the
    same callsites and write a row; the rows agree within the int8 noise of
    two frameworks (0.5 dB PSNR, 0.02 SSIM) and stay near the fp32 row."""
    ours = test_cas.main(eval_args(jax_ckpts, synth, tmp_path / "port", "--batch-size", "2",
                                   "--precision", "int8", "--device", "cpu"))
    port_out = capsys.readouterr().out
    theirs = jax_test_cas.main(eval_args(jax_ckpts, synth, tmp_path / "jax", "--batch-size", "2",
                                         "--precision", "int8")).iloc[-1]
    jax_out = capsys.readouterr().out
    count = [line for line in port_out.splitlines() if line.startswith("int8: calibrated")]
    assert len(count) == 1 and count[0] in jax_out.splitlines()
    assert int(count[0].split()[2]) > 0
    rows = read_csv(tmp_path / "port" / "Performs.csv")
    assert len(rows) == 1 and list(rows[0]) == COLUMNS
    assert ours["images"] == 3 and sorted(os.listdir(tmp_path / "port" / "B_ESPCN_x2_0007")) == [
        f"test-{i}.png" for i in range(3)]
    assert abs(ours["PSNR"] - float(theirs["PSNR"])) <= 0.5
    assert abs(ours["SSIM"] - float(theirs["SSIM"])) <= 0.02
    fp32 = test_cas.main(eval_args(jax_ckpts, synth, tmp_path / "fp32", "--batch-size", "2",
                                   "--device", "cpu"))
    assert 0 < abs(ours["PSNR"] - fp32["PSNR"]) < 1.0


@pytest.mark.parametrize("flags,item", [(["--mesh-size", "2"], "A14")])
def test_unported_eval_flags_exit_naming_the_roadmap(flags, item, jax_ckpts, synth, tmp_path,
                                                      capfd):
    """--mesh-size (the last eval flag of A14, now ported): two gloo ranks,
    the batch of 3 raised to 4 and padded; rank 0 writes the Performs.csv row
    and the PNGs of one process, the row within 1e-5 relative.  (``item``
    names the ROADMAP item that brought the flag.)"""
    one = test_cas.main(eval_args(jax_ckpts, synth, tmp_path / "one", "--batch-size", "3",
                                  "--device", "cpu"))
    got = test_cas.main(eval_args(jax_ckpts, synth, tmp_path / "mesh", "--batch-size", "3",
                                  "--device", "cpu", *flags))
    assert "raising --batch-size 3 -> 4" in capfd.readouterr().out
    assert got["images"] == one["images"] == 3 and got["batches"] == 1
    for k in ("MSE", "PSNR", "AE", "SSIM"):
        assert abs(got[k] - one[k]) <= 1e-5 * max(abs(one[k]), 1e-3), k
    rows = [read_csv(tmp_path / d / "Performs.csv") for d in ("one", "mesh")]
    assert len(rows[1]) == 1 and rows[0][0]["MSE"] == rows[1][0]["MSE"]
    for side in "AB":
        names = sorted(os.listdir(tmp_path / "one" / f"{side}_ESPCN_x2_0007"))
        assert names == sorted(os.listdir(tmp_path / "mesh" / f"{side}_ESPCN_x2_0007"))
        for n in names:
            a = _read_png(str(tmp_path / "one" / f"{side}_ESPCN_x2_0007" / n)).astype(int)
            b = _read_png(str(tmp_path / "mesh" / f"{side}_ESPCN_x2_0007" / n)).astype(int)
            assert np.abs(a - b).max() <= 1


def test_self_ensemble_eval_matches_jax(jax_ckpts, synth, tmp_path):
    """--self-ensemble: both domains' (SR, colorized) pairs are the x8
    dihedral self-ensemble.  The Performs.csv rows agree within the plain
    eval's bounds (test_performs_rows_agree) and differ from the plain row."""
    ours = test_cas.main(eval_args(jax_ckpts, synth, tmp_path / "port", "--batch-size", "2",
                                   "--self-ensemble", "--device", "cpu"))
    theirs = jax_test_cas.main(eval_args(jax_ckpts, synth, tmp_path / "jax", "--batch-size", "2",
                                         "--self-ensemble")).iloc[-1]
    assert abs(ours["PSNR"] - float(theirs["PSNR"])) <= 0.01
    assert abs(ours["SSIM"] - float(theirs["SSIM"])) <= 1e-4
    np.testing.assert_allclose(ours["MSE"], float(theirs["MSE"]), rtol=1e-4)
    np.testing.assert_allclose(ours["AE"], float(theirs["AE"]), rtol=1e-4)
    port_rows = read_csv(tmp_path / "port" / "Performs.csv")
    jax_rows = read_csv(tmp_path / "jax" / "Performs.csv")
    assert len(port_rows) == len(jax_rows) == 1 and list(port_rows[0]) == COLUMNS
    for k in COLUMNS[2:]:
        assert abs(float(port_rows[0][k]) - float(jax_rows[0][k])) <= 0.0011, k
    plain = test_cas.main(eval_args(jax_ckpts, synth, tmp_path / "plain", "--batch-size", "2",
                                    "--device", "cpu"))
    assert ours["PSNR"] != plain["PSNR"]


@pytest.mark.parametrize("cli", [test_cas, vis_cas])
def test_lab_checkpoints_exit_naming_the_roadmap(cli, tmp_path):
    """LAB is ported: @G2LAB names no longer exit naming a ROADMAP item; with
    no such files the tool gets as far as loading them."""
    args = ["--netGA", str(tmp_path / "RDDBNet@G2LAB_A2C_x2_0050.npz"),
            "--netGB", str(tmp_path / "ResDeconv@G2LAB_C2B_x2_0050.npz"),
            "--result-dir", str(tmp_path / "r"), "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match="G2LAB"):
        cli.main(args)


def test_flag_names_are_the_jax_tools():
    """Every option of the JAX parsers exists in the port's (docs/MIGRATION.md
    holds); the port adds --device alone."""
    from srcgan_tpu.cli import train_cas as jax_train_cas

    def options(parser):
        return {s for a in parser._actions for s in a.option_strings}

    for ours, theirs in ((train_cas, jax_train_cas), (test_cas, jax_test_cas),
                         (vis_cas, jax_vis_cas)):
        assert options(ours.build_parser()) - options(theirs.build_parser()) == {"--device"}
        assert options(theirs.build_parser()) <= options(ours.build_parser())
        assert ours.build_parser().get_default("device") == "cuda"
    for flag in ("lr", "num_epochs", "batch_size", "save_every", "SRModel", "workers"):
        assert (train_cas.build_parser().get_default(flag)
                == jax_train_cas.build_parser().get_default(flag))
    assert "3-pass" in test_cas.build_parser().format_help()


# ---------------------------------------------------------------------------
# The device default: the card, or a clear error
# ---------------------------------------------------------------------------

def entry_points(jax_ckpts, synth, tmp_path):
    return {
        "CasTrainer": lambda **kw: CasTrainer("ESPCN", "ResDeconv", **kw),
        "CascadePredictor": lambda **kw: CascadePredictor(
            models.ESPCN(1, 1, 2), models.ResDeconv(1, 3), 2, **kw),
        "from_checkpoints": lambda **kw: CascadePredictor.from_checkpoints(*jax_ckpts, **kw),
        "train_cas": lambda **kw: train_cas.main(
            ["--data-dir", synth, "--checkpoints", str(tmp_path / "c"), "--run-dir",
             str(tmp_path / "r"), "--num-epochs", "1"] + (["--device", kw["device"]] if kw else [])),
        "test_cas": lambda **kw: test_cas.main(eval_args(
            jax_ckpts, synth, tmp_path / "t", *(["--device", kw["device"]] if kw else []))),
        "vis_cas": lambda **kw: vis_cas.main(eval_args(
            jax_ckpts, synth, tmp_path / "v", *(["--device", kw["device"]] if kw else []))),
    }


@pytest.mark.parametrize("name", ["CasTrainer", "CascadePredictor", "from_checkpoints",
                                  "train_cas", "test_cas", "vis_cas"])
def test_default_device_is_the_card_and_raises_without_one(name, jax_ckpts, synth, tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    entry = entry_points(jax_ckpts, synth, tmp_path)[name]
    with pytest.raises(RuntimeError, match=r'device="cpu".*--device cpu'):
        entry()
    assert not (tmp_path / "c").exists() and not (tmp_path / "t").exists()
    built = entry(device="cpu")                                   # the way out it names
    if name in ("CasTrainer", "CascadePredictor", "from_checkpoints"):
        assert built.device == torch.device("cpu")


def test_resolve_device():
    assert config.resolve_device("cpu") == torch.device("cpu")
    assert config.resolve_device(torch.device("cpu")).type == "cpu"
    if not torch.cuda.is_available():
        for asked in (None, "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                config.resolve_device(asked)


# -- @G2LAB checkpoints: L from the SR net, ab from a 2-channel colorizer -----

def lab_ckpts(d, sr_name, up, seed):
    """JAX-initialised <sr_name> x<up> + 2-channel ResDeconv under @G2LAB names."""
    sr, c = getattr(jmodels, sr_name)(1, 1, up), jmodels.ResDeconv(1, 2)
    pa = jax.device_get(sr.init(jax.random.PRNGKey(seed)))
    pb = jax.device_get(c.init(jax.random.PRNGKey(seed + 1)))
    pb = {**pb, "pred": {**pb["pred"], "w": pb["pred"]["w"] * 0.03}}
    net_a = str(d / f"{sr_name}@G2LAB_A2C_x{up}_0007.npz")
    net_b = str(d / f"ResDeconv@G2LAB_C2B_x{up}_0007.npz")
    jax_save_params(net_a, pa)
    jax_save_params(net_b, pb)
    return net_a, net_b


@pytest.mark.parametrize("up,const", [(2, False), (4, False), (8, False),
                                      (2, True), (4, True), (8, True)])
def test_lab_performs_rows_equal_jax(synth, tmp_path, up, const):
    """The evaluation sweep's shape on @G2LAB pairs: every scale, with and
    without --const (SRCNN keeps the size there).  The metrics compare L (+) ab
    with the normalized-LAB target; Performs.csv equals the JAX tool's to the
    printed digits (%.3f), the means within PSNR 0.01 dB and SSIM 1e-4, and the
    PNGs (L (+) ab converted to RGB) within 1 LSB."""
    ckpts = lab_ckpts(tmp_path, "SRCNN" if const else "ESPCN", up, 10 * up + const)
    extra = ["--batch-size", "2"] + (["--const"] if const else [])
    ours = test_cas.main(eval_args(ckpts, synth, tmp_path / "port", "--device", "cpu", *extra))
    theirs = jax_test_cas.main(eval_args(ckpts, synth, tmp_path / "jax", *extra)).iloc[-1]
    assert ours["images"] == 3 and ours["checkpoint"] == theirs["checkpoint"]
    assert "@G2LAB" in ours["checkpoint"]
    assert abs(ours["PSNR"] - float(theirs["PSNR"])) <= 0.01
    assert abs(ours["SSIM"] - float(theirs["SSIM"])) <= 1e-4
    port_rows = read_csv(tmp_path / "port" / "Performs.csv")
    jax_rows = read_csv(tmp_path / "jax" / "Performs.csv")
    assert list(port_rows[0]) == list(jax_rows[0]) == COLUMNS
    assert [port_rows[0][k] for k in COLUMNS[1:]] == [jax_rows[0][k] for k in COLUMNS[1:]]
    tag = os.path.basename(ckpts[0]).split("@")[0] + f"_x{up}_0007"
    for side in "AB":
        for name in (f"test-{i}.png" for i in range(3)):
            a = _read_png(str(tmp_path / "port" / f"{side}_{tag}" / name)).astype(int)
            b = _read_png(str(tmp_path / "jax" / f"{side}_{tag}" / name)).astype(int)
            assert a.shape == b.shape == (32, 32, 3) and np.abs(a - b).max() <= 1


def test_lab_vis_cas_panels_agree(synth, tmp_path):
    """vis_cas on a @G2LAB pair: the colorized and target panels go through
    LAB -> RGB; panels within 1 LSB of the JAX tool's."""
    ckpts = lab_ckpts(tmp_path, "ESPCN", 2, 3)
    assert vis_cas.main(eval_args(ckpts, synth, tmp_path / "port", "--threshold", "-100",
                                  "--device", "cpu")) == 3
    assert jax_vis_cas.main(eval_args(ckpts, synth, tmp_path / "jax", "--threshold",
                                      "-100")) == 3
    for name in ("test-0.png", "test-2.png"):
        a = _read_png(str(tmp_path / "port" / "vis_ESPCN_x2_0007" / name)).astype(int)
        b = _read_png(str(tmp_path / "jax" / "vis_ESPCN_x2_0007" / name)).astype(int)
        assert a.shape == b.shape == (256 + 4, 4 * (256 + 4), 3)
        assert np.abs(a - b).max() <= 1
