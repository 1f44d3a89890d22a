"""The port's small tools (``cli.profile``, ``cli.dashboard``) on the CPU, and
the card default of every entry point of the serving extras: each raises or
exits without a card unless it is given the CPU."""
import http.client
import json
import os

import pytest
import torch

from srcgan_tpu_torch import models
from srcgan_tpu_torch.cli import blend, dashboard, export, profile, serve
from srcgan_tpu_torch.deploy import load_exported
from srcgan_tpu_torch.interop import jax_tree_from_module
from srcgan_tpu_torch.serving import TiledPredictor
from srcgan_tpu_torch.train.state import checkpoint_name, save_params


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_profile_times_and_counts_the_step(tmp_path, capsys):
    trace = tmp_path / "trace"
    summary = profile.main(["--SRModel", "ESPCN", "--CModel", "SRCNN", "--batch-size", "1",
                            "--size", "16", "--steps", "3", "--warmup", "1", "--cost-analysis",
                            "--trace-dir", str(trace), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary
    assert summary["steps"] == 2 and summary["p50_s"] > 0 and summary["device"] == "cpu"
    assert summary["config"] == "ESPCN+SRCNN x2 bs=1 16^2 fp32"
    cost = summary["cost_analysis"]
    assert cost["flops"] > 0 and cost["bound_ms"] > 0 and cost["bound_by"] in ("bytes", "operations")
    # the bound is the larger of the two times at the card's peaks
    assert cost["bound_ms"] == pytest.approx(max(cost["flops"] / profile.PEAK_FLOPS["fp32"],
                                                 cost["bytes"] / profile.HBM_BYTES_PER_S) * 1e3)
    assert "fraction_of_bound" not in summary          # no device metric from a CPU run
    assert any(name.endswith(".pt.trace.json") for name in os.listdir(trace))


def test_dashboard_serves_the_run_directory(tmp_path, capsys, monkeypatch):
    (tmp_path / "losses.jsonl").write_text(json.dumps(
        {"epoch": 1, "iter": 2, "t": 0.0, "losses": {"loss_SR": 0.5}}) + "\n")
    seen = {}

    def sleep(_):
        line = capsys.readouterr().out
        seen["line"] = line
        port = int(line.rsplit(":", 1)[1].split("/")[0])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/losses.json")
        seen["losses"] = json.loads(conn.getresponse().read())
        conn.close()
        raise KeyboardInterrupt

    monkeypatch.setattr(dashboard.time, "sleep", sleep)
    dashboard.main(["--dir", str(tmp_path), "--port", "0", "--device", "cpu"])
    assert "(cpu)" in seen["line"] and seen["losses"][0]["losses"] == {"loss_SR": 0.5}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools_ck")
    out = []
    for net, name, role in ((models.ESPCN(1, 1, 2), "ESPCN", "A2C"),
                            (models.SRCNN(1, 3, 1), "SRCNN", "C2B")):
        out.append(str(d / checkpoint_name(name, role, 2, 1)))
        save_params(out[-1], jax_tree_from_module(net)[0])
    return tuple(out), d


@pytest.mark.parametrize("entry", ["serve", "export", "blend", "profile", "dashboard",
                                   "TiledPredictor", "load_exported"])
def test_entry_points_default_to_the_card(entry, ckpts, tmp_path, monkeypatch):
    """Without a card each refuses to carry on on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (ga, gb), d = ckpts
    calls = {
        "serve": lambda: serve.make_server(serve.build_parser().parse_args(
            ["--netGA", ga, "--netGB", gb, "--port", "0"])),
        "export": lambda: export.main(["--netGA", ga, "--netGB", gb,
                                       "--out", str(tmp_path / "a.pt2")]),
        "blend": lambda: blend.main([ga, ga, "--out", str(tmp_path / "ESPCN_A2C_x2_0002.npz")]),
        "profile": lambda: profile.main(["--SRModel", "ESPCN", "--CModel", "SRCNN"]),
        "dashboard": lambda: dashboard.main(["--dir", str(d), "--port", "0"]),
        "TiledPredictor": lambda: TiledPredictor(models.ESPCN(1, 1, 2), models.SRCNN(1, 3, 1), 2),
        "load_exported": lambda: load_exported(b""),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
    assert not os.path.exists(tmp_path / "a.pt2")
    assert not os.path.exists(tmp_path / "ESPCN_A2C_x2_0002.npz")
