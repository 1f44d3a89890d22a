"""Importing the port loads neither jax nor the JAX package."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in (ROOT / "srcgan_tpu_torch").rglob("*.py") if "_build" not in p.parts)


def test_module_list_covers_the_slice():
    for name in ("srcgan_tpu_torch.serving", "srcgan_tpu_torch.interop",
                 "srcgan_tpu_torch.ops.kernels.tail_kernel",
                 "srcgan_tpu_torch.models.rddb", "srcgan_tpu_torch.train.state",
                 "srcgan_tpu_torch.ops.resize", "srcgan_tpu_torch.data",
                 "srcgan_tpu_torch.data.preprocess",
                 "srcgan_tpu_torch.ops.kernels.preprocess_kernel",
                 "srcgan_tpu_torch.losses", "srcgan_tpu_torch.models.espcn",
                 "srcgan_tpu_torch.train.optim", "srcgan_tpu_torch.train.cas",
                 "srcgan_tpu_torch.train.retention", "srcgan_tpu_torch.metrics",
                 "srcgan_tpu_torch.ops.kernels.ssim_kernel", "srcgan_tpu_torch.data.dataset",
                 "srcgan_tpu_torch.data.native", "srcgan_tpu_torch.utils",
                 "srcgan_tpu_torch.utils.vis", "srcgan_tpu_torch.utils.logging",
                 "srcgan_tpu_torch.utils.live", "srcgan_tpu_torch.cli",
                 "srcgan_tpu_torch.cli.test_cas", "srcgan_tpu_torch.cli.train_cas",
                 "srcgan_tpu_torch.cli.vis_cas", "srcgan_tpu_torch.quant",
                 "srcgan_tpu_torch.ops.kernels.rdb5_kernel",
                 "srcgan_tpu_torch.models.blocks", "srcgan_tpu_torch.ops.color",
                 "srcgan_tpu_torch.ops.kernels.probe_kernels", "srcgan_tpu_torch.probes",
                 "srcgan_tpu_torch.probes.common", "srcgan_tpu_torch.probes.matmul_probe",
                 "srcgan_tpu_torch.probes.mxu_probe", "srcgan_tpu_torch.probes.layout_probe3",
                 "srcgan_tpu_torch.probes.__main__", "srcgan_tpu_torch.probes.rdb5_ablate",
                 "srcgan_tpu_torch.probes.tail_ablate"):
        assert name in MODULES


@pytest.mark.parametrize("modules", [["srcgan_tpu_torch"], MODULES],
                         ids=["package", "every-module"])
def test_import_pulls_in_no_jax(modules):
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'srcgan_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_names_jax_in_an_import():
    """No module of the port, and not chip_smoke.py, has an import statement
    that names jax or the JAX package."""
    import re

    pattern = re.compile(r"^\s*(?:from|import)\s+(?:jax|srcgan_tpu)(?:\.|\s|$)", re.M)
    files = [p for p in (ROOT / "srcgan_tpu_torch").rglob("*.py") if "_build" not in p.parts]
    for path in files + [ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
