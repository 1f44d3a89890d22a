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
                 "srcgan_tpu_torch.models.rddb", "srcgan_tpu_torch.train.state"):
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
