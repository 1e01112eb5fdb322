"""The port's CLI: ``demo`` and ``warmup`` prove and verify on the CPU when
asked to, and raise without a card when not."""
import os
import subprocess
import sys

import pytest
import torch

from baby_plonk_tpu_torch import __main__ as cli

from torch_port_util import one_torch_thread  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_demo_cpu_subprocess():
    out = subprocess.run(
        [sys.executable, "-m", "baby_plonk_tpu_torch", "demo", "--cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ok=True" in out.stdout and "device=cpu" in out.stdout
    assert "proof: 624 bytes" in out.stdout


def test_warmup_cpu_small(capsys):
    assert cli.main(["warmup", "--log2", "3", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "warmup n=2^3 device=cpu" in out and "ok=True" in out
    assert "warmup.srs=" in out and "warmup.prove=" in out


@pytest.mark.parametrize("argv", [["demo"], ["warmup", "--log2", "3"]], ids=["demo", "warmup"])
def test_without_cpu_flag_needs_a_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        cli.main(argv)
