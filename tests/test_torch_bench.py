"""The port's bench (``python -m baby_plonk_tpu_torch bench``) on the CPU:
nothing is timed here. The function that assembles its line, fed made-up
timings, gives every key with the JAX bench's names and meanings; without a
card the entry point exits non-zero and prints no line."""
import json
import os
import subprocess
import sys

import pytest
import torch

from baby_plonk_tpu_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the keys of the JAX bench's line (bench.py at the repo root) that the
#: port's line carries with the same meaning; ``sched_pct`` has no counterpart
JAX_KEYS = ("metric", "value", "unit", "vs_baseline", "roofline_pct", "ntt_coeffs_per_s", "ntt_log2",
            "prove_warm_s", "prove_log2", "verify_s", "verifier_preprocess_s")
PORT_KEYS = ("msm_log2", "prove_warm_range_s", "prove_cold_s", "plan_s", "tables_build_s", "srs_device_s",
             "srs_load_s", "srs_bytes", "round_ms", "peak_mem_bytes", "device_busy_share", "build_s", "device")

TIMINGS = dict(
    device="NVIDIA H100 80GB HBM3, 700.00 W", build_s=9.5, msm_log2=14, msm_s=0.004, msm_bound_s=0.001,
    host_log2=10, host_s=0.5, ntt_log2=20, ntt_s=0.002, srs_device_s=0.05, srs_load_s=0.01,
    srs_bytes=4_719_000, prove_log2=16, plan_s=1.1, tables_build_s=0.08, prove_cold_s=1.9,
    prove_warm_s=[0.5, 0.3, 0.4], round_ms={"prover.round_1": 200.0}, peak_mem_bytes=13_000_000_000,
    verifier_preprocess_s=0.1,
    verify_s=0.02, device_ms=30.0,
)


def test_metric_line_keys_and_values():
    line = bench.metric_line(**TIMINGS)
    assert set(JAX_KEYS + PORT_KEYS) <= set(line)
    assert (line["metric"], line["unit"]) == ("msm_g1_points_per_s", "points/s")
    assert line["value"] == pytest.approx((1 << 14) / 0.004)
    assert line["vs_baseline"] == pytest.approx(line["value"] / ((1 << 10) / 0.5))
    assert line["roofline_pct"] == pytest.approx(25.0)
    assert line["ntt_coeffs_per_s"] == pytest.approx((1 << 20) / 0.002) and line["ntt_log2"] == 20
    assert line["prove_warm_s"] == 0.4 and line["prove_warm_range_s"] == [0.3, 0.5]
    assert line["device_busy_share"] == pytest.approx(0.030 / 0.4)
    for k in ("prove_log2", "verify_s", "verifier_preprocess_s", "msm_log2", "prove_cold_s", "plan_s",
              "tables_build_s", "srs_device_s", "srs_load_s", "srs_bytes", "round_ms", "peak_mem_bytes", "build_s",
              "device"):
        assert line[k] == TIMINGS[k], k
    assert "msm_variable_points_per_s" not in line
    assert json.loads(json.dumps(line)) == line


def test_metric_line_variable_base():
    line = bench.metric_line(**TIMINGS, variable=("pippenger", 0.016))
    assert line["msm_variable_points_per_s"] == pytest.approx((1 << 14) / 0.016)
    assert line["msm_variable_algorithm"] == "pippenger"


def test_without_a_card_exits_non_zero_and_prints_no_line():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "-m", "baby_plonk_tpu_torch", "bench"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    assert "no CUDA device" in res.stderr
