"""CPU test of the per-layer metrics that read the port's own recorder
(``baby_plonk_tpu_torch/utils/metrics.py``): the small cell's traced run
reports each of them, and round 1's parts fit inside round 1.

    python -m pytest -q plonkbench/tests/test_plonkbench_port_spans.py
"""
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from plonkbench.tests.small import small_root  # noqa: E402

PORT_METRICS = ("h2d_bytes_per_prove", "syncs_per_prove", "round1_columns_ms", "round1_pack_ms", "prepare_ms",
                "transcript_ms")


def test_the_traced_run_reports_the_ports_spans_and_counters(tmp_path):
    import torch

    from plonkbench.harness import run_cell

    torch.set_num_threads(1)
    out = io.StringIO()
    assert run_cell(small_root(tmp_path), "small-prove", 2**41 + 17, 0.1, True, device="cpu", out=out) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    values = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["correct"] is True
    assert all(values.get(k, 0) > 0 for k in PORT_METRICS), values
    assert values["round1_columns_ms"] + values["round1_pack_ms"] <= values["round1_ms"]
    # 8 gates: at least round 1's columns and the public input, 64 bytes a value
    assert values["h2d_bytes_per_prove"] >= 4 * 8 * 64 and values["h2d_bytes_per_prove"] % 8 == 0
