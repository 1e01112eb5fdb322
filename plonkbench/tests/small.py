"""A copy of the benchmark's files with one small cell, for CPU tests:
the 8-gate multiply chain, under every metric but the tail."""
import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def small_root(tmp_path, gates: int = 8) -> str:
    root = os.path.join(str(tmp_path), "checkout")
    shutil.copytree(os.path.join(ROOT, "plonkbench"), os.path.join(root, "plonkbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    config = json.load(open(os.path.join(ROOT, "plonkbench", "configs", "plonk16-mulchain-fb.json")))
    config.update(name="small", circuit={"family": "mul_chain", "gates": gates}, group_order=gates,
                  srs={"powers": gates + 6, "tau": "0xDEADBEEF"})
    with open(os.path.join(root, "plonkbench", "configs", "small.json"), "w") as f:
        json.dump(config, f)
    bench["configs"].append({"name": "small", "source": "https://github.com/ChainUpZero/baby-plonk-rust",
                             "file": "plonkbench/configs/small.json", "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": "small-prove", "config": "small", "traffic": "closed1-pool4", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and m["name"] != "prove_p90_s":  # a tail needs 100 proofs, not a CPU test's few
            m["workloads"].append("small-prove")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=2)
    return root
