"""The readings behind the limits of ``correct``: the numbers the reference
compares, on many seeds of the sound program and on the control, in one
process (at 2^20 gates set-up takes a minute and a half). The benchmark's
own runs never run this.

    python plonkbench/readings.py --workload p16-prove --seconds 3 \
        --seeds 11,12,13 --control unblinded --control-seeds 21,22,23

Each seed gets its own witness pool and requests, a short window at the
cell's load that finishes at least the proofs a run judges, and the
reference's judgement of as many proofs as a run judges. The control is
one of ``harness.FAULTS`` planted under the timed path: ``unblinded`` (the
proof made without its blinding; it still verifies, and breaks the
configuration's zero-knowledge guarantee), ``unsplit`` (t split without
b10 and b11: only the check of t's pieces one by one sees it), ``stale`` (the first proof
returned for every request), ``altered`` (one bit of each proof flipped
where it is made). One JSON line per seed, then the summary: the largest
reading of the sound program and the smallest of the control, by number.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(root: str, workload: str, seconds: float, seeds: list, control: str | None, control_seeds: list,
             device: str = "cuda", out=None) -> dict:
    """Per seed the compared numbers of the program (and of the control);
    returns the summary."""
    from plonkbench.harness import Run, Session, is_correct
    from plonkbench.spec import Cell

    out = out or sys.stdout
    session = Session(Cell(root, workload), device)
    rows = {"program": [], "control": []}
    for side, fault, side_seeds in (("program", None, seeds), ("control", control, control_seeds)):
        for seed in side_seeds:
            traffic = session.traffic(seed)
            serve = session.serve_fn(traffic, fault)
            session.warm(traffic, serve)
            run = Run()
            records = session.window(traffic, serve, seconds, run)
            checks = session.judge(traffic, records)
            row = {"side": side, "fault": fault, "seed": seed, "proofs": run.proofs, "correct": is_correct(checks),
                   "checks": {k: v["value"] for k, v in checks.items()}}
            rows[side].append(row)
            print(json.dumps(row), file=out, flush=True)
    summary = {}
    for name in rows["program"][0]["checks"] if rows["program"] else []:
        summary[name] = {"program_max": max(r["checks"][name] for r in rows["program"]),
                         "control_min": min((r["checks"][name] for r in rows["control"]), default=None)}
    summary["program_all_correct"] = all(r["correct"] for r in rows["program"])
    summary["control_all_incorrect"] = all(not r["correct"] for r in rows["control"])
    print(json.dumps({"summary": summary}), file=out, flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default=None)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    parse = lambda s: [int(x) for x in s.split(",") if x]
    readings(ROOT, args.workload, args.seconds, parse(args.seeds), args.control, parse(args.control_seeds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
