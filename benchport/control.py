"""The check's control at a cell's own size: the reference in bfloat16
put in the program's place, on several seeds in one process.

    python benchport/control.py --workload star-team --seeds 11,12,13

For each seed it makes the cell's data, draws the check's sample from
the first ``REQUESTS`` requests of each client's window stream as a run
does, and counts the calls
whose control count differs from the exact reference's.  The check's
limit on wrong counts is 0, so every seed has to read above it.  Prints
one JSON line a seed.  Needs no program: nothing of it is imported.
"""

import json
import os
import sys
import time

REQUESTS = 100
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse

    import torch

    from benchport.harness import Bench, Request, judge, sample
    from benchport.traffic_gen import shape

    p = argparse.ArgumentParser(description="the check's control at a cell's size")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = p.parse_args(argv)
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    mix = bench.data("traffic", cell["traffic"])
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        traffic = shape(mix, cfg, seed, ROOT)
        reqs = []
        for c in range(int(mix["clients"])):
            for i in range(REQUESTS):
                r = Request(c, i, 0.0, 0.0, [])
                r.calls = traffic.request("window", c, i)
                reqs.append(r)
        checked = sample(reqs, seed, int(mix["check_requests"]))
        wrong, compared = judge(cfg, seed, checked, device, control=True, root=ROOT)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "bfloat16 counts",
                          "wrong_counts": wrong, "compared": compared, "limit": 0,
                          "seconds": round(time.perf_counter() - t0, 3)}), flush=True)
        if device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
