"""Run a cell with the control in the program's place: the plain reference
with one guarantee broken (a verifier that skips the decider; a root never
decided; an MSM whose scalars lose their low 16 bits).  Its compared
numbers are the upper readings the limits are set below; the control has
to come out not correct.  Not part of a benchmark run:

    python3 perfbench/control.py --workload <cell> --seed <n> --calls <k> [--seconds <s>]
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

if __name__ == "__main__":
    for p in (HERE, os.path.dirname(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness.cli import run_cell

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, required=True, help="the calls a sound run makes")
    ap.add_argument("--seconds", type=float, default=60.0)
    a = ap.parse_args()
    result, checks = run_cell(a.workload, a.seed, a.seconds, False, time.perf_counter(),
                              control=True, max_calls=a.calls)
    print(json.dumps({"workload": a.workload, "seed": a.seed, "control": True,
                      "correct": result["correct"], "attempted": result["attempted"],
                      "checks": result["checks"]}))
