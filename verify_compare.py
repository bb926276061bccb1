#!/usr/bin/env python3
"""Time the verify paths end to end in this checkout and another, on one
card, in the order other, this, this, other.

    python3 verify_compare.py --parent DIR [--runs 7] [--out FILE]

`DIR` is the root of the other checkout (for example one unpacked with
`git archive <commit>`).  The two packages share a name, so each checkout
runs in a process of its own, started in its root.  A process builds its
checkout's kernels, then for each of chip_smoke.py's two verify batches of
1,024 -- `batch_verify` over the 16 committed vanilla-PLONK k = 10 `snark`
fixtures tiled (Poseidon transcript), and over the 16 `evmsnark` fixtures
with the keccak transcript -- verifies once (every lane must accept; this
first batch records the plan), times `--runs` batches as a user calls them
(a synchronize after each: the wall), then `--runs` batches with
`timings` (the succinct phase's steps, each between two synchronizes).
Prints the card's name and power limit and one JSON object a process (also
written to `--out`); exits 1 if a batch rejected a lane.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, time
from pathlib import Path
import torch
from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.parallel import batch_verify
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import load_params

runs = int(sys.argv[1])
t0 = time.time()
_build.build()
_build.load_library()
row = {"build_s": time.time() - t0}
d = Path("benchmarks/fixtures/vanilla_k10")
srs = load_params(str(d / "srs.bin"))
for name, prefix, args in (("verify", "snark", ()), ("keccak_verify", "evmsnark", ("shplonk", "evm"))):
    base = [Snark.load(str(d / f"{prefix}_{i:02d}.json")) for i in range(16)]
    snarks = [base[i % 16] for i in range(1024)]
    oks = batch_verify(snarks, srs, *args)
    torch.cuda.synchronize()
    walls, steps = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch_verify(snarks, srs, *args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    for _ in range(runs):
        tm = {}
        batch_verify(snarks, srs, *args, timings=tm)
        steps.append({k: v * 1e3 for k, v in tm.items()})
    row[name] = {"accepted": int(oks.sum()), "walls_ms": walls,
                 "best_proofs_per_s": 1024 / min(walls) * 1e3,
                 "steps_ms": {k: [s[k] for s in steps] for k in steps[0]}}
print(json.dumps(row))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="root of the other checkout")
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--out", type=Path, default=None, help="also write the rows to this file")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"# card: {card}", flush=True)
    here = Path(__file__).resolve().parent
    rows = []
    for label, root in (("parent", args.parent), ("this", here), ("this", here),
                        ("parent", args.parent)):
        done = subprocess.run([sys.executable, "-c", CHILD, str(args.runs)], cwd=root,
                              capture_output=True, text=True)
        if done.returncode:
            print(done.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"verify_compare: the {label} checkout's run failed")
        row = dict(json.loads(done.stdout.strip().splitlines()[-1]), checkout=label, card=card)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    bad = [r["checkout"] for r in rows for k in ("verify", "keccak_verify")
           if r[k]["accepted"] != 1024]
    if bad:
        print(f"verify_compare: a batch rejected a valid lane in {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
