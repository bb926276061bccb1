"""A whole run of one cell on the CPU at a tiny size, the card's check
skipped, optionally with a fault planted in the program underneath or the
control in its place; prints one JSON line: the result's `correct` and
checks, and the modules of JAX or the JAX package then loaded.

    python3 perfbench/tests/dryrun.py <cell> [<fault> | control]

A run on the CPU is no measurement: it exercises the set-up, the window,
the check and the result line."""

import importlib
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TINY = {
    "verify-poseidon-b1024": {"kind": "proof_lanes", "transcript": "poseidon",
                              "lanes": 4, "batches": 1, "tampered_batches": 1,
                              "tampers_per_batch": 2, "tamper_variants": 2},
    "verify-keccak-b1024": {"kind": "proof_lanes", "transcript": "evm",
                            "lanes": 4, "batches": 1, "tampered_batches": 1,
                            "tampers_per_batch": 2, "tamper_variants": 2},
    "tree-l1024": {"kind": "proof_lanes", "transcript": "poseidon",
                   "lanes": 2, "batches": 2, "tampered_batches": 1, "tampers_per_batch": 1,
                   "tamper_variants": 1},
    "msm-k21": {"kind": "msm_scalars", "vectors": 1},
}
TINY_N = 2048


def plant(cell: str, fault: str, traffic: dict):
    """Break the program underneath the entry's call: its answer altered
    where it is produced, half of its batch left out, or a fold step that
    returns its state unchanged."""
    import torch

    if cell.startswith("verify"):
        mod = importlib.import_module("snark_verifier_tpu_torch.parallel.batch_verify")

        real = mod.batch_verify
        if fault == "answer_altered":
            def faulty(snarks, *a, **kw):
                out = real(snarks, *a, **kw).clone()
                out[0] = ~out[0]
                return out
        elif fault == "half_batch":
            traffic["tampers_per_batch"] = traffic["lanes"]  # every lane's bit matters

            def faulty(snarks, *a, **kw):
                half = real(snarks[: len(snarks) // 2], *a, **kw)
                rest = torch.ones(len(snarks) - len(half), dtype=torch.bool, device=half.device)
                return torch.cat([half, rest])
        else:
            raise ValueError(fault)
        mod.batch_verify = faulty
    elif cell.startswith("tree"):
        from snark_verifier_tpu_torch.pcs.kzg.accumulation import KzgAs
        from snark_verifier_tpu_torch.sdk import tree_aggregation as mod

        real = mod.tree_aggregate_root
        if fault == "answer_altered":
            def faulty(*a, **kw):
                lhs, rhs, ok = real(*a, **kw)
                return lhs, rhs, ~ok
            mod.tree_aggregate_root = faulty
        elif fault == "half_batch":
            mod.tree_aggregate_root = lambda snarks, *a, **kw: real(
                snarks[: len(snarks) // 2] * 2, *a, **kw)
        elif fault == "state_unchanged":
            KzgAs._fold_once = staticmethod(lambda pairs: (pairs[:, 0, 0], pairs[:, 0, 1]))
        else:
            raise ValueError(fault)
    elif cell.startswith("msm"):
        from snark_verifier_tpu_torch.msm import pippenger as mod

        real = mod.msm_checked
        if fault == "answer_altered":
            def faulty(points, scalars, *a, **kw):
                s = scalars.clone()
                s[0, 0] ^= 1
                return real(points, s, *a, **kw)
        elif fault == "half_batch":
            def faulty(points, scalars, *a, **kw):
                h = points.shape[0] // 2
                return real(points[:h], scalars[:h], *a, **kw)
        else:
            raise ValueError(fault)
        mod.msm_checked = faulty
    else:
        raise ValueError(cell)


def main(argv):
    for p in (BENCH, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import cli
    from harness.catalog import Catalog

    cell, mode = argv[0], (argv[1] if len(argv) > 1 else "sound")
    traffic = dict(TINY[cell])
    cat = Catalog()
    config = cat.config(cat.cell(cell)["config"])
    if cell.startswith("msm"):
        config = dict(config, n=TINY_N)
    if mode not in ("sound", "control"):
        plant(cell, mode, traffic)
    result, _ = cli.run_cell(cell, 2**31 + 2024, 0.01, False, time.perf_counter(), catalog=cat,
                             device="cpu", traffic=traffic, config=config, check_card=False,
                             control=(mode == "control"))
    print(json.dumps({"cell": cell, "mode": mode, "correct": result["correct"],
                      "checks": result["checks"], "forbidden": cli.forbidden_modules(),
                      "metrics": sorted(result["metrics"])}))


if __name__ == "__main__":
    main(sys.argv[1:])
