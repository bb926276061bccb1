"""N proofs -> batched verification -> the accumulator fold -> ONE pairing
check: the counterpart of the JAX package's examples/aggregate_proofs.py
(the reference's examples/evm-verifier-with-accumulator.rs and
snark-verifier-sdk/benches/standard_plonk.rs: StandardPlonk snarks folded
through an aggregation circuit), here the fold a batched device
computation (`sdk.aggregation.aggregate`).

Checks: every proof accepts and a tampered member rejects (one
`batch_verify` of the N proofs and the tampered one); the fold of the N
proofs decides true with one pairing; the fold with the last member
replaced by the tampered one decides false.

    python -m snark_verifier_tpu_torch.examples.aggregate_proofs [--n 4] [--cpu]
"""

from __future__ import annotations

import argparse
import time

from ..device import resolve_device
from ..ff.spec import FR
from ..pcs.kzg.decider import decide
from ..sdk.aggregation import aggregate, batch_verify
from ..sdk.snark import Snark
from ..sdk.srs import toy_srs
from ..system.standard_plonk import StandardPlonk, build_protocol, gen_snark


def main(argv=None):
    ap = argparse.ArgumentParser(prog="aggregate_proofs")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    print(f"device={dev} n={args.n}")

    srs = toy_srs(32)
    circuit = StandardPlonk.rand(k=3, seed=7)
    protocol = build_protocol(circuit, srs, device=dev)
    t0 = time.time()
    snark = gen_snark(circuit, protocol, srs, scheme="shplonk", device=dev)
    snarks = [snark] * args.n
    print(f"host prove (1 snark, replicated x{args.n}): {time.time() - t0:.2f}s")
    bad = Snark(protocol, [[(snark.instances[0][0] + 1) % FR.p]], snark.scalars, snark.points)

    t0 = time.time()
    oks = [bool(v) for v in batch_verify(snarks + [bad], srs, "shplonk", device=dev)]
    print(f"batch verify of the {args.n} and a tampered one: {time.time() - t0:.1f}s -> {oks}")

    t0 = time.time()
    lhs, rhs = aggregate(snarks, srs, "shplonk", device=dev)
    ok = bool(decide(srs, lhs, rhs))
    print(f"aggregate fold + ONE pairing: {time.time() - t0:.1f}s -> accepted={ok}")

    # negative control: a corrupted member must poison the fold
    lhs2, rhs2 = aggregate(snarks[:-1] + [bad], srs, "shplonk", device=dev)
    ok2 = bool(decide(srs, lhs2, rhs2))
    print(f"corrupted member rejected={not ok2}")
    if oks != [True] * args.n + [False] or not ok or ok2:
        raise SystemExit("FAIL")
    print("PASS")


if __name__ == "__main__":
    main()
