"""Prove a StandardPlonk circuit on the host, then verify it on the device:
the counterpart of the JAX package's examples/verify_standard_plonk.py (the
reference's examples/evm-verifier.rs:224-268 single-proof flow: prove,
verify succinctly, decide the accumulator with a pairing).

The proof and a copy with a wrong public input verify as one batch
(`sdk.aggregation.batch_verify`): the first must accept, the second reject.

    python -m snark_verifier_tpu_torch.examples.verify_standard_plonk \
        [--scheme shplonk|gwc] [--k 3] [--cpu]
"""

from __future__ import annotations

import argparse
import time

from ..device import resolve_device
from ..ff.spec import FR
from ..sdk.aggregation import batch_verify
from ..sdk.snark import Snark
from ..sdk.srs import toy_srs
from ..system.standard_plonk import StandardPlonk, build_protocol, prove


def main(argv=None):
    ap = argparse.ArgumentParser(prog="verify_standard_plonk")
    ap.add_argument("--scheme", default="shplonk", choices=["shplonk", "gwc"])
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    print(f"device={dev} scheme={args.scheme} k={args.k}")

    srs = toy_srs(1 << max(args.k + 2, 5))
    circuit = StandardPlonk.rand(k=args.k, seed=1)
    protocol = build_protocol(circuit, srs, device=dev)
    t0 = time.time()
    scalars, points = prove(circuit, protocol, srs, scheme=args.scheme, device=dev)
    print(f"host prove: {time.time() - t0:.2f}s ({len(scalars)} scalars, {len(points)} points)")

    snark = Snark(protocol, [list(circuit.instance)], scalars, points)
    # negative control: a wrong public input must be rejected
    bad = Snark(protocol, [[(circuit.instance[0] + 1) % FR.p]], scalars, points)
    t0 = time.time()
    ok, ok_bad = (bool(v) for v in batch_verify([snark, bad], srs, args.scheme, device=dev))
    print(f"verify + decide of [proof, tampered]: {time.time() - t0:.2f}s -> accepted={ok}, "
          f"tampered instance rejected={not ok_bad}")
    if not ok or ok_bad:
        raise SystemExit("FAIL")
    print("PASS")


if __name__ == "__main__":
    main()
