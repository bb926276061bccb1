"""Prove and verify a vanilla-PLONK circuit with copy constraints, a lookup
argument and a phase-1 witness bound to a phase-0 user challenge: the full
halo2 verification equation on the device.  The counterpart of the JAX
package's examples/verify_vanilla_plonk.py, on the port's
`system/vanilla_fixtures.py` circuit (the committed fixtures' circuit) at
k = 6, where the JAX example reads the same circuit from its tests.

The proof goes through its bytes (`sdk.proof_io`), then verifies in one
batch beside a copy with a wrong public input: the first must accept, the
second reject.

    python -m snark_verifier_tpu_torch.examples.verify_vanilla_plonk \
        [--scheme shplonk|gwc] [--cpu]
"""

from __future__ import annotations

import argparse
import time

from ..device import resolve_device
from ..ff.spec import FR
from ..sdk import proof_io
from ..sdk.aggregation import batch_verify
from ..sdk.snark import Snark
from ..sdk.srs import toy_srs
from ..system.vanilla_fixtures import demo_assignment, demo_spec
from ..system.vanilla_plonk import compile_protocol, gen_snark

K = 6


def main(argv=None):
    ap = argparse.ArgumentParser(prog="verify_vanilla_plonk")
    ap.add_argument("--scheme", default="shplonk", choices=["shplonk", "gwc"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)

    spec = demo_spec(K)
    asg = demo_assignment(spec)
    srs = toy_srs(8 * spec.n)
    protocol = compile_protocol(spec, asg.fixed, asg.copies, srs, device=dev)
    print(f"device={dev}; protocol: {len(protocol.preprocessed)} preprocessed, "
          f"witness groups {protocol.num_witness}, challenges {protocol.num_challenge}, "
          f"{protocol.quotient.num_chunk()} quotient chunks")

    t0 = time.time()
    snark = gen_snark(asg, protocol, srs, scheme=args.scheme, device=dev)
    print(f"proved in {time.time() - t0:.1f}s "
          f"({len(snark.points)} points, {len(snark.scalars)} scalars)")

    data = proof_io.proof_to_bytes(snark, args.scheme)
    print(f"proof bytes: {len(data)}")
    again = proof_io.proof_from_bytes(protocol, snark.instances, data, args.scheme)
    bad = Snark(protocol, [[(again.instances[0][0] + 1) % FR.p]], again.scalars, again.points)

    t0 = time.time()
    ok, ok_bad = (bool(v) for v in batch_verify([again, bad], srs, args.scheme, device=dev))
    print(f"verified [proof, tampered] in {time.time() - t0:.1f}s: accepted={ok}, "
          f"tampered instance rejected={not ok_bad}")
    if not ok or ok_bad:
        raise SystemExit("FAIL")
    print("PASS")


if __name__ == "__main__":
    main()
