"""Mixed-protocol aggregation, the reference's zkevm + state shape
(snark-verifier-sdk/benches/zkevm_plus_state.rs): snarks of two DIFFERENT
circuits verified one batch per protocol, their accumulators folded across
the groups into ONE deferred pairing
(`sdk.aggregation.aggregate_heterogeneous_and_decide`).  The counterpart of
the JAX package's examples/aggregate_mixed.py.

Checks: the valid mixed batch decides true; with one member's public input
moved, the one root pairing decides false.

    python -m snark_verifier_tpu_torch.examples.aggregate_mixed [--cpu]
"""

from __future__ import annotations

import argparse
import time

from ..device import resolve_device
from ..ff.spec import FR
from ..sdk.aggregation import aggregate_heterogeneous_and_decide
from ..sdk.snark import Snark
from ..sdk.srs import toy_srs
from ..system import linearized_plonk as lp
from ..system import standard_plonk as sp


def main(argv=None):
    ap = argparse.ArgumentParser(prog="aggregate_mixed")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    print(f"device={dev}")

    srs = toy_srs(64)
    # family A: StandardPlonk (an instance-bound gate), 3 snarks
    base = sp.StandardPlonk.rand(k=3, seed=9)
    proto_a = sp.build_protocol(base, srs, device=dev)
    snarks = []
    for i in range(3):
        c = sp.StandardPlonk.rand(k=3, seed=9).set_instance(
            [(base.instance[0] + 13 * i) % FR.p])
        snarks.append(sp.gen_snark(c, proto_a, srs, scheme="shplonk", device=dev))

    # family B: linearized PLONK (another gate structure AND another
    # linearization strategy), 2 snarks
    circ_b = lp.LinearizedPlonk.rand(k=3, seed=4)
    proto_b = lp.compile_protocol(circ_b, srs, strategy=lp.MINUS_VANISHING, device=dev)
    snarks.insert(1, lp.gen_snark(circ_b, proto_b, srs, "shplonk", device=dev))
    snarks.append(lp.gen_snark(circ_b, proto_b, srs, "shplonk", device=dev))
    if proto_a.content_hash() == proto_b.content_hash():
        raise SystemExit("FAIL: the two families share a protocol")

    t0 = time.time()
    ok = bool(aggregate_heterogeneous_and_decide(snarks, srs, "shplonk", device=dev))
    print(f"aggregated {len(snarks)} snarks across 2 protocols (interleaved order) -> one "
          f"pairing in {time.time() - t0:.1f}s: accepted={ok}")

    # tamper one member: the single root pairing must reject
    bad = Snark(snarks[0].protocol, [[(snarks[0].instances[0][0] + 1) % FR.p]],
                snarks[0].scalars, snarks[0].points)
    ok2 = bool(aggregate_heterogeneous_and_decide([bad] + snarks[1:], srs, "shplonk",
                                                  device=dev))
    print(f"tampered member -> accepted={ok2}")
    if not ok or ok2:
        raise SystemExit("FAIL")
    print("PASS")


if __name__ == "__main__":
    main()
