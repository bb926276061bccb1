"""Prove the pool of StandardPlonk proofs the verify and tree cells run,
with the port's host prover, and write them under perfbench/fixtures/.

The circuit is snark-verifier-sdk's application circuit
`application::StandardPlonk` (benches/standard_plonk.rs): advice a, b, c
(copy-enabled), fixed q_a, q_b, q_c, q_ab, constant, one instance column,
the gate q_a·a + q_b·b + q_c·c + q_ab·a·b + constant + instance = 0, and
its one region: row 0 binds a to the instance (q_a = −1), row 1 holds
a = −5 with the selectors 1..5, row 2 a = 1, copied to b in row 3 and to
c in row 4.  k = 8 (gen_srs(8) there).  Every proof takes its own instance
x (StandardPlonk::rand draws it as a u32) and its own blinding.

    python perfbench/tools/prove_standard_plonk.py --count 1024 --workers 4

writes fixtures/srs_k8.bin (the toy SRS of seed 0xA11CE, 2^8 points),
fixtures/standard_plonk_k8.protocol.json, and one JSONL pool a transcript
(`standard_plonk_k8.poseidon.jsonl`, `.evm.jsonl`: a proof a line, its
instances, scalars and points as hex), each proof checked by the port's
native verifier as it is made.  Run on the CPU: ~4 s a proof a worker.
The same arguments write the same files.  The benchmark never runs it;
fixtures/MANIFEST.json holds their sha256."""

from __future__ import annotations

import argparse
import functools
import json
import random
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

OUT = Path(__file__).resolve().parent.parent / "fixtures"
K = 8
SRS_SEED = 0xA11CE


def _circuit(x: int):
    from snark_verifier_tpu_torch.ff.spec import FR
    from snark_verifier_tpu_torch.system.vanilla_plonk import Assignment, CircuitSpec, Col

    r = FR.p
    spec = CircuitSpec(k=K, num_fixed=5, num_advice=[3], num_instance=[1],
                       permutation_columns=[Col("advice", 0), Col("advice", 1),
                                            Col("advice", 2)])
    a, b, c = spec.advice(0), spec.advice(1), spec.advice(2)
    q_a, q_b, q_c, q_ab, constant = (spec.fixed(i) for i in range(5))
    spec.gates = [q_a * a + q_b * b + q_c * c + q_ab * a * b + constant + spec.instance(0)]
    n = 1 << K
    fixed = [[0] * n for _ in range(5)]
    fixed[0][0] = r - 1
    for idx, col in enumerate(fixed, start=1):
        col[1] = idx
    adv = [[0] * n for _ in range(3)]
    adv[0][0], adv[0][1], adv[0][2] = x % r, r - 5, 1
    adv[1][3] = 1
    adv[2][4] = 1
    A, B, C = Col("advice", 0), Col("advice", 1), Col("advice", 2)
    copies = [((A, 2), (B, 3)), ((A, 2), (C, 4))]
    return spec, Assignment(spec=spec, fixed=fixed, advice_phases=[adv], instance=[[x % r]],
                            copies=copies)


@functools.lru_cache(maxsize=None)
def _srs():
    from snark_verifier_tpu_torch.sdk.srs import toy_srs

    return toy_srs(1 << K, SRS_SEED)


@functools.lru_cache(maxsize=None)
def _protocol():
    from snark_verifier_tpu_torch.system.vanilla_plonk import compile_protocol

    spec, asg = _circuit(1)
    return compile_protocol(spec, asg.fixed, asg.copies, _srs(), device="cpu")


def _prove(job):
    i, transcript = job
    from snark_verifier_tpu_torch.system.vanilla_plonk import gen_snark

    srs, protocol = _srs(), _protocol()
    rng = random.Random(f"standard_plonk:{transcript}:{i}")
    _, asg = _circuit(rng.getrandbits(32))
    s = gen_snark(asg, protocol, srs, scheme="shplonk", seed=rng.getrandbits(64),
                  transcript=transcript, device="cpu")
    return {"instances": [[hex(v) for v in col] for col in s.instances],
            "scalars": [hex(v) for v in s.scalars],
            "points": [[hex(x), hex(y)] for x, y in s.points]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--count", type=int, default=1024)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--transcripts", default="poseidon,evm")
    args = ap.parse_args(argv)
    from snark_verifier_tpu_torch.sdk.srs import save_params

    save_params(_srs(), str(OUT / f"srs_k{K}.bin"))
    with open(OUT / f"standard_plonk_k{K}.protocol.json", "w") as f:
        json.dump(_protocol().to_json(), f)
    for transcript in args.transcripts.split(","):
        jobs = [(i, transcript) for i in range(args.count)]
        with ProcessPoolExecutor(max_workers=args.workers) as ex:
            lines = list(ex.map(_prove, jobs, chunksize=8))
        with open(OUT / f"standard_plonk_k{K}.{transcript}.jsonl", "w") as f:
            for line in lines:
                f.write(json.dumps(line, separators=(",", ":")) + "\n")
        print(f"{transcript}: {len(lines)} proofs", file=sys.stderr)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    main()
