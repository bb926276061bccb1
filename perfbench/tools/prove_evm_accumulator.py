"""Prove the pool of EVM-accumulator aggregation-circuit proofs the cell
verify-evm-agg-b1024 runs, with the port's host prover, and write them
under perfbench/fixtures_evm_accumulator/.

The circuit is the shape of snark-verifier-sdk's
`configs/example_evm_accumulator.json` (halo2-base's FlexGateConfig with 5
advice columns, RangeConfig with 1 lookup-advice column, 1 constants
column, 1 instance column of the 12 accumulator limbs, every column in the
permutation), built by `snark_verifier_tpu_torch/system/evm_accumulator.py`
at k = 8 and lookup_bits 7 (published: 21 and 20).  Every proof carries an
accumulator of its own, (τ·s·G, s·G) with s drawn from its seed and τ the
toy SRS's trapdoor, as 12 limbs of 88 bits, and its own witness and
blinding.

    python perfbench/tools/prove_evm_accumulator.py --count 1024 --workers 6

writes srs_k8.bin (the toy SRS of seed 0xA11CE, 2^8 points: the bytes of
perfbench/fixtures/srs_k8.bin), evm_accumulator_k8.protocol.json, the pool
evm_accumulator_k8.evm.jsonl (a proof a line: its instances, scalars and
points as hex; EVM keccak transcript, SHPLONK), each proof checked by the
port's native verifier (the old accumulator decided too) as it is made,
and MANIFEST.json with their sha256.  Run on the CPU: ~7 s a proof a
worker.  The same arguments write the same files.  The benchmark never
runs it."""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import random
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

OUT = Path(__file__).resolve().parent.parent / "fixtures_evm_accumulator"
K = 8
LOOKUP_BITS = 7
SRS_SEED = 0xA11CE
TRANSCRIPT = "evm"


@functools.lru_cache(maxsize=None)
def _srs():
    from snark_verifier_tpu_torch.sdk.srs import toy_srs

    return toy_srs(1 << K, SRS_SEED)


@functools.lru_cache(maxsize=None)
def _circuit():
    from snark_verifier_tpu_torch.system.evm_accumulator import evm_accumulator_circuit

    return evm_accumulator_circuit(K, LOOKUP_BITS)


@functools.lru_cache(maxsize=None)
def _protocol():
    return _circuit().protocol(_srs(), device="cpu")


def _prove(i: int) -> dict:
    from snark_verifier_tpu_torch.ff.spec import FR
    from snark_verifier_tpu_torch.pcs.kzg.accumulator import accumulator_to_limbs_int
    from snark_verifier_tpu_torch.system.evm_accumulator import valid_accumulator
    from snark_verifier_tpu_torch.system.vanilla_plonk import gen_snark

    srs = _srs()
    rng = random.Random(f"evm_accumulator:{TRANSCRIPT}:{i}")
    limbs = accumulator_to_limbs_int(valid_accumulator(srs.tau, rng.randrange(1, FR.p)))
    asg = _circuit().assignment(limbs, rng.getrandbits(64))
    s = gen_snark(asg, _protocol(), srs, scheme="shplonk", seed=rng.getrandbits(64),
                  transcript=TRANSCRIPT, device="cpu")
    return {"instances": [[hex(v) for v in col] for col in s.instances],
            "scalars": [hex(v) for v in s.scalars],
            "points": [[hex(x), hex(y)] for x, y in s.points]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--count", type=int, default=1024)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    from snark_verifier_tpu_torch.sdk.srs import save_params

    out = args.out
    out.mkdir(parents=True, exist_ok=True)
    names = {"srs": f"srs_k{K}.bin", "protocol": f"evm_accumulator_k{K}.protocol.json",
             "pool": f"evm_accumulator_k{K}.{TRANSCRIPT}.jsonl"}
    save_params(_srs(), str(out / names["srs"]))
    with open(out / names["protocol"], "w") as f:
        json.dump(_protocol().to_json(), f)
    with ProcessPoolExecutor(max_workers=args.workers) as ex:
        lines = list(ex.map(_prove, range(args.count), chunksize=4))
    with open(out / names["pool"], "w") as f:
        for line in lines:
            f.write(json.dumps(line, separators=(",", ":")) + "\n")
    print(f"{TRANSCRIPT}: {len(lines)} proofs", file=sys.stderr)
    manifest = {
        "made_by": f"perfbench/tools/prove_evm_accumulator.py --count {args.count} "
                   f"(the port's host prover)",
        "sha256": {n: hashlib.sha256((out / n).read_bytes()).hexdigest()
                   for n in sorted(names.values())},
    }
    with open(out / "MANIFEST.json", "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    main()
