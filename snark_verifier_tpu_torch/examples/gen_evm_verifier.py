"""Generate a standalone Yul verifier contract for a StandardPlonk protocol,
prove, and execute the contract in-process: the counterpart of the JAX
package's examples/gen_evm_verifier.py (the reference's
examples/evm-verifier.rs:224-268, with the port's Yul interpreter standing
in for revm).

Host code, as in the JAX package, which pins this path to its CPU: the
generator and the interpreter are python ints, and the proof's commitments
run by `py_ec.msm` (device "cpu"), so nothing here builds the CUDA library
or touches a card.  `--cpu` is accepted for the CLI's sake and changes
nothing.

Checks: the estimated code size is under EIP-170's 24,576 bytes; the
contract accepts the proof; it reverts on a proof with one byte flipped.

    python -m snark_verifier_tpu_torch.examples.gen_evm_verifier \
        [--scheme shplonk|gwc] [--k 3]
"""

from __future__ import annotations

import argparse
import time

from .. import errors
from ..sdk.evm import evm_verify, gen_evm_verifier_report
from ..sdk.proof_io import proof_to_bytes
from ..sdk.snark import Snark
from ..sdk.srs import toy_srs
from ..system.standard_plonk import StandardPlonk, build_protocol, prove
from ..transcript.evm_transcript import EvmTranscriptPy

EIP170_LIMIT = 24576  # the reference asserts deployability (loader/evm/test.rs:17-21)


def run(scheme: str = "shplonk", k: int = 3, seed: int = 42, out=None, check: bool = True):
    """Generate the verifier of StandardPlonk.rand(k, seed) (written to `out`
    when given) and, with `check`, prove and execute it.  -> a report dict
    (Yul bytes, generation seconds, the estimates, and with `check` the
    honest proof's gas_used); raises SystemExit("FAIL") on a failed check."""
    srs = toy_srs(max(32, 4 << k))
    circuit = StandardPlonk.rand(k=k, seed=seed)
    protocol = build_protocol(circuit, srs, device="cpu")
    t0 = time.time()
    yul, rep = gen_evm_verifier_report(protocol, srs, scheme)
    rep.update(yul_bytes=len(yul), gen_s=time.time() - t0)
    if out is not None:
        with open(out, "w") as f:
            f.write(yul)
        print(f"wrote {out}")
    print(f"generated verifier: {len(yul)} bytes of Yul in {rep['gen_s']:.2f}s, estimated gas "
          f"{rep['estimated_gas']}, estimated code size {rep['estimated_code_size']} "
          f"(EIP-170 limit {EIP170_LIMIT})")
    if rep["estimated_code_size"] > EIP170_LIMIT:
        raise SystemExit("FAIL: the verifier exceeds the EIP-170 code size limit")
    if not check:
        return rep
    scalars, points = prove(circuit, protocol, srs, scheme=scheme, transcript=EvmTranscriptPy(),
                            device="cpu")
    snark = Snark(protocol, [list(circuit.instance)], scalars, points)
    proof = proof_to_bytes(snark, scheme, fmt="evm")
    rep["gas_used"] = evm_verify(yul, snark.instances, proof)
    print(f"executed the generated verifier on a real proof: gas_used={rep['gas_used']}")
    bad = bytearray(proof)
    bad[1] ^= 1
    try:
        evm_verify(yul, snark.instances, bytes(bad))
    except errors.AssertionFailure:
        print("rejected the tampered proof (revert)")
    else:
        raise SystemExit("FAIL: the tampered proof was accepted")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gen_evm_verifier")
    ap.add_argument("--scheme", default="shplonk", choices=["shplonk", "gwc"])
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="accepted; this path is host code")
    args = ap.parse_args(argv)
    run(args.scheme, args.k)
    print("PASS")


if __name__ == "__main__":
    main()
