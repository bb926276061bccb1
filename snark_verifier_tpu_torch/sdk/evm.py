"""The EVM SDK: generate a Yul verifier for a protocol and execute it
in-process.  The port's copy of the JAX package's `sdk/evm.py` (the
reference's snark-verifier-sdk src/evm.rs).  Host code: generating and
executing a verifier builds no CUDA library and touches no card.

  * gen_evm_verifier (evm.rs:122-176): the port's generic PlonkVerifier
    run under the EVM codegen loader -> Yul source;
  * evm_verify (:178-192): execute against calldata in the in-process
    interpreter (`loader/yul_interp.py`, standing in for revm), raising
    on revert;
  * encode_calldata (loader/evm/util.rs:81-94): the instances (32-byte
    big-endian words), then the proof's bytes;
  * estimate_gas (loader/evm/util.rs:97-105): the reference's analytic model;
  * estimate_code_size: a PUSH-weighted token model of the compiled size
    (no solc here), against the reference's 24,576-byte deployability bound
    (loader/evm/test.rs:17-21).
"""

from __future__ import annotations

import math
from typing import List, Tuple

from .. import errors
from ..verifier.plonk.protocol import PlonkProtocol


def encode_calldata(instances: List[List[int]], proof: bytes) -> bytes:
    out = b"".join(
        int(v).to_bytes(32, "big") for col in instances for v in col
    )
    return out + proof


def gen_evm_verifier(protocol: PlonkProtocol, srs, scheme_name: str = "shplonk") -> str:
    """Run the port's generic verifier once under the EVM loader; every
    operation it performs is emitted as Yul.  An instance-committing-key
    protocol raises InvalidProtocol, as in the JAX package: the generator
    covers the KZG protocol family only."""
    from ..loader.evm_loader import EvmLoader, EvmTranscriptCodegen
    from ..pcs.kzg.multiopen import Bdfg21, Gwc19
    from ..verifier.plonk.verifier import PlonkProof, PlonkSuccinctVerifier

    if protocol.instance_committing_key is not None:
        raise errors.InvalidProtocol(
            "EVM verifier generation supports the KZG protocol family only")
    scheme = Bdfg21 if scheme_name == "shplonk" else Gwc19
    L = EvmLoader()
    t = EvmTranscriptCodegen(
        L,
        protocol.num_instance,
        proof_offset=0x20 * sum(protocol.num_instance),
        has_initial_state=protocol.transcript_initial_state is not None,
    )
    instances = t.load_instances()
    proof = PlonkProof.read(protocol, instances, t, scheme, L)
    accumulators = PlonkSuccinctVerifier.verify(L.load_svk(srs), protocol, instances, proof,
                                                scheme, L)
    L.decide_all(srs, accumulators)
    return L.yul_code()


def evm_verify(yul: str, instances: List[List[int]], proof: bytes) -> int:
    """Execute the generated verifier -> gas_used; raises
    errors.AssertionFailure if the contract reverts (the reference's
    evm.rs:178-192 panics with the revert's debug display)."""
    from ..loader.yul_interp import execute_yul

    ok, gas, _data = execute_yul(yul, encode_calldata(instances, proof))
    if not ok:
        raise errors.AssertionFailure("EVM verifier reverted")
    return gas


def estimate_gas(cost) -> int:
    """The reference's analytic gas model (loader/evm/util.rs:97-105)."""
    proof_size = cost.num_commitment * 64 + (cost.num_evaluation + cost.num_instance) * 32
    intrinsic = 21000
    calldata = math.ceil(proof_size * 15.25)
    ec_ops = (45100 + cost.num_pairing * 34000) + (cost.num_msm - 2) * 6350
    return intrinsic + calldata + ec_ops


def estimate_code_size(yul: str) -> int:
    """An estimate of a generated verifier's compiled runtime bytecode size.

    There is no solc here, so this counts what each token lowers to: a
    literal becomes PUSHn (1 + n bytes), every builtin call one opcode,
    memory addresses ride in their literals, `let` / assignments cost a
    stack shuffle (~2 bytes), a function's call and definition ~30.  It
    over-counts a little against solc's optimizer (which dedups repeated
    constants by DUP and shares the f_q literal): an upper bound to hold
    against the 24,576-byte EIP-170 limit the reference asserts
    (loader/evm/test.rs:17-21)."""
    from ..loader.yul_interp import tokenize

    size = 0
    for t in tokenize(yul):
        if t[0].isdigit():
            v = int(t, 16) if t.startswith("0x") else int(t)
            size += 1 + max(1, (v.bit_length() + 7) // 8)
        elif t == ":=":
            size += 2
        elif t in ("{", "}", "(", ")", ",", "->"):
            continue
        elif t in ("let", "if"):
            size += 2
        elif t == "function":
            size += 30
        elif t.startswith('"') or t in ("object", "code"):
            continue
        else:
            size += 1  # a builtin's opcode
    return size


def gen_evm_verifier_report(protocol: PlonkProtocol, srs,
                            scheme_name: str = "shplonk") -> Tuple[str, dict]:
    """(yul, {estimated_gas, estimated_code_size})."""
    from ..verifier.cost import estimate_plonk_cost

    yul = gen_evm_verifier(protocol, srs, scheme_name)
    cost = estimate_plonk_cost(protocol, scheme_name)
    return yul, {
        "estimated_gas": estimate_gas(cost),
        "estimated_code_size": estimate_code_size(yul),
    }
