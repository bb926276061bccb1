"""The generic PLONK succinct verifier, written once against a loader: the
counterpart of the JAX package's `verifier/plonk/verifier.py`.

  * CommonPolynomialEvaluation — z^n, z^n − 1 and the Lagrange evaluations
    with one batched inversion (reference protocol.rs:188-279);
  * PlonkProof.read — transcript-driven proof parsing (proof.rs:52-153),
    instance evaluations (:283-318), linearization MSM assembly (:179-281);
  * PlonkSuccinctVerifier.verify -> [accumulator, *old_accumulators]
    (verifier/plonk.rs:58-92); the old accumulators are decoded from the
    instances the protocol's `accumulator_indices` name (3 × 88-bit limbs
    per coordinate, `pcs/kzg/accumulator.py`);
  * PlonkVerifier.verify = the succinct verify, then the loader's
    `decide_all` (verifier/plonk.rs:125-134); `verify_snark_native` is
    that under `NATIVE`, the host provers' self-check.

The protocol is host data; scalars and points are loader handles.  Under
`TapeLoader` one call records the protocol's Fr program
(`verifier/plonk/plan.py`, the verify path); under `TorchLoader` one call
verifies a batch of proofs of one protocol on one device, op by op (the
plan's witness); under `NATIVE` it is the python-int oracle
(`succinct_verify_native`).  Supported: GWC19 (`Gwc19`) and SHPLONK
(`Bdfg21`), each with the Poseidon or the keccak ("evm") transcript;
instances absorbed as scalars, or committed by an instance committing key
(the query-instance family: the verifier's MSM of the instances, absorbed
as a point and taken as the instance columns' commitments).
"""

from __future__ import annotations

from typing import Dict, List

from ... import errors
from ...pcs.kzg.multiopen import Bdfg21, Gwc19, Query as PcsQuery
from .protocol import PlonkProtocol, Query, R


class CommonPolynomialEvaluation:
    def __init__(self, domain, lagranges: List[int], z, L):
        self.zn = L.pow_static(z, domain.n)
        self.zn_minus_one = L.sub(self.zn, L.scalar(1))
        self.identity = z

        numer = L.mul(self.zn_minus_one, L.scalar(domain.n_inv))
        omegas = [domain.rotate(i) for i in lagranges]
        numers = [L.mul(numer, L.scalar(w)) for w in omegas]
        denoms = [L.sub(z, L.scalar(w)) for w in omegas]
        invs = L.batch_inv(denoms + [self.zn_minus_one])
        self.zn_minus_one_inv = invs[-1]
        self.lagrange = {
            i: L.mul(num, invs[j]) for j, (i, num) in enumerate(zip(lagranges, numers))
        }

    def get(self, cp):
        if cp[0] == "identity":
            return self.identity
        return self.lagrange[cp[1]]


class PlonkProof:
    def __init__(self, **kw):
        self.__dict__.update(kw)

    @staticmethod
    def read(protocol: PlonkProtocol, instances, transcript, pcs_scheme, L):
        """instances: list (per instance column) of lists of loader scalars."""
        if protocol.transcript_initial_state is not None:
            transcript.common_scalar(L.scalar(protocol.transcript_initial_state))
        if [len(i) for i in instances] != protocol.num_instance:
            raise errors.InvalidInstances(
                f"{[len(i) for i in instances]} != {protocol.num_instance}"
            )
        committed_instances = None
        if protocol.instance_committing_key is not None:
            # the query-instance family: the verifier commits to each instance
            # column itself, Σ bases·instances (+ constant), and absorbs the
            # point (the reference's system/halo2.rs:724-756)
            ick = protocol.instance_committing_key
            committed_instances = []
            for cols in instances:
                expr = L.msm_sum([L.msm_base_int(b) * s for s, b in zip(cols, ick["bases"])])
                if ick.get("constant") is not None:
                    expr = expr + L.msm_base_int(ick["constant"])
                pt = L.msm_evaluate(expr)
                committed_instances.append(pt)
                transcript.common_ec_point(L.affine(pt))
        else:
            for cols in instances:
                for v in cols:
                    transcript.common_scalar(v)

        witnesses, challenges = [], []
        for n, m in zip(protocol.num_witness, protocol.num_challenge):
            witnesses.extend(transcript.read_n_ec_points(n))
            challenges.extend(transcript.squeeze_challenge() for _ in range(m))

        quotients = transcript.read_n_ec_points(protocol.quotient.num_chunk())
        z = transcript.squeeze_challenge()
        evaluations = transcript.read_n_scalars(len(protocol.evaluations))
        pcs_proof = pcs_scheme.read_proof(PlonkProof.empty_queries(protocol), transcript)
        old_accumulators = [
            L.accumulator_from_limbs([instances[i][j] for i, j in acc_idx])
            for acc_idx in protocol.accumulator_indices
        ]
        return PlonkProof(
            committed_instances=committed_instances,
            witnesses=witnesses,
            challenges=challenges,
            quotients=quotients,
            z=z,
            evaluations=evaluations,
            pcs=pcs_proof,
            old_accumulators=old_accumulators,
        )

    @staticmethod
    def empty_queries(protocol: PlonkProtocol) -> List[PcsQuery]:
        return [PcsQuery(q.poly, protocol.domain.rotate(q.rotation)) for q in protocol.queries]

    def queries(self, protocol, evaluations: Dict) -> List[PcsQuery]:
        return [
            PcsQuery(pq.poly, pq.shift, evaluations[q])
            for q, pq in zip(protocol.queries, PlonkProof.empty_queries(protocol))
        ]

    def instance_evals_and_map(self, protocol, instances, cpe, L) -> Dict:
        """The evaluations map: Query -> loader scalar (proof.rs:283-318)."""
        evals: Dict[Query, object] = {}
        offset = len(protocol.preprocessed)
        rng = range(offset, offset + len(protocol.num_instance))
        inst_queries = [q for q in protocol.quotient.numerator.used_query() if q.poly in rng]
        if protocol.instance_committing_key is not None:
            inst_queries = []  # the instance columns are committed, not evaluated
        for q in inst_queries:
            acc = None
            for i, v in enumerate(instances[q.poly - offset]):
                term = L.mul(v, cpe.get(("lagrange", i - q.rotation)))
                acc = term if acc is None else L.add(acc, term)
            evals[q] = L.scalar(0) if acc is None else acc
        for q, v in zip(protocol.evaluations, self.evaluations):
            evals[q] = v
        return evals

    def commitments(self, protocol, cpe, evaluations: Dict, L) -> List:
        """Linearization MSM assembly (proof.rs:179-281)."""
        comms: List = [L.msm_base_int(pt) for pt in protocol.preprocessed]
        if self.committed_instances is not None:
            comms.extend(L.msm_base_proj(p) for p in self.committed_instances)
        else:
            comms.extend(L.msm_zero() for _ in protocol.num_instance)
        comms.extend(L.msm_base(w) for w in self.witnesses)

        def constant(v):
            return L.msm_constant(L.scalar(v))

        def common_poly(cp):
            return L.msm_constant(cpe.get(cp))

        def poly(q: Query):
            if q in evaluations:
                return L.msm_constant(evaluations[q])
            if q.rotation != 0:
                raise errors.InvalidProtocol(f"missing query {q}")
            return comms[q.poly]

        def challenge(idx):
            return L.msm_constant(self.challenges[idx])

        zero = L.zero_scalar()

        def product(a, b):
            if a.size() == 0:
                return b * a.try_constant(zero)
            if b.size() == 0:
                return a * b.try_constant(zero)
            raise errors.InvalidProtocol("invalid linearization")

        numerator = protocol.quotient.numerator.evaluate(
            constant,
            common_poly,
            poly,
            challenge,
            lambda a: -a,
            lambda a, b: a + b,
            product,
            lambda a, s: a * L.scalar(s),
        )

        quotient_query = Query(
            len(protocol.preprocessed) + len(protocol.num_instance) + len(self.witnesses), 0
        )
        zn_chunk = L.pow_static(cpe.zn, protocol.quotient.chunk_degree)
        pow_zn = L.powers(zn_chunk, len(self.quotients))
        quotient = L.msm_sum([L.msm_base(c) * p for c, p in zip(self.quotients, pow_zn)])

        lin = protocol.linearization
        if lin == "WithoutConstant":
            lin_query = Query(quotient_query.poly + 1, 0)
            msm, const = numerator.split()
            comms.append(quotient)
            comms.append(msm)
            base = const if const is not None else L.scalar(0)
            evaluations[quotient_query] = L.mul(
                L.add(base, evaluations[lin_query]), cpe.zn_minus_one_inv
            )
        elif lin == "MinusVanishingTimesQuotient":
            msm, const = (numerator - quotient * cpe.zn_minus_one).split()
            comms.append(msm)
            evaluations[quotient_query] = const if const is not None else L.scalar(0)
        else:
            comms.append(quotient)
            c = numerator.try_constant(zero)
            if c is None:
                raise errors.InvalidProtocol("invalid linearization")
            evaluations[quotient_query] = L.mul(c, cpe.zn_minus_one_inv)
        return comms


class PlonkSuccinctVerifier:
    """verify -> [accumulator, *old_accumulators] (verifier/plonk.rs:58-92)."""

    @staticmethod
    def read_proof(protocol, instances, transcript, pcs_scheme, L):
        return PlonkProof.read(protocol, instances, transcript, pcs_scheme, L)

    @staticmethod
    def verify(svk_g, protocol, instances, proof, pcs_scheme, L):
        cpe = CommonPolynomialEvaluation(protocol.domain, protocol.langranges(), proof.z, L)
        evaluations = proof.instance_evals_and_map(protocol, instances, cpe, L)
        commitments = proof.commitments(protocol, cpe, evaluations, L)
        queries = proof.queries(protocol, evaluations)
        accumulator = pcs_scheme.verify(svk_g, commitments, proof.z, queries, proof.pcs, L)
        return [accumulator] + list(proof.old_accumulators)


_SCHEMES = {"shplonk": Bdfg21, "gwc": Gwc19}
_TRANSCRIPTS = ("poseidon", "evm")


def succinct_verify_native(snark, srs, scheme_name: str = "shplonk",
                           transcript: str = "poseidon"):
    """Python-int succinct verification of one `sdk.snark.Snark` ("shplonk"
    or "gwc", with the transcript "poseidon" or "evm") -> [(lhs, rhs)]
    affine-int accumulators, the fresh one and the instance-decoded old
    ones: the port's own oracle, the reference's NativeLoader path.  Any
    other scheme or transcript raises ValueError."""
    from ...loader.base import NATIVE
    from ...transcript.evm_transcript import EvmTranscriptPy
    from ...transcript.poseidon_transcript import PoseidonTranscriptPy

    if scheme_name not in _SCHEMES or transcript not in _TRANSCRIPTS:
        raise ValueError(f"unsupported scheme/transcript pair {scheme_name}/{transcript}")
    scheme = _SCHEMES[scheme_name]
    tcls = PoseidonTranscriptPy if transcript == "poseidon" else EvmTranscriptPy
    t = tcls(scalars=snark.scalars, points=snark.points)
    instances = [[v % R for v in col] for col in snark.instances]
    proof = PlonkProof.read(snark.protocol, instances, t, scheme, NATIVE)
    return PlonkSuccinctVerifier.verify(srs.g, snark.protocol, instances, proof, scheme, NATIVE)


class PlonkVerifier:
    """The succinct verify, then the pairing decide of every accumulator
    (verifier/plonk.rs:125-134)."""

    read_proof = PlonkSuccinctVerifier.read_proof

    @staticmethod
    def verify(srs, protocol, instances, proof, pcs_scheme, L):
        accumulators = PlonkSuccinctVerifier.verify(
            L.load_svk(srs), protocol, instances, proof, pcs_scheme, L)
        return L.decide_all(srs, accumulators)


def verify_snark_native(snark, srs, scheme_name: str = "shplonk",
                        transcript: str = "poseidon") -> bool:
    """The whole python-int verification of one `sdk.snark.Snark`: the
    succinct verify (`succinct_verify_native`), then the python-int pairing
    decide of every accumulator (the reference's native verifier, which its
    SDK runs after every proof, snark-verifier-sdk/src/halo2.rs:124-138)."""
    from ...loader.base import NATIVE

    return bool(NATIVE.decide_all(srs, succinct_verify_native(snark, srs, scheme_name,
                                                                 transcript)))
