"""The verifier's cost model: a copy of the JAX package's `verifier/cost.py`
(the reference's cost.rs:7-41 and the CostEstimation impls at
verifier/plonk.rs:147-178, gwc19.rs:160-174, bdfg21.rs:369-382).  It sizes
the EVM verifier's analytic gas (`sdk/evm.py::estimate_gas`)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Cost:
    num_instance: int = 0
    num_commitment: int = 0
    num_evaluation: int = 0
    num_msm: int = 0
    num_pairing: int = 0

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(
            self.num_instance + other.num_instance,
            self.num_commitment + other.num_commitment,
            self.num_evaluation + other.num_evaluation,
            self.num_msm + other.num_msm,
            self.num_pairing + other.num_pairing,
        )


def estimate_pcs_cost(protocol, scheme_name: str) -> Cost:
    """GWC19 reads and multiplies one opening point a query set; SHPLONK two."""
    if scheme_name == "gwc":
        from ..pcs.kzg.multiopen import gwc_query_sets
        from .plonk.verifier import PlonkProof

        num_w = len(gwc_query_sets(PlonkProof.empty_queries(protocol)))
        return Cost(num_commitment=num_w, num_msm=num_w)
    return Cost(num_commitment=2, num_msm=2)


def estimate_plonk_cost(protocol, scheme_name: str, succinct_only: bool = False) -> Cost:
    num_acc = len(protocol.accumulator_indices)
    num_commitment = sum(protocol.num_witness) + protocol.quotient.num_chunk()
    plonk = Cost(
        num_instance=sum(protocol.num_instance),
        num_commitment=num_commitment,
        num_evaluation=len(protocol.evaluations),
        num_msm=len(protocol.preprocessed) + num_commitment + 1 + 2 * num_acc,
    )
    total = plonk + estimate_pcs_cost(protocol, scheme_name)
    if not succinct_only:
        total = total + Cost(num_pairing=2)
    return total
