"""The IPA family: the inner-product-argument PCS, its accumulation scheme,
BGH19 multi-open and the MSM decider (the JAX package's `pcs/ipa`), their
host provers, and their batch plans."""

from .bgh19 import Bgh19
from .ipa import (
    Ipa,
    IpaAccumulator,
    IpaAs,
    IpaDecidingKey,
    IpaProvingKey,
    IpaSuccinctVerifyingKey,
    decide,
    decide_all,
    h_coeffs_int,
    h_eval,
    h_eval_int,
)
from .plan import (
    Bgh19Opening,
    IpaFold,
    IpaOpening,
    IpaPlan,
    batch_bgh19_verify,
    batch_ipa_as_verify,
    batch_ipa_verify,
    ipa_plan,
)

__all__ = [
    "Bgh19",
    "Bgh19Opening",
    "Ipa",
    "IpaAccumulator",
    "IpaAs",
    "IpaDecidingKey",
    "IpaFold",
    "IpaOpening",
    "IpaPlan",
    "IpaProvingKey",
    "IpaSuccinctVerifyingKey",
    "batch_bgh19_verify",
    "batch_ipa_as_verify",
    "batch_ipa_verify",
    "decide",
    "decide_all",
    "h_coeffs_int",
    "h_eval",
    "h_eval_int",
    "ipa_plan",
]
