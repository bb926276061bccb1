"""snark_verifier_tpu_torch — the PyTorch/CUDA port of snark_verifier_tpu.

A second package beside the JAX one, which stays the reference: each module
here mirrors its counterpart's path (ff/, ec/, msm/) and is held against it
in tests/test_torch_*.py.  It imports torch, never jax, and nothing of
snark_verifier_tpu.

Ported so far: the BN254 G1 Pippenger MSM (`msm.msm`), the batched PLONK
verifier with SHPLONK or GWC19 and the Poseidon transcript
(`parallel.batch_verify`), the pairing decide, and the KZG accumulation
fold with the 1-card recursion tree (`sdk.aggregation.aggregate_and_decide`,
`sdk.tree_aggregation.tree_aggregate_root`), on hand-written Hopper kernels
(csrc/), and the host code around them: the provers, the EVM verifier
generator (`sdk.evm`) and the CLI (`python -m snark_verifier_tpu_torch`).
Entry points run on the CUDA card unless the caller passes device="cpu"
(`--cpu` on the CLI), where every kernel's plain PyTorch twin runs instead.
"""

from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
