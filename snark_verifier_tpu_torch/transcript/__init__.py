from .evm_transcript import EvmTranscript, EvmTranscriptPy, PrecomputedChallengeTranscript
from .poseidon_transcript import (
    PoseidonTranscript,
    PoseidonTranscriptPy,
    PoseidonTranscriptWriter,
    fq_to_fr,
)

__all__ = ["EvmTranscript", "EvmTranscriptPy", "PoseidonTranscript", "PoseidonTranscriptPy",
           "PoseidonTranscriptWriter", "PrecomputedChallengeTranscript", "fq_to_fr"]
