from .evm_transcript import EvmTranscript, EvmTranscriptPy, PrecomputedChallengeTranscript
from .poseidon_transcript import PoseidonTranscript, PoseidonTranscriptPy, fq_to_fr

__all__ = ["EvmTranscript", "EvmTranscriptPy", "PoseidonTranscript", "PoseidonTranscriptPy",
           "PrecomputedChallengeTranscript", "fq_to_fr"]
