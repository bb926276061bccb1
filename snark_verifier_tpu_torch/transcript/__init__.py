from .evm_transcript import EvmTranscript, EvmTranscriptPy
from .poseidon_transcript import PoseidonTranscript, PoseidonTranscriptPy, fq_to_fr

__all__ = ["EvmTranscript", "EvmTranscriptPy", "PoseidonTranscript", "PoseidonTranscriptPy",
           "fq_to_fr"]
