from .poseidon_transcript import PoseidonTranscript, PoseidonTranscriptPy, fq_to_fr

__all__ = ["PoseidonTranscript", "PoseidonTranscriptPy", "fq_to_fr"]
