from .poseidon import PoseidonPy, PoseidonSponge, get_spec, permute, permute_plain

__all__ = ["PoseidonPy", "PoseidonSponge", "get_spec", "permute", "permute_plain"]
