from .poseidon import (
    PoseidonPy,
    PoseidonSponge,
    absorb,
    absorb_plain,
    get_spec,
    permute,
    permute_plain,
)

__all__ = ["PoseidonPy", "PoseidonSponge", "absorb", "absorb_plain", "get_spec", "permute",
           "permute_plain"]
