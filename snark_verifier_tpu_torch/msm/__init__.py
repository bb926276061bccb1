from .pippenger import (
    default_capacity,
    extract_digits,
    msm,
    msm_checked,
    msm_int,
    scalars_from_int,
)

__all__ = [
    "default_capacity",
    "extract_digits",
    "msm",
    "msm_checked",
    "msm_int",
    "scalars_from_int",
]
