from .curve import CurveOps
from .g1 import (
    G1,
    from_affine_int,
    from_affine_int_np,
    from_jax_points,
    generator,
    limbs_to_words,
    to_affine_int,
    to_jax_points,
    words_to_limbs,
)
from . import py_ec

__all__ = [
    "CurveOps",
    "G1",
    "from_affine_int",
    "from_affine_int_np",
    "from_jax_points",
    "generator",
    "limbs_to_words",
    "to_affine_int",
    "to_jax_points",
    "words_to_limbs",
    "py_ec",
]
