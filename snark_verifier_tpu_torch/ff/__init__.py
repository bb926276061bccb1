from .spec import FQ, FR, MASK, NLIMBS, W, FieldSpec, int_to_limbs, limbs_to_int
from .limb_field import LimbField, get_field
from .word_field import (
    FQW,
    FRW,
    WordField,
    digits4,
    from_jax_elems,
    limbs_to_words,
    np_limbs_to_words,
    to_jax_elems,
    words_to_limbs,
)

FQ_FIELD = get_field(FQ)
FR_FIELD = get_field(FR)

__all__ = [
    "FQ",
    "FR",
    "MASK",
    "NLIMBS",
    "W",
    "FieldSpec",
    "int_to_limbs",
    "limbs_to_int",
    "LimbField",
    "get_field",
    "FQ_FIELD",
    "FR_FIELD",
    "FQW",
    "FRW",
    "WordField",
    "digits4",
    "from_jax_elems",
    "limbs_to_words",
    "np_limbs_to_words",
    "to_jax_elems",
    "words_to_limbs",
]
