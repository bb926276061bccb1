from .encode import (
    fq12_from_int,
    fq12_to_int,
    fq_mont,
    tower_from_int,
    tower_limbs,
    tower_to_int,
)
from .tower import FQ2, FQ6, FQ12, Fq2Field, Fq6Field, Fq12Field

__all__ = [
    "FQ2",
    "FQ6",
    "FQ12",
    "Fq2Field",
    "Fq6Field",
    "Fq12Field",
    "fq12_from_int",
    "fq12_to_int",
    "fq_mont",
    "tower_from_int",
    "tower_limbs",
    "tower_to_int",
]
