"""BN254's two prime fields and curve constant, as python ints."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FieldSpec:
    name: str
    p: int

    @property
    def two_adicity(self) -> int:
        s, t = 0, self.p - 1
        while t % 2 == 0:
            s, t = s + 1, t // 2
        return s


# Fq (coordinates) and Fr (scalars and the transcript)
FQ = FieldSpec("bn254_fq",
               21888242871839275222246405745257275088696311157297823662689037894645226208583)
FR = FieldSpec("bn254_fr",
               21888242871839275222246405745257275088548364400416034343698204186575808495617)

BN254_B = 3  # y^2 = x^3 + 3; generator (1, 2)
