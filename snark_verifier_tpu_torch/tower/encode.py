"""Host codecs between python-int tower tuples (the oracle's form,
pairing/py_pairing.py) and the kernels' word layout: the counterpart of the
JAX package's `tower/encode.py`.

Layouts (trailing dims; int32 words of the Montgomery form x·R mod p, as
ff/word_field.py):
  Fq2  : (..., 2, 8)          c0 + c1·u
  Fq6  : (..., 3, 2, 8)       c0 + c1·v + c2·v²
  Fq12 : (..., 2, 3, 2, 8)    c0 + c1·w
An encoder takes one element (a nested int tuple) or a list of them; a
decoder returns one tuple for an unbatched tensor, else a list.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ff.spec import FQ, NLIMBS, int_to_limbs, limbs_to_int
from ..ff.word_field import np_limbs_to_words, words_to_limbs

_R = 1 << 256
_SHAPES = {2: (2,), 6: (3, 2), 12: (2, 3, 2)}


def fq_mont(x: int) -> np.ndarray:
    """(16,) uint32 16-bit limbs of x·R mod p (the JAX package's `_fq_mont`)."""
    return int_to_limbs((x % FQ.p) * _R % FQ.p)


def _flat(a):
    return [int(a)] if not isinstance(a, (tuple, list)) else [v for c in a for v in _flat(c)]


def _nest(vals, shape):
    if len(shape) == 1:
        return tuple(vals)
    step = len(vals) // shape[0]
    return tuple(_nest(vals[i * step:(i + 1) * step], shape[1:]) for i in range(shape[0]))


def tower_limbs(a, degree: int) -> np.ndarray:
    """Host: one tower element -> its (*shape, 16) uint32 Montgomery limbs."""
    return np.stack([fq_mont(v) for v in _flat(a)]).reshape(*_SHAPES[degree], NLIMBS)


def tower_from_int(a, degree: int, device="cpu"):
    """Host: an element of Fq^degree (degree 2, 6 or 12) or a list of them ->
    int32 words on `device`."""
    if isinstance(a, list):
        if not a:
            return torch.zeros((0, *_SHAPES[degree], 8), dtype=torch.int32, device=device)
        arr = np.stack([tower_limbs(x, degree) for x in a])
    else:
        arr = tower_limbs(a, degree)
    return torch.from_numpy(np_limbs_to_words(arr)).to(device)


def tower_to_int(words, degree: int):
    """Host: words (..., *shape, 8) -> canonical int tuple(s)."""
    shape = _SHAPES[degree]
    rinv = pow(_R, -1, FQ.p)
    limbs = words_to_limbs(words.detach().cpu()).numpy()
    flat = limbs.reshape(-1, NLIMBS)
    vals = [limbs_to_int(v) * rinv % FQ.p for v in flat]
    n = int(np.prod(shape))
    elems = [_nest(vals[i:i + n], shape) for i in range(0, len(vals), n)]
    return elems[0] if words.dim() == len(shape) + 1 else elems


def fq12_from_int(a, device="cpu"):
    return tower_from_int(a, 12, device)


def fq12_to_int(words):
    return tower_to_int(words, 12)
