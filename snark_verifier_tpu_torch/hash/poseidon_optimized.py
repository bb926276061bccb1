"""The optimized (sparse-MDS) Poseidon: an independent second
implementation of the transcript hash, the port's copy of the JAX package's
`hash/poseidon_optimized.py`, re-derived from the reference's optimized
spec (snark-verifier src/util/hash/poseidon.rs:168-316) and the paper's
construction (eprint 2019/458, supplementary B).  Host code on python ints.

Purpose (interop hardening): the transcript (`hash/poseidon.py` and the
`svt_poseidon_*` kernels) evaluates the vanilla ARC -> sbox -> MDS rounds;
the reference evaluates this factorized form.  They are equal, and only a
second executable path makes that an asserted equivalence:
tests/test_torch_host_library.py holds the challenge sequences of both to
each other over random transcripts.

Construction summary:
  * constants_start[0] = rc[0]; constants_start[i] = M^-1 rc[i] for the rest
    of the first r_f/2 full rounds, plus one extra entry folding the
    accumulated partial-round constants through M^-1
  * partial-round constants become single scalars (index 0 of the folded
    vector), accumulated back-to-front
  * each partial round's MDS is factorized M^T = M' * M'' with M'' sparse
    (row + first-column hat); pre_sparse_mds soaks up the accumulated M'
  * the final full round uses zero constants (rounds are constant-led here
    vs constant-trailed in the vanilla form)
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

from ..ff.spec import FR
from .grain import generate_constants

P = FR.p


# ----------------------------------------------------------- matrix helpers


def _mat_vec(m, v):
    return [sum(mi * vi for mi, vi in zip(row, v)) % P for row in m]


def _mat_mul(a, b):
    n, k, m = len(a), len(b), len(b[0])
    return [
        [sum(a[i][x] * b[x][j] for x in range(k)) % P for j in range(m)]
        for i in range(n)
    ]


def _transpose(m):
    return [list(col) for col in zip(*m)]


def _identity(t):
    return [[1 if i == j else 0 for j in range(t)] for i in range(t)]


def _det(m):
    n = len(m)
    if n == 1:
        return m[0][0] % P
    if n == 2:
        return (m[0][0] * m[1][1] - m[0][1] * m[1][0]) % P
    out = 0
    for j in range(n):
        minor = [row[:j] + row[j + 1 :] for row in m[1:]]
        s = m[0][j] * _det(minor) % P
        out = (out + (-s if j % 2 else s)) % P
    return out


def _mat_inv(m):
    """Gauss-Jordan inverse mod p."""
    n = len(m)
    a = [list(row) + ident for row, ident in zip([list(r) for r in m], _identity(n))]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] % P)
        a[col], a[piv] = a[piv], a[col]
        inv = pow(a[col][col], -1, P)
        a[col] = [v * inv % P for v in a[col]]
        for r in range(n):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [(v - f * w) % P for v, w in zip(a[r], a[col])]
    return [row[n:] for row in a]


def _factorise(m) -> Tuple[List[List[int]], Tuple[List[int], List[int]]]:
    """M = M' * M'' with M'' sparse; returns (m_prime, (row, col_hat))
    following poseidon.rs:172-226."""
    t = len(m)
    rate = t - 1
    w = [m[i][0] for i in range(1, t)]
    m_hat = [[m[i + 1][j + 1] for j in range(rate)] for i in range(rate)]
    det = _det(m_hat)
    det_inv = pow(det, -1, P)
    w_hat = []
    for j in range(rate):
        m_hat_j = [list(row) for row in m_hat]
        for i in range(rate):
            m_hat_j[i][j] = w[i]
        w_hat.append(_det(m_hat_j) * det_inv % P)
    m_prime = _identity(t)
    for i in range(rate):
        for j in range(rate):
            m_prime[i + 1][j + 1] = m_hat[i][j]
    m_prime_prime = _identity(t)
    m_prime_prime[0] = list(m[0])
    for i in range(rate):
        m_prime_prime[i + 1][0] = w_hat[i]
    row = [m_prime_prime[i][0] for i in range(t)]  # first col of M''
    col_hat = list(m_prime_prime[0][1:])  # first row of M'' minus head
    return m_prime, (row, col_hat)


# ------------------------------------------------------------ spec assembly


@functools.lru_cache(maxsize=None)
def optimized_spec(t: int = 3, r_f: int = 8, r_p: int = 57):
    """-> (constants_start, constants_partial, constants_end, mds,
    pre_sparse_mds, sparse_matrices) — poseidon.rs:230-316."""
    rcs, mds = generate_constants(P, 254, t, r_f, r_p)
    rcs = [list(r) for r in rcs]
    mds = [list(r) for r in mds]
    mds_inv = _mat_inv(mds)
    half = r_f // 2

    constants_start = [list(rcs[0])]
    for r in range(1, half):
        constants_start.append(_mat_vec(mds_inv, rcs[r]))

    acc = list(rcs[half + r_p])
    constants_partial = [0] * r_p
    for i in range(r_p - 1, -1, -1):
        tmp = _mat_vec(mds_inv, acc)
        constants_partial[i] = tmp[0]
        tmp[0] = 0
        acc = [(tv + cv) % P for tv, cv in zip(tmp, rcs[half + i])]
    constants_start.append(_mat_vec(mds_inv, acc))

    constants_end = [_mat_vec(mds_inv, rcs[half + r_p + 1 + i]) for i in range(half - 1)]

    mds_t = _transpose(mds)
    acc_m = [list(r) for r in mds_t]
    sparse = []
    for _ in range(r_p):
        m_prime, m_pp = _factorise(acc_m)
        acc_m = _mat_mul(mds_t, m_prime)
        sparse.append(m_pp)
    sparse.reverse()
    pre_sparse_mds = _transpose(acc_m)
    return constants_start, constants_partial, constants_end, mds, pre_sparse_mds, sparse


# ---------------------------------------------------------------- the hash


class PoseidonOptimizedPy:
    """Sponge with the reference's exact optimized permutation schedule
    (poseidon.rs:414-501).  The external semantics of `hash.poseidon.PoseidonPy`:
    update() buffers, squeeze() absorbs and returns state[1]."""

    def __init__(self, t: int = 3, rate: int = 2, r_f: int = 8, r_p: int = 57):
        if rate + 1 != t:
            raise ValueError(f"PoseidonOptimizedPy: rate {rate} with width {t}")
        self.t, self.rate = t, rate
        self.spec = optimized_spec(t, r_f, r_p)
        self.r_f_half = r_f // 2
        self.clear()

    def clear(self):
        self.state = [1 << 64] + [0] * (self.t - 1)
        self.buf: List[int] = []

    def update(self, elements: Sequence[int]):
        self.buf.extend(v % P for v in elements)

    def squeeze(self) -> int:
        buf, self.buf = self.buf, []
        exact = len(buf) % self.rate == 0
        for i in range(0, len(buf), self.rate):
            self._permutation(buf[i : i + self.rate])
        if exact:
            self._permutation([])
        return self.state[1]

    # -- permutation (poseidon.rs:469-500) ------------------------------

    @staticmethod
    def _pow5(v, c):
        return (pow(v, 5, P) + c) % P

    def _sbox_full(self, constants):
        self.state = [self._pow5(s, c) for s, c in zip(self.state, constants)]

    def _sbox_part(self, constant):
        self.state[0] = self._pow5(self.state[0], constant)

    def _absorb_with_pre_constants(self, inputs, pre):
        assert len(inputs) < self.t
        s = self.state
        s[0] = (s[0] + pre[0]) % P
        for i, inp in enumerate(inputs):
            s[i + 1] = (s[i + 1] + inp + pre[i + 1]) % P
        for idx, i in enumerate(range(1 + len(inputs), self.t)):
            # pad with a single 1 then zeros (folded into the constants)
            s[i] = (s[i] + pre[i] + (1 if idx == 0 else 0)) % P

    def _apply_mds(self, m):
        self.state = _mat_vec(m, self.state)

    def _apply_sparse_mds(self, sm):
        row, col_hat = sm
        old = self.state
        new0 = sum(r * s for r, s in zip(row, old)) % P
        self.state = [new0] + [
            (ch * old[0] + old[i + 1]) % P for i, ch in enumerate(col_hat)
        ]

    def _permutation(self, inputs):
        (c_start, c_partial, c_end, mds, pre_sparse, sparse) = self.spec
        self._absorb_with_pre_constants(inputs, c_start[0])
        for constants in c_start[1 : self.r_f_half]:
            self._sbox_full(constants)
            self._apply_mds(mds)
        self._sbox_full(c_start[-1])
        self._apply_mds(pre_sparse)

        for constant, sm in zip(c_partial, sparse):
            self._sbox_part(constant)
            self._apply_sparse_mds(sm)

        for constants in c_end:
            self._sbox_full(constants)
            self._apply_mds(mds)
        self._sbox_full([0] * self.t)
        self._apply_mds(mds)
