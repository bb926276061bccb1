"""Poseidon permutation and sponge over BN254 Fr (the vanilla x^5 spec):
the counterpart of the JAX package's `hash/poseidon.py`.

T = 3, RATE = 2, R_F = 8, R_P = 57 with the round constants and Cauchy MDS
of the port's own `hash/grain.py`.  Each round is add-constants -> S-box
(all three elements in the 4 + 4 full rounds, element 0 in the 57 partial
rounds) -> MDS, and the sponge follows the reference's (capacity element
2^64, RATE-chunks absorbed into state[1..], a short final chunk padded with
one 1, an exact multiple, empty included, followed by one all-padding
permutation; the squeeze is state[1]).

* `PoseidonPy` — the python-int oracle (a copy of the JAX package's).
* `permute` — one permutation of (B, 3, 8) Fr Montgomery words.  On a CUDA
  tensor it launches `svt_poseidon_permute` (csrc/poseidon_kernels.cu,
  replacing the JAX package's `permute` :110, a 65-step lax.scan that XLA
  compiles); on a CPU tensor it runs `permute_plain`, the same rounds over
  `LimbField` with the same field ops in the same order as the JAX scan
  body, so kernel, twin and JAX agree bit for bit on lazy limbs.
* `absorb` — a whole squeeze of the sponge: on a CUDA tensor one launch of
  `svt_poseidon_absorb` (the chunk adds, the padding and all k // 2 + 1
  permutations in the kernel); on a CPU tensor `absorb_plain`, the same
  adds and `permute_plain` in the same order.
* `PoseidonSponge` — the batched sponge over `absorb` (the JAX package's
  `PoseidonJax` :135).
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from .._build import load_library
from .._launch import check, launch, same_device
from ..device import device_key
from ..ff import FR, FR_FIELD, FRW, limbs_to_words, np_limbs_to_words, words_to_limbs
from ..ff.spec import int_to_limbs
from .grain import generate_constants

T, RATE, R_F, R_P = 3, 2, 8, 57
ROUNDS = R_F + R_P


@functools.lru_cache(maxsize=None)
def get_spec(t: int = T, r_f: int = R_F, r_p: int = R_P):
    """(round_constants[(r_f+r_p)][t], mds[t][t], is_full[r_f+r_p]) ints."""
    rcs, mds = generate_constants(FR.p, 254, t, r_f, r_p)
    half = r_f // 2
    is_full = [r < half or r >= half + r_p for r in range(r_f + r_p)]
    return rcs, mds, is_full


# ------------------------------------------------------------------- oracle


class PoseidonPy:
    """Pure-python-int Poseidon sponge (the gold model)."""

    def __init__(self, t: int = T, rate: int = RATE, r_f: int = R_F, r_p: int = R_P):
        self.p = FR.p
        self.t, self.rate, self.r_f, self.r_p = t, rate, r_f, r_p
        self.rcs, self.mds, self.is_full = get_spec(t, r_f, r_p)
        self.state = [1 << 64] + [0] * (t - 1)
        self.buf: List[int] = []

    def permutation(self, inputs: Sequence[int]):
        p, t = self.p, self.t
        s = list(self.state)
        if len(inputs) >= t:
            raise ValueError("a permutation absorbs at most t - 1 elements")
        for i, v in enumerate(inputs):
            s[1 + i] = (s[1 + i] + v) % p
        if len(inputs) < self.rate:
            s[1 + len(inputs)] = (s[1 + len(inputs)] + 1) % p
        for r in range(self.r_f + self.r_p):
            s = [(x + c) % p for x, c in zip(s, self.rcs[r])]
            if self.is_full[r]:
                s = [pow(x, 5, p) for x in s]
            else:
                s[0] = pow(s[0], 5, p)
            s = [sum(self.mds[i][j] * s[j] for j in range(t)) % p for i in range(t)]
        self.state = s

    def update(self, elements: Sequence[int]):
        self.buf.extend(int(e) % self.p for e in elements)

    def squeeze(self) -> int:
        buf, self.buf = self.buf, []
        for i in range(0, len(buf), self.rate):
            self.permutation(buf[i : i + self.rate])
        if len(buf) % self.rate == 0:
            self.permutation([])
        return self.state[1]


# -------------------------------------------------------------- permutation


@functools.lru_cache(maxsize=None)
def _host_constants():
    """(rc (65, 3, 8), mds (3, 3, 8)) int32 Montgomery words, numpy."""
    rcs, mds, _ = get_spec()
    R = 1 << 256
    rc = np.stack([[int_to_limbs(c * R % FR.p) for c in row] for row in rcs])
    md = np.stack([[int_to_limbs(m * R % FR.p) for m in row] for row in mds])
    return np_limbs_to_words(rc), np_limbs_to_words(md)


_consts: dict = {}  # device_key(device) -> (rc, mds) limb tensors (plain twin)
_loaded: set = set()  # CUDA devices whose constant memory holds the spec


def _limb_constants(device):
    key = device_key(device)
    if key not in _consts:
        rc, md = _host_constants()
        _consts[key] = (words_to_limbs(torch.from_numpy(rc)).to(device),
                        words_to_limbs(torch.from_numpy(md)).to(device))
    return _consts[key]


def permute_plain(state):
    """The JAX scan body in plain PyTorch on (..., 3, 8) words: add the
    round constants, x^5 as s·(s²)², the S-box on every element in a full
    round and on element 0 in a partial one, then out_i = ((M_i0 s_0 +
    M_i1 s_1) + M_i2 s_2)."""
    F = FR_FIELD
    _, _, is_full = get_spec()
    rc, mds = _limb_constants(state.device)
    s = words_to_limbs(state)
    first = torch.arange(T, device=state.device) == 0
    for r in range(ROUNDS):
        s = F.add(s, rc[r])
        s5 = F.mul(s, F.square(F.square(s)))
        take5 = first | is_full[r]
        s = torch.where(take5[:, None], s5, s)
        prod = F.mul(mds, s[..., None, :, :])  # (..., t, t, 16): M_ij · s_j
        acc = prod[..., 0, :]
        for j in range(1, T):
            acc = F.add(acc, prod[..., j, :])
        s = acc
    return limbs_to_words(s)


def _library(dev):
    """The kernel library, with the spec's constants on device `dev`."""
    lib = load_library()
    if device_key(dev) not in _loaded:
        rc, md = _host_constants()
        with torch.cuda.device(dev):
            err = lib.svt_poseidon_load_constants(rc.ctypes.data, md.ctypes.data)
        if err:
            raise RuntimeError(f"poseidon: loading the constants failed ({err})")
        _loaded.add(device_key(dev))
    return lib


def permute(state):
    """One permutation of (B, 3, 8) Fr Montgomery words -> (B, 3, 8)."""
    check("poseidon_permute", state, 3, (T, 8))
    if state.device.type == "cpu":
        return permute_plain(state)
    out = torch.empty_like(state)
    if state.shape[0]:
        launch("poseidon_permute", _library(state.device).svt_poseidon_permute,
               state.data_ptr(), out.data_ptr(), state.shape[0], device=state.device)
    return out


# -------------------------------------------------------------------- sponge


def absorb_plain(state, inputs):
    """The sponge's squeeze in plain PyTorch on any device: state (B, 3, 8)
    absorbs inputs (B, k, 8) RATE elements at a time into state[1..], one
    `permute_plain` per chunk; a short final chunk is padded with one 1, and
    an exact multiple (k = 0 included) is followed by one all-padding
    permutation: k // 2 + 1 permutations."""
    k = inputs.shape[1]
    one = FRW.const("ONE", state.device).expand(state.shape[0], 1, 8)
    for i in range(0, k + 1, RATE):
        cols = torch.cat([inputs[:, i : i + RATE], one], 1)[:, :RATE]  # m < RATE: the 1 pads
        m = cols.shape[1] if i < k else 1
        mid = FRW.plain("add", state[:, 1 : 1 + m], cols[:, :m])
        state = permute_plain(torch.cat([state[:, :1], mid, state[:, 1 + m :]], 1))
    return state


def absorb(state, inputs):
    """(B, 3, 8) state, (B, k, 8) buffered elements -> the state after the
    squeeze's k // 2 + 1 permutations.  On a CUDA tensor one launch of
    `svt_poseidon_absorb`; on a CPU tensor `absorb_plain`."""
    check("poseidon_absorb", state, 3, (T, 8))
    check("poseidon_absorb", inputs, 3, (8,))
    same_device("poseidon_absorb", state, inputs)
    if inputs.shape[0] != state.shape[0]:
        raise ValueError(f"poseidon_absorb: {state.shape[0]} states but {inputs.shape[0]} buffers")
    if state.device.type == "cpu":
        return absorb_plain(state, inputs)
    out = torch.empty_like(state)
    if state.shape[0]:
        launch("poseidon_absorb", _library(state.device).svt_poseidon_absorb, state.data_ptr(),
               inputs.data_ptr(), inputs.shape[1], out.data_ptr(), state.shape[0],
               device=state.device)
    return out


class PoseidonSponge:
    """The batched sponge: state (B, 3, 8) Fr words on one device; inputs
    are (B, 8) or (8,) word handles (`update`) or (B, k, 8) blocks of k
    elements (`update_block`).  A squeeze knows its whole buffer, so it is
    one `absorb`: on the card one launch for all its permutations."""

    def __init__(self, batch: int, device):
        self.device = torch.device(device)
        init = torch.zeros((T, 8), dtype=torch.int32)
        init[0] = FRW.from_int(1 << 64)
        self.state = init.to(self.device).expand(batch, T, 8).contiguous()
        self.buf: List = []

    def update(self, elements: Sequence):
        self.buf.extend(c.expand(self.state.shape[0], 8)[:, None] for c in elements)

    def update_block(self, block):
        """Buffer (B, k, 8) elements, k of them per lane, in order."""
        self.buf.append(block)

    def squeeze(self):
        buf, self.buf = self.buf, []
        batch = self.state.shape[0]
        if buf:
            inputs = torch.cat(buf, 1).contiguous()
        else:
            inputs = torch.empty((batch, 0, 8), dtype=torch.int32, device=self.device)
        self.state = absorb(self.state, inputs)
        return self.state[:, 1]
