"""The inner-product-argument PCS, its accumulation scheme and its decider:
the counterpart of the JAX package's `pcs/ipa/ipa.py` (the reference's
pcs/ipa.rs, ipa/decider.rs and ipa/accumulation.rs; BN254 G1 and the
Poseidon transcript, as in the JAX package).

  * keys: `IpaSuccinctVerifyingKey` (:173; k, G₀, H, the zk base S),
    `IpaDecidingKey` (:322; the 2^k bases G, uploaded once per device as
    `g_dev`), `IpaAccumulator` (:185; the challenges ξ and the final base U);
  * host helpers `h_coeffs_int` (:64) and `h_eval_int` (:73), and `h_eval`,
    the loader version of `h_eval_dev` (:84);
  * `Ipa.read_proof` (:262), `Ipa.succinct_verify` (:282);
    `IpaAs.read_proof` (:403), `IpaAs.verify` (:421): written once against
    a loader (`loader/base.py`), so `TorchLoader` runs them eagerly (the
    witness), `NATIVE` in python ints (the oracle) and `TapeLoader` records
    them (`pcs/ipa/plan.py`, the batch path).  The succinct check
    C_k == c·U + v'·H' is one MSM, lhs − rhs, and one accept bit: the MSM
    is the identity (`L.msm_is_identity`), which is the JAX package's
    `_point_eq` (:114) of the two sides, both-identity accepted and
    one-identity rejected;
  * `decide` (:335), `decide_all` (:352): U == ⟨h(ξ), G⟩ by one 2^k-point
    `msm`, its scalars from one `svt_ipa_h_coeffs` launch
    (`msm/cuda_ops.py::h_coeffs`), the bit `& ~overflow` as in the JAX
    package;
  * `from_jax` helpers carry the JAX package's keys and accumulators
    across: its device accumulators hold 16×16-bit Montgomery limbs, the
    port 8×32-bit words (`ec.from_jax_points`, `ff.from_jax_elems`).

The host provers: `IpaProvingKey` (:134; `rand`, `commit`, `svk`),
`Ipa.create_proof` (:200) and `IpaAs.create_proof` (:366), python ints
but for their MSMs, each one `msm_checked` on the card over the key's own
bases G ‖ H ‖ S, uploaded once per device (device None), or `py_ec.msm`
(device "cpu").  `Ipa.create_proof` keeps no folded bases: after i rounds
the folded base j is Σ_t w_t·G[j + t·n/2^i], with w the interleaved
products of the challenges so far, so each round's L and R, and the final
U, are MSMs over G itself with their scalars expanded by w (the same
points the JAX package's base folding makes, without its n scalar
multiplications on the host).  Their randomness is the JAX package's
`np.random.default_rng(seed)`, draw for draw.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import ff
from ...device import device_key, resolve_device
from ...ec import g1, py_ec
from ...ec.g1 import from_affine_int, limbs_to_words
from ...ff import FQW, np_limbs_to_words
from ...ff.spec import FR
from ...msm import cuda_ops
from ...msm.pippenger import msm, msm_int
from ...utils.py_poly import peval

R_MOD = FR.p


# --------------------------------------------------------------- host helpers


def h_coeffs_int(xi: Sequence[int], scalar: int = 1) -> List[int]:
    """Host coefficients of h(X) = scalar·Π_i (1 + ξ_{k-1-i} X^(2^i))."""
    coeffs = [scalar % R_MOD]
    for x in reversed(list(xi)):
        coeffs = coeffs + [c * x % R_MOD for c in coeffs]
    return coeffs


def h_eval_int(xi: Sequence[int], z: int) -> int:
    acc, zp = 1, z % R_MOD
    for x in reversed(list(xi)):
        acc = acc * (1 + x * zp) % R_MOD
        zp = zp * zp % R_MOD
    return acc


def h_eval(xi: List, z, L):
    """h(z) = Π_i (1 + ξ_{k-1-i}·z^(2^i)) over loader scalars."""
    acc, zp = None, z
    for x in reversed(xi):
        term = L.add(L.mul(x, zp), L.scalar(1))
        acc = term if acc is None else L.mul(acc, term)
        zp = L.mul(zp, zp)
    return acc


def _mont_words(values: Sequence[int]) -> np.ndarray:
    """Host: python ints -> (n, 8) Fr Montgomery words, numpy."""
    from ...ff.spec import int_to_limbs

    R = 1 << 256
    arr = np.zeros((len(values), 16), np.uint32)
    for i, v in enumerate(values):
        arr[i] = int_to_limbs(v % R_MOD * R % R_MOD)
    return np_limbs_to_words(arr)


def _inner(a: Sequence[int], b: Sequence[int]) -> int:
    return sum(x * y for x, y in zip(a, b)) % R_MOD


def _rand_fr(rng) -> int:
    """One scalar from the generator, as the JAX package's provers draw it."""
    return int.from_bytes(rng.bytes(32)) % R_MOD


# ----------------------------------------------------------------------- keys


@dataclass
class IpaProvingKey:
    """The bases G (2^k affine int tuples), the blinder H and the zk base S
    (the reference's ipa.rs:185-227)."""

    k: int
    g: List
    h: Tuple
    s: Optional[Tuple] = None
    _tables: Dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def zk(self) -> bool:
        return self.s is not None

    @staticmethod
    def rand(k: int, zk: bool = False, seed: int = 0) -> "IpaProvingKey":
        """Random bases from `np.random.default_rng(seed)` (the reference's
        ipa.rs:229-243), the JAX package's key for the same seed."""
        rng = np.random.default_rng(seed)
        scalars = [_rand_fr(rng) or 1 for _ in range((1 << k) + 2)]
        pts = [py_ec.scalar_mul(py_ec.G1_GEN, s) for s in scalars]
        g, h, s = pts[: 1 << k], pts[1 << k], pts[(1 << k) + 1]
        return IpaProvingKey(k, g, h, s if zk else None)

    def _msm(self, scalars: Sequence[int], device):
        """Σ scalarsᵢ·basesᵢ over G ‖ H ‖ S (S the identity without zk)."""
        return msm_int(list(self.g) + [self.h, self.s], self._tables, scalars, device)

    def commit(self, coeffs: Sequence[int], omega: Optional[int] = None, device=None):
        """Σ cᵢ·Gᵢ, plus ω·S with zk and ω given -> an affine int tuple: one
        MSM on `device` (None: the card)."""
        if len(coeffs) > self.n:
            raise ValueError(f"commit: {len(coeffs)} coefficients for 2^{self.k} bases")
        if self.s is None or omega is None:
            return self._msm(coeffs, device)
        return self._msm(list(coeffs) + [0] * (self.n - len(coeffs)) + [0, omega], device)

    def svk(self) -> "IpaSuccinctVerifyingKey":
        return IpaSuccinctVerifyingKey(self.k, self.g[0], self.h, self.s)


@dataclass
class IpaSuccinctVerifyingKey:
    k: int
    g0: Tuple
    h: Tuple
    s: Optional[Tuple] = None

    @property
    def zk(self) -> bool:
        return self.s is not None

    def key(self) -> tuple:
        """What identifies the key: a batch verifies under one."""
        return (self.k, tuple(self.g0), tuple(self.h), None if self.s is None else tuple(self.s))

    @staticmethod
    def from_jax(svk) -> "IpaSuccinctVerifyingKey":
        return IpaSuccinctVerifyingKey(svk.k, tuple(svk.g0), tuple(svk.h),
                                       None if svk.s is None else tuple(svk.s))


@dataclass
class IpaAccumulator:
    """(ξ, U): scalars and point as host ints (ξ ints, U an affine tuple) or
    as words (ξ a list of k (8,) Montgomery words or a (k, 8) tensor, U
    (3, 8) projective or (2, 8) affine words); a batch's accumulators as
    (B, k, 8) and (B, 3, 8) (`lane` takes one out)."""

    xi: Any
    u: Any

    def lane(self, b: int) -> "IpaAccumulator":
        return IpaAccumulator(self.xi[b], self.u[b])

    @staticmethod
    def from_jax(acc, device=None) -> "IpaAccumulator":
        """A JAX-package accumulator -> the port's: host ints stay ints;
        device limbs ((16,) Fr Montgomery limbs, U (3, 16) or (2, 16)
        Montgomery limbs) become words on `device` (None: the CUDA card)."""
        if acc.u is None or isinstance(acc.u, tuple):
            return IpaAccumulator([int(x) for x in acc.xi], acc.u)
        xi = ff.from_jax_elems(np.stack([np.asarray(x) for x in acc.xi]), device)
        u = np.asarray(acc.u)
        if u.shape[-2] == 2:  # affine: Z = 1
            one = np.asarray(FQW.limb.const("ONE", "cpu").numpy(), np.uint32)
            u = np.concatenate([u, np.broadcast_to(one, u[..., :1, :].shape)], -2)
        return IpaAccumulator(xi, g1.from_jax_points(u, device))


@dataclass
class IpaDecidingKey:
    """svk and all 2^k bases G: affine int tuples, or an (n, 3, 16) limb
    tensor already on a device (the JAX package's point layout)."""

    svk: IpaSuccinctVerifyingKey
    g: Any
    _dev: Dict = field(default_factory=dict, repr=False, compare=False)

    def g_dev(self, device):
        """G as (n, 3, 16) projective Montgomery limbs on `device`, uploaded
        once per device."""
        key = device_key(device)
        if key not in self._dev:
            g = self.g
            self._dev[key] = (g.to(device) if isinstance(g, torch.Tensor)
                              else from_affine_int(list(g), device=device))
        return self._dev[key]

    @staticmethod
    def from_jax(dk) -> "IpaDecidingKey":
        return IpaDecidingKey(IpaSuccinctVerifyingKey.from_jax(dk.svk), list(dk.g))


def _affine_int_words(pt, device):
    return limbs_to_words(from_affine_int([tuple(pt) if pt is not None else None],
                                          device=device))[0]


# ---------------------------------------------------------------------- verifier


class Ipa:
    """The host prover and the succinct verifier of one opening p(z) = v."""

    @staticmethod
    def create_proof(pk: IpaProvingKey, p: Sequence[int], z: int,
                     omega: Optional[int] = None, transcript=None, seed: int = 1,
                     device=None) -> IpaAccumulator:
        """The prover (the reference's ipa.rs:40-123): writes the proof to
        `transcript` (a python-int writer) and returns the host-int
        accumulator.  Every MSM runs on `device` (None: the card)."""
        rng = np.random.default_rng(seed)
        n = pk.n
        coeffs = [int(c) % R_MOD for c in p] + [0] * (n - len(p))

        if pk.zk:
            p_bar = [_rand_fr(rng) for _ in range(n)]
            p_bar[0] = (p_bar[0] - peval(p_bar, z)) % R_MOD  # p_bar(z) = 0
            omega_bar = _rand_fr(rng)
            transcript.write_ec_point(pk.commit(p_bar, omega_bar, device))
            alpha = transcript.squeeze_challenge()
            transcript.write_scalar((omega + alpha * omega_bar) % R_MOD)
            coeffs = [(a + alpha * b) % R_MOD for a, b in zip(coeffs, p_bar)]

        xi_0 = transcript.squeeze_challenge()
        zs = [1] * n
        for i in range(1, n):
            zs[i] = zs[i - 1] * z % R_MOD
        weights = [1]  # the folded base j is Σ_t weights[t]·G[j + t·len(coeffs)]
        xis = []
        for _ in range(pk.k):
            m = len(coeffs)
            half = m // 2
            sl, sr = [0] * (n + 1), [0] * (n + 1)
            for t, w in enumerate(weights):
                off = t * m
                for j in range(half):
                    sl[off + j] = coeffs[half + j] * w % R_MOD
                    sr[off + half + j] = coeffs[j] * w % R_MOD
            sl[n] = xi_0 * _inner(coeffs[half:], zs[:half]) % R_MOD  # ·H
            sr[n] = xi_0 * _inner(coeffs[:half], zs[half:]) % R_MOD
            transcript.write_ec_point(pk._msm(sl, device))
            transcript.write_ec_point(pk._msm(sr, device))
            xi = transcript.squeeze_challenge()
            xi_inv = pow(xi, -1, R_MOD)
            weights = [v for w in weights for v in (w, w * xi % R_MOD)]
            coeffs = [(cl + xi_inv * cr) % R_MOD for cl, cr in zip(coeffs[:half], coeffs[half:])]
            zs = [(zl + xi * zr) % R_MOD for zl, zr in zip(zs[:half], zs[half:])]
            xis.append(xi)

        u = pk._msm(weights, device)
        transcript.write_ec_point(u)
        transcript.write_scalar(coeffs[0])
        return IpaAccumulator(xis, u)

    @staticmethod
    def read_proof(svk: IpaSuccinctVerifyingKey, transcript) -> dict:
        """The proof reader (the reference's ipa.rs:300-330)."""
        proof = {}
        if svk.zk:
            proof["c_bar"] = transcript.read_ec_point()
            proof["alpha"] = transcript.squeeze_challenge()
            proof["omega_prime"] = transcript.read_scalar()
        proof["xi_0"] = transcript.squeeze_challenge()
        rounds = []
        for _ in range(svk.k):
            l = transcript.read_ec_point()
            r = transcript.read_ec_point()
            xi = transcript.squeeze_challenge()
            rounds.append((l, r, xi))
        proof["rounds"] = rounds
        proof["u"] = transcript.read_ec_point()
        proof["c"] = transcript.read_scalar()
        return proof

    @staticmethod
    def succinct_verify(svk, commitment, z, eval_, proof, L):
        """The succinct check C_k == c·U + v'·H' (the reference's
        ipa.rs:137-180) -> (IpaAccumulator(ξ, U), accept bit(s)).
        commitment: an MSM expression of L; z, eval_: loader scalars."""
        h_prime = L.msm_base_int(svk.h) * proof["xi_0"]
        c_prime = commitment
        if svk.zk:
            c_prime = (c_prime + L.msm_base(proof["c_bar"]) * proof["alpha"]
                       - L.msm_base_int(svk.s) * proof["omega_prime"])
        c_k = c_prime + h_prime * eval_
        xis = [xi for _, _, xi in proof["rounds"]]
        xi_invs = L.batch_inv(xis)
        for (l, r, xi), xi_inv in zip(proof["rounds"], xi_invs):
            c_k = c_k + L.msm_base(l) * xi_inv + L.msm_base(r) * xi
        v_prime = L.mul(h_eval(xis, z, L), proof["c"])
        rhs = L.msm_base(proof["u"]) * proof["c"] + h_prime * v_prime
        return IpaAccumulator(xis, proof["u"]), L.msm_is_identity(c_k - rhs)


class IpaAs:
    """The accumulation scheme: N accumulators folded into one by a fresh
    IPA over their α-combined h polynomials (the reference's
    ipa/accumulation.rs)."""

    @staticmethod
    def create_proof(pk: IpaProvingKey, instances: List[IpaAccumulator], transcript,
                     seed: int = 2, device=None) -> IpaAccumulator:
        """The host prover of the fold of `instances` (host-int
        accumulators); every MSM runs on `device` (None: the card)."""
        if len(instances) < 2:
            raise ValueError("IpaAs folds at least two accumulators")
        rng = np.random.default_rng(seed)
        a_b_u = omega = None
        if pk.zk:
            a, b = _rand_fr(rng), _rand_fr(rng)
            u = pk.commit([b, a], device=device)  # a·G₁ + b·G₀
            transcript.write_scalar(a)
            transcript.write_scalar(b)
            transcript.write_ec_point(u)
            a_b_u = (a, b, u)
            omega = _rand_fr(rng)
            transcript.write_scalar(omega)

        for acc in instances:
            for xi in acc.xi:
                transcript.common_scalar(xi)
            transcript.common_ec_point(acc.u)
        alpha = transcript.squeeze_challenge()
        z = transcript.squeeze_challenge()

        hs = [h_coeffs_int(acc.xi) for acc in instances]
        if a_b_u is not None:
            hs.append([a_b_u[1], a_b_u[0]] + [0] * (pk.n - 2))
        h = [0] * pk.n
        pa = 1
        for hc in hs:
            for i, c in enumerate(hc):
                h[i] = (h[i] + pa * c) % R_MOD
            pa = pa * alpha % R_MOD
        return Ipa.create_proof(pk, h, z, omega, transcript, seed=seed + 1, device=device)

    @staticmethod
    def read_proof(svk, instances: List[IpaAccumulator], transcript, L) -> dict:
        """Each accumulator's ξ and U are absorbed before α (U through
        `L.affine`: the JAX package absorbs X and Y of U with Z = 1)."""
        if len(instances) < 2:
            raise ValueError("IpaAs folds at least two accumulators")
        proof = {}
        if svk.zk:
            proof["a"] = transcript.read_scalar()
            proof["b"] = transcript.read_scalar()
            proof["abu"] = transcript.read_ec_point()
            proof["omega"] = transcript.read_scalar()
        for acc in instances:
            for xi in acc.xi:
                transcript.common_scalar(xi)
            transcript.common_ec_point(L.affine(acc.u))
        proof["alpha"] = transcript.squeeze_challenge()
        proof["z"] = transcript.squeeze_challenge()
        proof["ipa"] = Ipa.read_proof(svk, transcript)
        return proof

    @staticmethod
    def verify(svk, instances: List[IpaAccumulator], proof, L):
        """Fold the U's and h(z)'s with the powers of α, then the fresh IPA's
        succinct check (the reference's ipa/accumulation.rs:47-74).  Each
        accumulator's U is a projective point handle (`L.msm_base_proj`)."""
        us = [L.msm_base_proj(acc.u) for acc in instances]
        hs = [h_eval(acc.xi, proof["z"], L) for acc in instances]
        if svk.zk:
            us.append(L.msm_base(proof["abu"]))
            hs.append(L.add(L.mul(proof["a"], proof["z"]), proof["b"]))
        c, v, pa = L.msm_zero(), None, None  # pa None: alpha^0
        for u, h in zip(us, hs):
            c = c + (u if pa is None else u * pa)
            term = h if pa is None else L.mul(h, pa)
            v = term if v is None else L.add(v, term)
            pa = proof["alpha"] if pa is None else L.mul(pa, proof["alpha"])
        if svk.zk:
            c = c + L.msm_base_int(svk.s) * proof["omega"]
        return Ipa.succinct_verify(svk, c, proof["z"], v, proof["ipa"], L)


# ---------------------------------------------------------------------- decider


def _point_eq(p, q):
    """Projective equality of (3, 8) words, x1·z2 == x2·z1 and y1·z2 ==
    y2·z1, both identities equal, one identity unequal (the JAX package's
    `_point_eq` :114): one `svt_field_mul` and one `svt_field_canon` launch
    on the card."""
    c = FQW.canon(FQW.mul(torch.stack([p[0], q[0], p[1], q[1]]),
                          torch.stack([q[2], p[2], q[2], p[2]])))
    inf_p, inf_q = cuda_ops.is_identity(p), cuda_ops.is_identity(q)
    eq = (c[0] == c[1]).all(-1) & (c[2] == c[3]).all(-1)
    return torch.where(inf_p & inf_q, torch.ones_like(eq), eq & ~inf_p & ~inf_q)


def decide(dk: IpaDecidingKey, acc: IpaAccumulator, device=None):
    """U == ⟨h(ξ), G⟩ (the reference's ipa/decider.rs:47-55) -> a 0-dim bool
    tensor: h's 2^k canonical scalars from one `svt_ipa_h_coeffs` launch,
    one 2^k-point `msm` over `dk.g_dev`, the projective comparison, and the
    MSM's bucket-overflow flag: the JAX package's `_point_eq(...) & ~ovf`.
    Host-int accumulators are uploaded to `device` (None: the CUDA card);
    word accumulators run where their words are."""
    if isinstance(acc.u, tuple) or acc.u is None:
        dev = resolve_device(device)
        xi = torch.from_numpy(_mont_words(acc.xi)).to(dev)
        u = _affine_int_words(acc.u, dev)
    else:
        xi = acc.xi if isinstance(acc.xi, torch.Tensor) else torch.stack(list(acc.xi))
        u, dev = acc.u, acc.u.device
        if u.shape[-2] == 2:
            u = torch.cat([u, FQW.const("ONE", dev)[None]], 0)
    if xi.shape[0] != dk.svk.k:
        raise ValueError(f"decide: {xi.shape[0]} challenges for a key of k = {dk.svk.k}")
    coeffs = cuda_ops.h_coeffs(xi.contiguous())
    out, ovf = msm(dk.g_dev(dev), coeffs, device=dev)
    return _point_eq(limbs_to_words(out), u) & ~ovf


def decide_all(dk: IpaDecidingKey, accs: List[IpaAccumulator], device=None):
    """(n,) bool: `decide` of each accumulator."""
    return torch.stack([decide(dk, a, device) for a in accs])
