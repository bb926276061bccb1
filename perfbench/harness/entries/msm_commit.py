"""One commitment as one call: `msm.pippenger.msm_checked(bases, scalars)`
over n bases fixed on the device for the whole run, a fresh scalar vector
each call (cycling a few), the result point brought to the host.

The bases are (a + (i + 2^11)·d)·G for i < n, with a and d drawn from the
seed: 2,048 points (a + lo·d)·G and n / 2,048 points ((hi + 1)·2^11·d)·G in
python ints, then base i = the sum of table points lo and hi, one
vectorised projective addition in plain torch on the device
(`g1_torch`).  So the reference needs no MSM: Σ sᵢ·Bᵢ = (a'·Σ sᵢ + d·Σ i·sᵢ)·G
with a' = a + 2^11·d, the sums taken exactly in int64 over the scalars'
16-bit limbs on the device, then one scalar multiplication in python ints."""

from __future__ import annotations

import importlib

import torch

from reference import py_ec
from reference.fields import FR

from .. import codec, g1_torch
from .. import traffic as tr
from . import EntryBase

PROGRAM = "snark_verifier_tpu_torch.msm.pippenger"
LO_BITS = 11
R_LIMBS = torch.tensor([(FR.p >> (16 * i)) & 0xFFFF for i in range(16)], dtype=torch.int64)


def _jac_table(start, step, count):
    """[start + j·step for j < count] as affine points (python ints)."""
    pts, acc, s = [], py_ec._jac(start), py_ec._jac(step)
    for _ in range(count):
        pts.append(py_ec._affine(acc))
        acc = py_ec._jac_add(acc, s)
    return pts


def make_bases(n: int, a: int, d: int, device, chunk: int = 1 << 18):
    """(n, 3, 16) int64 homogeneous projective Montgomery limbs of
    (a + (i + 2^11)·d)·G, i < n (n a multiple of 2,048)."""
    lo_n = 1 << LO_BITS
    if n % lo_n:
        raise ValueError(f"n = {n} is not a multiple of {lo_n}")
    g = py_ec.G1_GEN
    t1 = _jac_table(py_ec.scalar_mul(g, a), py_ec.scalar_mul(g, d), lo_n)
    step = py_ec.scalar_mul(g, (d << LO_BITS) % FR.p)
    t2 = _jac_table(step, step, n // lo_n)
    x1, y1 = (g1_torch.to_mont_limbs([p[c] for p in t1], device) for c in (0, 1))
    x2, y2 = (g1_torch.to_mont_limbs([p[c] for p in t2], device) for c in (0, 1))
    out = torch.empty((n, 3, 16), dtype=torch.int64, device=device)
    for s in range(0, n, chunk):
        i = torch.arange(s, min(n, s + chunk), device=device)
        lo, hi = i & (lo_n - 1), i >> LO_BITS
        X, Y, Z = g1_torch.add_affine_pairs(x1[lo], y1[lo], x2[hi], y2[hi])
        out[s:s + len(i)] = torch.stack([X, Y, Z], 1)
    return out


def make_scalars(n: int, vectors: int, seed: int, device):
    """`vectors` (n, 16) int64 canonical 16-bit limb vectors, uniform in
    [0, r): 254-bit draws from a torch.Generator on the device, those ≥ r
    (compared on their top 64 bits, equality rejected too) drawn again."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    r_top = sum(int(R_LIMBS[12 + j]) << (16 * j) for j in range(4))
    out = []
    for _ in range(vectors):
        got, need = [], n
        while need > 0:
            m = need + need // 3 + 1024
            limbs = torch.randint(0, 1 << 16, (m, 16), generator=gen, device=device,
                                  dtype=torch.int64)
            limbs[:, 15] &= (1 << 14) - 1
            top = limbs[:, 12] | (limbs[:, 13] << 16) | (limbs[:, 14] << 32) | (limbs[:, 15] << 48)
            ok = limbs[top < r_top]
            got.append(ok[:need])
            need -= len(got[-1])
        out.append(torch.cat(got))
    return out


def reference_sum(scalars, a: int, d: int, drop_low_limb: bool = False) -> int:
    """Σ sᵢ·(a + (i + 2^11)·d) mod r from the limbs, exactly (int64 sums of
    limbs and of i·limb: under 2^58); `drop_low_limb` is the control's
    sum, each scalar's low 16 bits dropped."""
    s = scalars[:, 1:] if drop_low_limb else scalars
    first = 1 if drop_low_limb else 0
    idx = torch.arange(s.shape[0], device=s.device, dtype=torch.int64).unsqueeze(1)
    s0 = [int(v) for v in s.sum(0).tolist()]
    s1 = [int(v) for v in (idx * s).sum(0).tolist()]
    S0 = sum(v << (16 * (j + first)) for j, v in enumerate(s0))
    S1 = sum(v << (16 * (j + first)) for j, v in enumerate(s1))
    a2 = (a + (d << LO_BITS)) % FR.p
    return (a2 * S0 + d * S1) % FR.p


class Entry(EntryBase):
    spans = ("snark_verifier_tpu_torch.msm.pippenger:extract_digits",
             "snark_verifier_tpu_torch.msm.pippenger:_slot_indices",
             "snark_verifier_tpu_torch.msm.pippenger:bucket_sums",
             "snark_verifier_tpu_torch.msm.pippenger:bucket_reduce")

    def setup(self):
        run = self.run
        self.program = importlib.import_module(PROGRAM)
        n = int(run.config["n"])
        self.a, self.d = tr.msm_base_params(run.seed, n)
        self.bases = make_bases(n, self.a, self.d, self.device)
        self.scalars = make_scalars(n, int(run.traffic["vectors"]), tr.msm_scalar_seed(run.seed),
                                    self.device)

    @property
    def n_inputs(self) -> int:
        return len(self.scalars)

    def call(self, k):
        return self.program.msm_checked(self.bases, self.scalars[k], device=self.device).cpu().numpy()

    def work(self, k) -> float:
        return float(self.bases.shape[0])

    def free(self):
        self.bases = None
        super().free()

    def expected(self, control: bool = False):
        g = py_ec.G1_GEN
        return [py_ec.scalar_mul(g, reference_sum(s, self.a, self.d, control)) for s in self.scalars]

    def control_answers(self):
        return [codec.encode(pt, 16) for pt in self.expected(control=True)]

    def least_fold_adds(self):
        """Per input: the bucket fold's least group adds over every window of
        c = 8 bits (nonzero digits less nonempty buckets)."""
        from ..work import C_BITS, SCALAR_BITS, fold_least_adds

        out = []
        for s in self.scalars:
            nz = nb = 0
            for w in range(SCALAR_BITS // C_BITS):
                limb, off = divmod(w * C_BITS, 16)
                dig = (s[:, limb] >> off) & ((1 << C_BITS) - 1)
                cnt = torch.bincount(dig, minlength=1 << C_BITS)[1:]
                nz += int(cnt.sum())
                nb += int((cnt > 0).sum())
            out.append(fold_least_adds(nz, nb))
        return out

    def check(self, run):
        want = self.expected()
        wrong = [codec.affine(r.out, 16) != want[r.k] for r in run.records]
        self.failed_calls = sum(wrong)
        run.counts["fold_least_adds"] = self.least_fold_adds()
        self.scalars = None
        return [("results_wrong", sum(wrong), 0)]
