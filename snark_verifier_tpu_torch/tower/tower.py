"""BN254 extension-field towers in plain PyTorch: the counterpart of the
JAX package's `tower/tower.py`, and the plain version of every tower
function in csrc/tower.cuh.

Layouts (trailing dims of int64 16-bit Montgomery limbs, ff/limb_field.py;
leading dims broadcast):
  Fq2  : (..., 2, 16)         c0 + c1·u,  u² = -1
  Fq6  : (..., 3, 2, 16)      c0 + c1·v + c2·v²,  v³ = ξ = 9+u
  Fq12 : (..., 2, 3, 2, 16)   c0 + c1·w,  w² = v

Every formula is the JAX package's, op for op: the independent base-field
products of a level are stacked into one `LimbField.mul` call, and adds and
subs keep the lazy [0, 2p] contract, so this tower, the JAX one and the
kernels' agree on values (and, where their schedules match, limb for limb).
"""

from __future__ import annotations

import torch

from ..ff import FQ_FIELD

F = FQ_FIELD


def _stk(*xs):
    return torch.stack(torch.broadcast_tensors(*xs), 0)


class Fq2Field:
    def one(self, device):
        return torch.stack([F.const("ONE", device), torch.zeros_like(F.const("ONE", device))], 0)

    def zero(self, device):
        return torch.zeros((2, 16), dtype=torch.int64, device=device)

    @staticmethod
    def make(c0, c1):
        return torch.stack(torch.broadcast_tensors(c0, c1), dim=-2)

    def add(self, a, b):
        return F.add(a, b)

    def sub(self, a, b):
        return F.sub(a, b)

    def neg(self, a):
        return F.neg(a)

    def mul(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        m = F.mul(_stk(a0, a1, F.add(a0, a1)), _stk(b0, b1, F.add(b0, b1)))
        t0, t1, t2 = m[0], m[1], m[2]
        return self.make(F.sub(t0, t1), F.sub(t2, F.add(t0, t1)))

    def square(self, a):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        m = F.mul(_stk(F.add(a0, a1), a0), _stk(F.sub(a0, a1), a1))
        return self.make(m[0], F.double(m[1]))

    def smul(self, a, s):
        """Scale both components by an Fq element s (..., 16)."""
        return F.mul(a, s[..., None, :])

    def conj(self, a):
        return self.make(a[..., 0, :], F.neg(a[..., 1, :]))

    def mul_xi(self, a):
        """a · (9 + u)."""
        a0, a1 = a[..., 0, :], a[..., 1, :]
        return self.make(F.sub(F.mul_small(a0, 9), a1), F.add(a0, F.mul_small(a1, 9)))

    def inv(self, a):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        m = F.mul(_stk(a0, a1), _stk(a0, a1))
        d = F.inv(F.add(m[0], m[1]))
        m2 = F.mul(_stk(a0, F.neg(a1)), d[None])
        return self.make(m2[0], m2[1])



class Fq6Field:
    def __init__(self, f2: Fq2Field):
        self.f2 = f2

    def one(self, device):
        z = self.f2.zero(device)
        return torch.stack([self.f2.one(device), z, z], 0)

    def zero(self, device):
        return torch.zeros((3, 2, 16), dtype=torch.int64, device=device)

    @staticmethod
    def make(c0, c1, c2):
        return torch.stack(torch.broadcast_tensors(c0, c1, c2), dim=-3)

    @staticmethod
    def _c(a):
        return a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]

    def add(self, a, b):
        return F.add(a, b)

    def sub(self, a, b):
        return F.sub(a, b)

    def neg(self, a):
        return F.neg(a)

    def mul(self, a, b):
        f2 = self.f2
        a, b = torch.broadcast_tensors(a, b)
        a0, a1, a2 = self._c(a)
        b0, b1, b2 = self._c(b)
        m = f2.mul(
            _stk(a0, a1, a2, f2.add(a1, a2), f2.add(a0, a1), f2.add(a0, a2)),
            _stk(b0, b1, b2, f2.add(b1, b2), f2.add(b0, b1), f2.add(b0, b2)),
        )
        t0, t1, t2, s12, s01, s02 = m[0], m[1], m[2], m[3], m[4], m[5]
        c0 = f2.add(t0, f2.mul_xi(f2.sub(s12, f2.add(t1, t2))))
        c1 = f2.add(f2.sub(s01, f2.add(t0, t1)), f2.mul_xi(t2))
        c2 = f2.add(f2.sub(s02, f2.add(t0, t2)), t1)
        return self.make(c0, c1, c2)

    def square(self, a):
        return self.mul(a, a)

    def mul_by_v(self, a):
        a0, a1, a2 = self._c(a)
        return self.make(self.f2.mul_xi(a2), a0, a1)

    def inv(self, a):
        f2 = self.f2
        a0, a1, a2 = self._c(a)
        sq = f2.mul(_stk(a0, a1, a2), _stk(a0, a1, a2))
        m1 = f2.mul(_stk(a1, a0, a0), _stk(a2, a1, a2))
        c0 = f2.sub(sq[0], f2.mul_xi(m1[0]))
        c1 = f2.sub(f2.mul_xi(sq[2]), m1[1])
        c2 = f2.sub(sq[1], m1[2])
        m2 = f2.mul(_stk(a2, a1, a0), _stk(c1, c2, c0))
        t = f2.add(f2.mul_xi(f2.add(m2[0], m2[1])), m2[2])
        ti = f2.inv(t)
        m3 = f2.mul(_stk(c0, c1, c2), ti[None])
        return self.make(m3[0], m3[1], m3[2])



class Fq12Field:
    def __init__(self, f6: Fq6Field):
        self.f6 = f6
        self.f2 = f6.f2

    def one(self, device):
        return torch.stack([self.f6.one(device), self.f6.zero(device)], 0)

    @staticmethod
    def make(c0, c1):
        return torch.stack(torch.broadcast_tensors(c0, c1), dim=-4)

    @staticmethod
    def _c(a):
        return a[..., 0, :, :, :], a[..., 1, :, :, :]

    def mul(self, a, b):
        f6 = self.f6
        a, b = torch.broadcast_tensors(a, b)
        a0, a1 = self._c(a)
        b0, b1 = self._c(b)
        m = f6.mul(_stk(a0, a1, f6.add(a0, a1)), _stk(b0, b1, f6.add(b0, b1)))
        t0, t1, t2 = m[0], m[1], m[2]
        c0 = f6.add(t0, f6.mul_by_v(t1))
        c1 = f6.sub(t2, f6.add(t0, t1))
        return self.make(c0, c1)

    def square(self, a):
        return self.mul(a, a)

    def conj(self, a):
        a0, a1 = self._c(a)
        return self.make(a0, self.f6.neg(a1))

    def inv(self, a):
        f6 = self.f6
        a0, a1 = self._c(a)
        sq = f6.mul(_stk(a0, a1), _stk(a0, a1))
        t = f6.inv(f6.sub(sq[0], f6.mul_by_v(sq[1])))
        m = f6.mul(_stk(a0, f6.neg(a1)), t[None])
        return self.make(m[0], m[1])

    def mul_by_034(self, f, c0, c3, c4):
        """f · (c0 + c3·w + c4·v·w) with c0, c3, c4 in Fq2: the sparse line
        product, by the generic multiply on the sparse operand (as the JAX
        package)."""
        z = torch.zeros_like(c0)
        a = self.f6.make(c0, z, z)
        b = self.f6.make(c3, c4, torch.zeros_like(c3))
        return self.mul(f, self.make(a, b))

    # The least formulas of the pairing kernels (csrc/tower_team.cuh), each
    # the same field element as the JAX-mirroring function above it; every
    # level's independent Fq2 products are stacked into one call.

    def square_complex(self, a):
        """a² in the complex form over Fq6 (w² = v): t = a0·a1 and
        u = (a0 + a1)(a0 + v·a1), then a² = (u − t − v·t) + 2t·w.  Two Fq6
        products: 12 Fq2 products, 36 Fq multiplies (`square` takes 54)."""
        f6 = self.f6
        a0, a1 = self._c(a)
        m = f6.mul(_stk(a0, f6.add(a0, a1)), _stk(a1, f6.add(a0, f6.mul_by_v(a1))))
        t, u = m[0], m[1]
        return self.make(f6.sub(f6.sub(u, t), f6.mul_by_v(t)), f6.add(t, t))

    def mul_by_034_sparse(self, f, c0, c3, c4):
        """f · (c0 + c3·w + c4·v·w) in 13 Fq2 products, 39 Fq multiplies
        (`mul_by_034` takes 54): Karatsuba over Fq6 with the line's halves
        l0 = c0 and l1 = c3 + c4·v, so t0 = f0·c0 takes 3 products and
        t1 = f1·l1, t2 = (f0 + f1)(l0 + l1) take 5 each (Fq6 times
        b0 + b1·v); then c0 = t0 + v·t1, c1 = t2 − t0 − t1."""
        f2, f6 = self.f2, self.f6
        c0, c3, c4 = torch.broadcast_tensors(c0, c3, c4)
        f0, f1 = self._c(f)
        s = f6.add(f0, f1)
        x = lambda a, i: a[..., i, :, :]
        lefts = [x(f0, 0), x(f0, 1), x(f0, 2)]
        rights = [c0, c0, c0]
        for a, b0, b1 in ((f1, c3, c4), (s, f2.add(c0, c3), c4)):
            lefts += [x(a, 0), x(a, 1), f2.add(x(a, 1), x(a, 2)), f2.add(x(a, 0), x(a, 2)),
                      f2.add(x(a, 0), x(a, 1))]
            rights += [b0, b1, b1, b0, f2.add(b0, b1)]
        m = f2.mul(_stk(*lefts), _stk(*rights))

        def by01(k):  # a·(b0 + b1 v) = (a0b0 + ξ a2b1, a0b1 + a1b0, a1b1 + a2b0)
            aa, bb, s12, s02, s01 = (m[k + i] for i in range(5))
            return f6.make(f2.add(aa, f2.mul_xi(f2.sub(s12, bb))),
                           f2.sub(s01, f2.add(aa, bb)), f2.add(f2.sub(s02, aa), bb))

        t0, t1, t2 = f6.make(m[0], m[1], m[2]), by01(3), by01(8)
        return self.make(f6.add(t0, f6.mul_by_v(t1)), f6.sub(t2, f6.add(t0, t1)))

    def cyclotomic_square(self, a):
        """a² for a in the cyclotomic subgroup (a^(p⁴ − p² + 1) = 1), by
        Granger–Scott: Fq12 = Fq4³ with Fq4 = Fq2[w³]/(w⁶ − ξ), whose pairs
        are the coordinates (c0.c0, c1.c1), (c1.c0, c0.c2) and (c0.c1,
        c1.c2).  Each pair (x, y) squares to (x² + ξy², (x + y)² − x² − y²):
        nine Fq2 squares, 18 Fq multiplies; then each coordinate is 3t − 2r
        or 3t + 2r of its t and its own input r.  Outside the subgroup it is
        not the square; it maps 0 to 0."""
        f2 = self.f2
        g = [a[..., i, j, :, :] for i in range(2) for j in range(3)]
        pairs = ((g[0], g[4]), (g[3], g[2]), (g[1], g[5]))
        sq = f2.square(_stk(*(v for x, y in pairs for v in (x, y, f2.add(x, y)))))
        even = [f2.add(sq[3 * k], f2.mul_xi(sq[3 * k + 1])) for k in range(3)]
        odd = [f2.sub(sq[3 * k + 2], f2.add(sq[3 * k], sq[3 * k + 1])) for k in range(3)]

        def minus(t, r):  # 3t − 2r
            d = f2.sub(t, r)
            return f2.add(f2.add(d, d), t)

        def plus(t, r):  # 3t + 2r
            d = f2.add(t, r)
            return f2.add(f2.add(d, d), t)

        z = [minus(even[0], g[0]), minus(even[1], g[1]), minus(even[2], g[2]),
             plus(f2.mul_xi(odd[2]), g[3]), plus(odd[0], g[4]), plus(odd[1], g[5])]
        return self.make(self.f6.make(*z[:3]), self.f6.make(*z[3:]))

    def is_one(self, a):
        one = self.one(a.device).expand(a.shape)
        return (F.canon(a) == one).flatten(-4).all(-1)

    @staticmethod
    def select(c, a, b):
        return torch.where(c[..., None, None, None, None], a, b)


FQ2 = Fq2Field()
FQ6 = Fq6Field(FQ2)
FQ12 = Fq12Field(FQ6)
