"""The host KZG multi-open provers for GWC19 and BDFG21 (SHPLONK): the
counterpart of the JAX package's `pcs/kzg/prover_py.py`.

Polynomials and evaluations are python ints (`utils/py_poly.py`); each
opening commitment is `srs.commit(..., device)`, one MSM on the card
(device None) or `py_ec.msm` (device "cpu").  The transcript discipline
is the verifiers': the caller has absorbed the commitments and
evaluations, and these functions write the PCS proof stream, with the
challenges squeezed where the verifiers squeeze them.
"""

from __future__ import annotations

from typing import List

from ...ff.spec import FR
from ...utils import py_poly as pp
from .multiopen import Query, bdfg_query_sets, gwc_query_sets

R = FR.p


def gwc_open(srs, polys: List[List[int]], queries: List[Query], z: int, transcript,
             device=None):
    """GWC19: one opening point Wᵢ a query set.  The queries' evals are ints,
    already absorbed."""
    v = transcript.squeeze_challenge()
    for shift, set_polys, _ in gwc_query_sets(queries):
        z_s = z * shift % R
        h: List[int] = []
        pv = 1
        for poly_idx in set_polys:
            f = polys[poly_idx]
            quot = pp.pdiv_linear(pp.psub(f, [pp.peval(f, z_s)]), z_s)
            h = pp.padd(h, pp.pscale(quot, pv))
            pv = pv * v % R
        transcript.write_ec_point(srs.commit(h, device))
    transcript.squeeze_challenge()  # u: the verifier's alone


def shplonk_open(srs, polys: List[List[int]], queries: List[Query], z: int, transcript,
                 device=None):
    """BDFG21 (SHPLONK): W, then W' at the challenge z'."""
    mu = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()
    sets = bdfg_query_sets(queries)

    # r_{s,i}(X): interpolation of (z·shift_j, eval_ij); Z_s(X) = Π (X − z·s_j)
    set_rs: List[List[List[int]]] = []
    set_zs: List[List[int]] = []
    h: List[int] = []
    pg = 1
    for shifts, set_polys, set_evals in sets:
        pts_x = [z * sh % R for sh in shifts]
        z_s_poly = pp.vanishing(pts_x)
        rs = []
        pm = 1
        inner: List[int] = []
        for poly_idx, evals in zip(set_polys, set_evals):
            r_poly = pp.lagrange_interpolate(list(zip(pts_x, evals)))
            rs.append(r_poly)
            inner = pp.padd(inner, pp.pscale(pp.psub(polys[poly_idx], r_poly), pm))
            pm = pm * mu % R
        quot, rem = pp.pdivmod(inner, z_s_poly)
        if rem:
            raise ValueError("shplonk_open: the query evals disagree with the polynomials")
        h = pp.padd(h, pp.pscale(quot, pg))
        set_rs.append(rs)
        set_zs.append(z_s_poly)
        pg = pg * gamma % R
    transcript.write_ec_point(srs.commit(h, device))
    z_prime = transcript.squeeze_challenge()

    # L(X) = Σₛ γˢ (Z_{s₁}(z')/Z_s(z')) Σᵢ μⁱ (fᵢ(X) − r_{s,i}(z')) − Z_{s₁}(z')·h(X)
    zs1_at = pp.peval(set_zs[0], z_prime)
    L: List[int] = []
    pg = 1
    for (_, set_polys, _), rs, z_s_poly in zip(sets, set_rs, set_zs):
        factor = zs1_at * pow(pp.peval(z_s_poly, z_prime), -1, R) % R
        pm = 1
        inner = []
        for poly_idx, r_poly in zip(set_polys, rs):
            inner = pp.padd(inner, pp.pscale(
                pp.psub(polys[poly_idx], [pp.peval(r_poly, z_prime)]), pm))
            pm = pm * mu % R
        L = pp.padd(L, pp.pscale(inner, pg * factor % R))
        pg = pg * gamma % R
    L = pp.psub(L, pp.pscale(h, zs1_at))
    transcript.write_ec_point(srs.commit(pp.pdiv_linear(L, z_prime), device))
