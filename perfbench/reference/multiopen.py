"""The KZG multi-open verifiers GWC19 and BDFG21 (SHPLONK), loader-generic:
a frozen copy of the port's `pcs/kzg/multiopen.py`, the reference's
gwc19.rs and bdfg21.rs.

  * GWC19 (the reference's gwc19.rs): accumulator lhs = f + Σᵢ uⁱ·(z·ωᵢ)·Wᵢ,
    rhs = Σᵢ uⁱ·Wᵢ with f = Σᵢ uⁱ Σⱼ vʲ (Cᵢⱼ − evalᵢⱼ·G); queries grouped by
    shift, one opening point Wᵢ per set.
  * BDFG21 (bdfg21.rs): accumulator lhs = f + z'·W', rhs = W' with
    f = Σₛ γˢ·msmₛ − Z_{s₁}(z')·W; queries grouped by shift-set,
    barycentric per-set coefficients with a two-phase batched inversion.

Query shifts are host ints (rotations are protocol constants); scalars and
MSM expressions are the loader's handles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

from .fields import FR


@dataclass
class Query:
    poly: int
    shift: int  # host int (rotation ω^k), canonical value mod r
    eval: Any = None  # loader scalar once loaded


def gwc_query_sets(queries: List[Query]):
    """Group queries by shift -> [(shift, [poly], [eval])] (gwc19.rs:140-158)."""
    sets = []
    for q in queries:
        for s in sets:
            if s[0] == q.shift:
                s[1].append(q.poly)
                s[2].append(q.eval)
                break
        else:
            sets.append((q.shift, [q.poly], [q.eval]))
    return sets


class Gwc19:
    """One opening point Wᵢ read per query set."""

    @staticmethod
    def read_proof(queries: List[Query], transcript):
        v = transcript.squeeze_challenge()
        ws = transcript.read_n_ec_points(len(gwc_query_sets(queries)))
        u = transcript.squeeze_challenge()
        return {"v": v, "ws": ws, "u": u}

    @staticmethod
    def verify(g, commitments: List, z, queries: List[Query], proof, L):
        """g: the loader's generator handle; z: a loader scalar -> (lhs, rhs)."""
        sets = gwc_query_sets(queries)
        pow_u = L.powers(proof["u"], len(sets))
        pow_v = L.powers(proof["v"], max(len(s[1]) for s in sets))

        f = L.msm_zero()
        for (_, polys, evals), pu in zip(sets, pow_u):
            inner = L.msm_zero()
            for (poly, ev), pv in zip(zip(polys, evals), pow_v):
                inner = inner + (commitments[poly] - L.msm_constant(ev)) * pv
            f = f + inner * pu

        rhs_expr, lhs_expr = L.msm_zero(), f
        for (shift, _, _), pu, w in zip(sets, pow_u, proof["ws"]):
            uw = L.msm_base(w) * pu
            rhs_expr = rhs_expr + uw
            lhs_expr = lhs_expr + uw * L.mul(L.scalar(shift), z)
        return L.msm_evaluate(lhs_expr, g), L.msm_evaluate(rhs_expr, g)


def bdfg_query_sets(queries: List[Query]):
    """Group queries into sets of polys sharing the same shift-set.

    Returns list of (shifts, polys, evals) with evals[i][j] the eval of
    polys[i] at shifts[j] (bdfg21.rs:117-167)."""
    poly_shifts = []  # (poly, [shift], [eval])
    for q in queries:
        for ps in poly_shifts:
            if ps[0] == q.poly:
                if q.shift not in ps[1]:
                    ps[1].append(q.shift)
                    ps[2].append(q.eval)
                break
        else:
            poly_shifts.append((q.poly, [q.shift], [q.eval]))

    sets = []  # (shifts, [poly], [[eval]])
    for poly, shifts, evals in poly_shifts:
        for s in sets:
            if set(s[0]) == set(shifts):
                if poly not in s[1]:
                    s[1].append(poly)
                    s[2].append([evals[shifts.index(sh)] for sh in s[0]])
                break
        else:
            sets.append((shifts, [poly], [evals]))
    return sets


class Bdfg21:
    @staticmethod
    def read_proof(queries: List[Query], transcript):
        mu = transcript.squeeze_challenge()
        gamma = transcript.squeeze_challenge()
        w = transcript.read_ec_point()
        z_prime = transcript.squeeze_challenge()
        w_prime = transcript.read_ec_point()
        return {"mu": mu, "gamma": gamma, "w": w, "z_prime": z_prime, "w_prime": w_prime}

    @staticmethod
    def verify(g, commitments: List, z, queries: List[Query], proof, L):
        sets = bdfg_query_sets(queries)
        z_prime = proof["z_prime"]
        mu, gamma = proof["mu"], proof["gamma"]
        r_mod = FR.p

        max_deg = max(max(len(s[0]) for s in sets), 2)
        pow_z = L.powers(z, max_deg)

        # z' − ωᵢ·z per distinct shift
        shift_superset = sorted({sh for s in sets for sh in s[0]})
        zp_minus = {sh: L.sub(z_prime, L.mul(L.scalar(sh), z)) for sh in shift_superset}

        # ---- per-set coefficient setup (fractions kept as (numer, denom))
        set_data = []
        z_s_1 = None
        for shifts, polys, evals in sets:
            k = len(shifts)
            # normalized_ell'_j = Π_{i≠j} (s_j − s_i)  (host ints)
            nell = []
            for j, sj in enumerate(shifts):
                acc = 1
                for i, si in enumerate(shifts):
                    if i != j:
                        acc = acc * (sj - si) % r_mod
                nell.append(acc)
            zk1 = pow_z[k - 1]
            # barycentric denominators: nell_j · z^{k−1} · (z' − s_j z)
            denoms = [
                L.add(
                    L.mul(L.mul(L.scalar(nell[j]), zk1), z_prime),
                    L.neg(L.mul(L.mul(L.scalar(nell[j] * shifts[j] % r_mod), zk1), z)),
                )
                for j in range(k)
            ]
            # z_s = Π_j (z' − s_j·z)
            zs = zp_minus[shifts[0]]
            for sh in shifts[1:]:
                zs = L.mul(zs, zp_minus[sh])
            if z_s_1 is None:
                z_s_1 = zs
                comm_denom = None  # coefficient 1
            else:
                comm_denom = zs
            set_data.append({"polys": polys, "evals": evals, "denoms": denoms,
                             "comm_denom": comm_denom})

        # ---- phase 1 batched inversion: barycentric + commitment denominators
        flat = []
        for sd in set_data:
            flat.extend(sd["denoms"])
            if sd["comm_denom"] is not None:
                flat.append(sd["comm_denom"])
        inv_flat = L.batch_inv(flat)
        i = 0
        for sd in set_data:
            k = len(sd["denoms"])
            sd["weights"] = inv_flat[i : i + k]
            i += k
            if sd["comm_denom"] is not None:
                sd["comm_coeff"] = L.mul(z_s_1, inv_flat[i])
                i += 1
            else:
                sd["comm_coeff"] = None

        # ---- phase 2: invert the barycentric-weight sums
        sums = []
        for sd in set_data:
            acc = sd["weights"][0]
            for w_ in sd["weights"][1:]:
                acc = L.add(acc, w_)
            sums.append(acc)
        inv_sums = L.batch_inv(sums)
        for sd, inv_sum in zip(set_data, inv_sums):
            cc = sd["comm_coeff"]
            sd["r_eval_coeff"] = inv_sum if cc is None else L.mul(cc, inv_sum)

        # ---- assemble f
        max_polys = max(len(sd["polys"]) for sd in set_data)
        pow_mu = L.powers(mu, max_polys)
        pow_gamma = L.powers(gamma, len(set_data))

        f = L.msm_zero()
        for sd, pg in zip(set_data, pow_gamma):
            msm = L.msm_zero()
            for (poly, evs), pm in zip(zip(sd["polys"], sd["evals"]), pow_mu):
                comm = commitments[poly]
                if sd["comm_coeff"] is not None:
                    comm = comm * sd["comm_coeff"]
                r_eval = L.mul(sd["weights"][0], evs[0])
                for w_, ev in zip(sd["weights"][1:], evs[1:]):
                    r_eval = L.add(r_eval, L.mul(w_, ev))
                r_eval = L.mul(r_eval, sd["r_eval_coeff"])
                msm = msm + (comm - L.msm_constant(r_eval)) * pm
            f = f + msm * pg
        f = f - L.msm_base(proof["w"]) * z_s_1

        rhs_expr = L.msm_base(proof["w_prime"])
        lhs_expr = f + rhs_expr * z_prime
        return L.msm_evaluate(lhs_expr, g), L.msm_evaluate(rhs_expr, g)
