"""BGH19 multi-open for the IPA PCS: the counterpart of the JAX package's
`pcs/ipa/bgh19.py` (the reference's pcs/ipa/multiopen/bgh19.rs, the
halo2_proofs IPA multiopen), written once against a loader as
`pcs/ipa/ipa.py` is.

The verifier groups the queries into shift-sets (`bdfg_query_sets`, the
grouping SHPLONK shares), computes each set's barycentric coefficients
with the two-phase batched inversion (bgh19.rs:205-231, 289-345), combines
the commitments and evaluations with the powers of x₁, x₂ and x₄, and
checks with one IPA succinct verify that the combination opens to 0 at x₃
(bgh19.rs:56-95).  The shifts and the barycentric numerators `nell` are
host ints, as in the JAX package.  The host prover, `Bgh19.open` (the
JAX package's :47), builds the proof from the verification identity:
q_i = Σ x₁^t p_t, r_i the interpolation of q_i on the set's points,
f = Σ x₂^i (q_i − r_i)/Π(X − z_ij); its commitment and its trailing IPA's
MSMs run on the card (device None) or by `py_ec.msm` (device "cpu").
"""

from __future__ import annotations

from typing import List

from ...ff.spec import FR
from ...utils import py_poly
from ..kzg.multiopen import Query, bdfg_query_sets
from .ipa import Ipa, IpaProvingKey

R_MOD = FR.p

# The shift-set grouping is SHPLONK's (bgh19.rs:159-202).
query_sets = bdfg_query_sets

__all__ = ["Bgh19", "Query", "query_sets"]


class Bgh19:
    @staticmethod
    def open(pk: IpaProvingKey, polys: List[List[int]], queries: List[Query], x: int,
             transcript, seed: int = 7, device=None):
        """The host prover: the queries carry host-int evals and shifts.
        Writes the multiopen proof and its trailing IPA to `transcript` and
        returns the IPA's host-int accumulator."""
        sets = bdfg_query_sets(queries)
        x_1 = transcript.squeeze_challenge()
        x_2 = transcript.squeeze_challenge()

        # q_i(X) = Σ_t x_1^t · p_{i, rev(t)}   (bgh19.rs's msm() reverses)
        qs = []
        for _, pids, _ in sets:
            q, pw = [0], 1
            for pid in reversed(pids):
                q = py_poly.padd(q, py_poly.pscale(polys[pid], pw))
                pw = pw * x_1 % R_MOD
            qs.append(q)

        # f(X) = Σ_i x_2^i · (q_{n-1-i} - r_{n-1-i}) / Π_j (X - z_ij)
        f_poly, pw = [0], 1
        for i in range(len(sets) - 1, -1, -1):
            zs = [sh * x % R_MOD for sh in sets[i][0]]
            q = qs[i]
            num = py_poly.psub(q, py_poly.lagrange_interpolate(
                [(z, py_poly.peval(q, z)) for z in zs]))
            for z in zs:
                num = py_poly.pdiv_linear(num, z)
            f_poly = py_poly.padd(f_poly, py_poly.pscale(num, pw))
            pw = pw * x_2 % R_MOD

        transcript.write_ec_point(pk.commit(f_poly, device=device))
        x_3 = transcript.squeeze_challenge()
        q_evals = [py_poly.peval(q, x_3) for q in qs]
        for qe in q_evals:
            transcript.write_scalar(qe)
        x_4 = transcript.squeeze_challenge()

        # the final polynomial: x_4^n (f - f(x_3)) + Σ_i x_4^{n-1-i} (q_i - q_i(x_3));
        # each constant is a coefficient-0 adjustment (G_0 is the constant basis)
        final = [0]
        items = [(f_poly, py_poly.peval(f_poly, x_3))] + list(zip(qs, q_evals))
        for (poly, ev), k in zip(items, range(len(sets), -1, -1)):
            adj = list(poly) or [0]
            adj[0] = (adj[0] - ev) % R_MOD
            final = py_poly.padd(final, py_poly.pscale(adj, pow(x_4, k, R_MOD)))
        return Ipa.create_proof(pk, final, x_3, None, transcript, seed=seed, device=device)

    @staticmethod
    def read_proof(svk, queries: List[Query], transcript) -> dict:
        proof = {}
        proof["x_1"] = transcript.squeeze_challenge()
        proof["x_2"] = transcript.squeeze_challenge()
        proof["f"] = transcript.read_ec_point()
        proof["x_3"] = transcript.squeeze_challenge()
        proof["q_evals"] = transcript.read_n_scalars(len(bdfg_query_sets(queries)))
        proof["x_4"] = transcript.squeeze_challenge()
        proof["ipa"] = Ipa.read_proof(svk, transcript)
        return proof

    @staticmethod
    def verify(svk, commitments: List, x, queries: List[Query], proof, L):
        """-> (IpaAccumulator, accept bit(s)).  commitments: MSM expressions
        of L; x the opening point and each query's eval loader scalars."""
        sets = bdfg_query_sets(queries)
        x_3 = proof["x_3"]

        # ---- per-set coefficients (two-phase batched inversion)
        max_k = max(max(len(s[0]) for s in sets), 2)
        pow_x = L.powers(x, max_k)
        shift_superset = sorted({sh for s in sets for sh in s[0]})
        x3_minus = {sh: L.sub(x_3, L.mul(L.scalar(sh), x)) for sh in shift_superset}

        set_data = []
        for shifts, pids, evals in sets:
            k = len(shifts)
            nell = []
            for j, sj in enumerate(shifts):
                acc = 1
                for i2, si in enumerate(shifts):
                    if i2 != j:
                        acc = acc * (sj - si) % R_MOD
                nell.append(acc)
            xk1 = pow_x[k - 1]
            denoms = [
                L.add(L.mul(L.mul(L.scalar(nell[j]), xk1), x_3),
                      L.neg(L.mul(L.mul(L.scalar(nell[j] * shifts[j] % R_MOD), xk1), x)))
                for j in range(k)
            ]
            fden = x3_minus[shifts[0]]
            for sh in shifts[1:]:
                fden = L.mul(fden, x3_minus[sh])
            set_data.append({"pids": pids, "evals": evals, "denoms": denoms, "fden": fden})

        flat = []
        for sd in set_data:
            flat.extend(sd["denoms"])
            flat.append(sd["fden"])
        inv_flat = L.batch_inv(flat)
        i = 0
        for sd in set_data:
            k = len(sd["denoms"])
            sd["weights"] = inv_flat[i : i + k]
            sd["f_coeff"] = inv_flat[i + k]
            i += k + 1
        sums = []
        for sd in set_data:
            acc = sd["weights"][0]
            for w in sd["weights"][1:]:
                acc = L.add(acc, w)
            sums.append(acc)
        for sd, inv_sum in zip(set_data, L.batch_inv(sums)):
            sd["r_coeff"] = inv_sum

        # ---- f_eval = Σ_i x₂^i · f_evals[rev i]
        max_polys = max(len(sd["pids"]) for sd in set_data)
        pow_x1 = L.powers(proof["x_1"], max_polys)
        pow_x2 = L.powers(proof["x_2"], len(set_data))

        f_evals = []
        for sd, q_eval in zip(set_data, proof["q_evals"]):
            r_evals = []
            for evs in sd["evals"]:
                acc = L.mul(sd["weights"][0], evs[0])
                for w, ev in zip(sd["weights"][1:], evs[1:]):
                    acc = L.add(acc, L.mul(w, ev))
                r_evals.append(L.mul(acc, sd["r_coeff"]))
            r_eval = None
            for rv, p1 in zip(reversed(r_evals), pow_x1):
                term = L.mul(rv, p1)
                r_eval = term if r_eval is None else L.add(r_eval, term)
            f_evals.append(L.mul(L.sub(q_eval, r_eval), sd["f_coeff"]))
        f_eval = None
        for p2, fe in zip(pow_x2, reversed(f_evals)):
            term = L.mul(p2, fe)
            f_eval = term if f_eval is None else L.add(f_eval, term)

        # ---- the combined commitment P (constants fold onto the G₀ basis)
        items = [L.msm_base(proof["f"]) - L.msm_constant(f_eval)]
        for sd, q_eval in zip(set_data, proof["q_evals"]):
            msm = L.msm_zero()
            for pid, p1 in zip(reversed(sd["pids"]), pow_x1):
                msm = msm + commitments[pid] * p1
            items.append(msm - L.msm_constant(q_eval))
        pow_x4 = L.powers(proof["x_4"], len(items))
        p = L.msm_sum([it * p4 for it, p4 in zip(items, reversed(pow_x4))])
        bases_only, const = p.split()
        if const is not None:
            bases_only = bases_only + L.msm_base_int(svk.g0) * const
        return Ipa.succinct_verify(svk, bases_only, x_3, L.scalar(0), proof["ipa"], L)
