"""The KZG accumulation scheme (KzgAs): the random-linear-combination fold
of deferred-pairing accumulators.  The counterpart of the JAX package's
`pcs/kzg/accumulation.py` (the reference's accumulation.rs: read_proof
:113-137, verify :40-62, create_proof :146-195).

Accumulators are (lhs, rhs) pairs of projective G1 words.  A fold absorbs
every accumulator point's affine coordinates into a Poseidon transcript
(lhs₀, rhs₀, lhs₁, rhs₁, …), optionally reads a ZK blind pair, squeezes r
and returns (Σ rⁱ·lhsᵢ, Σ rⁱ·rhsᵢ).  On the card one fold level is:

  * the affine normalisation of all 2N points and their Fq → Fr map
    (`PoseidonTranscript.absorb_projective_points`: one `svt_points_to_fr`
    launch in projective mode, replacing the JAX package's `G1.to_affine`
    and `fq_to_fr`);
  * the transcript's stacked absorb: 2N + 1 chained permutations in one
    `svt_poseidon_absorb` launch per transcript batch;
  * the weights [1, r, …, r^(N−1)] (`powers`: one `svt_fr_powers` launch,
    csrc/accumulation_kernels.cu, replacing the JAX package's
    `_powers_stack` :196);
  * both sides' weighted sums as one `svt_msm_windowed` launch over a batch
    of 2·groups (`_weighted_msm`, the JAX package's `_weighted_msm` :208
    twice).

`fold_hierarchical` is the JAX package's two-level fold: N accumulators in
groups of g (the largest divisor of N in [2, 32]) folded as one batch of
independent transcripts, then the fold of the group accumulators; N ≤ 32,
or N without such a divisor, folds once.  The group size and the two
levels are part of the transcript's definition.  `create_proof` is the
python-int prover, the port's own oracle.  Each fold call counts 2 MSMs and
2·N terms (N with the blind pair) into `utils.timing.METER`, the JAX
package's rule, once a call.
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

import torch

from ..._build import load_library
from ..._launch import check, launch
from ...ec import py_ec
from ...ff import FQW, FRW
from ...ff.spec import FR
from ...msm import cuda_ops
from ...transcript.poseidon_transcript import PoseidonTranscript
from ...utils.timing import METER, _step

MAX_CHAIN = 32  # the most accumulators one fold transcript absorbs in fold_hierarchical


# ------------------------------------------------------------------ powers


def powers_plain(r, n: int):
    """The plain version of `svt_fr_powers` on any device: r (B, 8) Fr
    Montgomery words -> (B, n, 8) canonical plain words [1, r, …, r^(n−1)],
    the chain of `FRW.plain("mul", ·)` from Montgomery 1, then from_mont
    (the product by plain 1) and canon."""
    acc = FRW.const("ONE", r.device).expand(r.shape)
    chain = [acc]
    for _ in range(n - 1):
        acc = FRW.plain("mul", acc, r)
        chain.append(acc)
    mont = torch.stack(chain, 1)
    return FRW.plain("canon", FRW.plain("mul", mont, FRW.const("ONE_PLAIN", r.device)))


def powers(r, n: int):
    """[1, r, …, r^(n−1)] per transcript: r (B, 8) Fr Montgomery words ->
    (B, n, 8) canonical plain words, laid out as `msm_windowed`'s scalars.
    On a CUDA tensor one launch of `svt_fr_powers`; on a CPU tensor
    `powers_plain`."""
    check("fr_powers", r, 2, (8,))
    if n < 1:
        raise ValueError(f"fr_powers: n = {n}; the powers start at r^0")
    if n >= 1 << 31:
        raise ValueError("fr_powers: more powers than an int32 counts")
    if r.device.type == "cpu":
        return powers_plain(r, n)
    B = r.shape[0]
    out = torch.empty((B, n, 8), dtype=torch.int32, device=r.device)
    if B:
        launch("fr_powers", load_library().svt_fr_powers, r.data_ptr(), n, out.data_ptr(), B,
               device=r.device)
    return out


# ------------------------------------------------------------------ helpers


def _weighted_msm(pairs, weights):
    """pairs (B, N, 2, 3, 8), canonical weights (B, N, 8) -> (Σ wᵢ·lhsᵢ,
    Σ wᵢ·rhsᵢ), each (B, 3, 8): both sides in one `msm_windowed` launch
    over a batch of 2B, lhs rows first."""
    B = pairs.shape[0]
    pts = torch.cat([pairs[:, :, 0], pairs[:, :, 1]], 0).contiguous()
    total = cuda_ops.msm_windowed(pts, torch.cat([weights, weights], 0).contiguous())
    return total[:B], total[B:]


def _to_proj(xy):
    """(B, 2, 8) affine words -> (B, 3, 8) projective with Z = 1."""
    one = FQW.const("ONE", xy.device).expand(*xy.shape[:-2], 1, 8)
    return torch.cat([xy, one], -2)


def fold_transcript(batch: int, device) -> PoseidonTranscript:
    """A fresh fold transcript of `batch` lanes: a Poseidon sponge over empty
    proof streams."""
    return PoseidonTranscript(torch.empty((batch, 0, 8), dtype=torch.int32, device=device),
                              torch.empty((batch, 0, 2, 8), dtype=torch.int32, device=device),
                              device)


class KzgAs:
    # ------------------------------------------------------------- verifier

    @staticmethod
    def read_proof(zk: bool, instances: List[Tuple], transcript):
        """instances: [(lhs, rhs)], each (B, 3, 8) projective, B the
        transcript's batch.  Absorbs every point (one normalisation, one
        stacked absorb), reads the blind pair if `zk`, squeezes r."""
        if not instances:
            raise ValueError("KzgAs.read_proof: no accumulator to fold")
        flat = torch.stack([p for pair in instances for p in pair], 1)  # (B, 2M, 3, 8)
        return KzgAs._read(zk, flat, transcript)

    @staticmethod
    def verify(instances: List[Tuple], proof):
        """The fold of the list (and the blind pair) with powers of r ->
        (lhs, rhs), each (B, 3, 8)."""
        pairs = torch.stack([torch.stack(pair, 1) for pair in instances], 1)  # (B, N, 2, 3, 8)
        return KzgAs.verify_stacked(pairs, proof)

    # ------------------------------------------------ stacked verifier

    @staticmethod
    def read_proof_stacked(zk: bool, pairs, transcript):
        """pairs (B, N, 2, 3, 8) projective, B the transcript's batch: the
        same absorb order as `read_proof` (lhs₀, rhs₀, lhs₁, …)."""
        B, N = pairs.shape[:2]
        return KzgAs._read(zk, pairs.reshape(B, 2 * N, 3, 8), transcript)

    @staticmethod
    def _read(zk: bool, flat, transcript):
        transcript.absorb_projective_points(flat)
        blind = None
        if zk:
            blind = (_to_proj(transcript.read_ec_point()), _to_proj(transcript.read_ec_point()))
        return {"blind": blind, "r": transcript.squeeze_challenge()}

    @staticmethod
    def verify_stacked(pairs, proof):
        """Σ rⁱ·lhsᵢ, Σ rⁱ·rhsᵢ over the (B, N, 2, 3, 8) stack (with the blind
        pair appended) -> (lhs, rhs), each (B, 3, 8)."""
        if proof["blind"] is not None:
            pairs = torch.cat([pairs, torch.stack(proof["blind"], 1)[:, None]], 1)
        METER.count("msm", 2)
        METER.count("msm_terms", 2 * pairs.shape[1])
        return _weighted_msm(pairs, powers(proof["r"].contiguous(), pairs.shape[1]))

    @staticmethod
    def group_size(n: int) -> Optional[int]:
        """fold_hierarchical's group size for n accumulators: the largest
        divisor of n in [2, MAX_CHAIN], or None where n folds once."""
        g = max((d for d in range(2, min(MAX_CHAIN, n - 1) + 1) if n % d == 0), default=None)
        return None if g is None or n <= MAX_CHAIN else g

    @staticmethod
    def fold_hierarchical(pairs, timings: Optional[dict] = None):
        """The two-level fold of (N, 2, 3, 8) accumulators -> (lhs, rhs),
        each (3, 8).  Groups of `group_size(N)` consecutive accumulators fold
        as one batch of independent transcripts, then one transcript folds
        the group accumulators.  Each level is a span, "svt::fold.groups"
        then "svt::fold.top" ("svt::fold.top" alone where N folds once);
        `timings`, when given, gets their host seconds under `fold_groups_s`
        and `fold_top_s`, each between two synchronizes of the pairs'
        device."""
        N = pairs.shape[0]
        g = KzgAs.group_size(N)
        if g is not None:
            lhs, rhs = _step("fold.groups",
                             lambda: KzgAs._fold_once(pairs.reshape(N // g, g, 2, 3, 8)),
                             timings, "fold_groups_s", pairs.device)
            pairs = torch.stack([lhs, rhs], 1)
        lhs, rhs = _step("fold.top", lambda: KzgAs._fold_once(pairs[None]), timings,
                         "fold_top_s", pairs.device)
        return lhs[0], rhs[0]

    @staticmethod
    def _fold_once(pairs):
        """One stacked fold level, a fresh transcript per lane, no blind:
        pairs (G, N, 2, 3, 8) -> (lhs, rhs), each (G, 3, 8); the read of the
        proof ("svt::fold.read") and the weighted MSM ("svt::fold.verify")
        each a span."""
        proof = _step("fold.read", lambda: KzgAs.read_proof_stacked(
            False, pairs, fold_transcript(pairs.shape[0], pairs.device)))
        return _step("fold.verify", lambda: KzgAs.verify_stacked(pairs, proof))

    # --------------------------------------------------------------- prover

    @staticmethod
    def create_proof(pk_blind, instances: List[Tuple], transcript, rng=None):
        """The python-int prover: instances [(lhs, rhs)] affine int tuples;
        pk_blind None or (g, s_g) for the ZK blind pair.  -> the folded
        (lhs, rhs) affine int accumulator."""
        if not instances:
            raise ValueError("KzgAs.create_proof: no accumulator to fold")
        for lhs, rhs in instances:
            transcript.common_ec_point(lhs)
            transcript.common_ec_point(rhs)
        pairs = list(instances)
        if pk_blind is not None:
            s = (rng or random.Random(0)).randrange(1, FR.p)
            g, s_g = pk_blind
            blind = (py_ec.scalar_mul(s_g, s), py_ec.scalar_mul(g, s))
            transcript.write_ec_point(blind[0])
            transcript.write_ec_point(blind[1])
            pairs.append(blind)
        r = transcript.squeeze_challenge()
        lhs = rhs = None
        pr = 1
        for l, rh in pairs:
            lhs = py_ec.add(lhs, py_ec.scalar_mul(l, pr))
            rhs = py_ec.add(rhs, py_ec.scalar_mul(rh, pr))
            pr = pr * r % FR.p
        return lhs, rhs
