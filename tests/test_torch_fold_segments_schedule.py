"""The dense fold kernel `svt_fold_segments` (csrc/fold_kernels.cu) on the
CPU: a schedule twin of the kernel, and the wrapper's choice of team.

No CUDA compiler runs here, so the kernel's algorithm is proven on its
twin: the same team of T lanes per output slot, lane t chaining the slot's
members t, t + T, ... (its first member loaded, not added), members at or
past the matrix's real width skipped, then log2 T rounds of the xor
butterfly from mask T/2 down to 1, a round adding only where both partners
hold a sum; lane 0's sum is the slot's.  The lanes are a batch axis and a
shuffle an index permutation.  The twin is held against

* `fold_segments_plain` (the wrapper on CPU tensors) and a python-int
  oracle, for every team size and the three groupings, on widths that do
  and do not tile the grouping;
* the JAX package's Pallas folds (`_pallas_fold_level`,
  `_pallas_fold_halving`, `_pallas_fold_grid`) in interpret mode, on
  matrices the Pallas side pads with identity rows as its walks do.

The card tests (tests/test_torch_gpu.py) hold the kernel to the plain
version at every team size.  Tolerance: exact, points in affine form (the
orders of summation differ, so projective words may)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_verifier_tpu.ec import from_affine_int as j_from_affine
from snark_verifier_tpu.ec import to_affine_int as j_to_affine
from snark_verifier_tpu.ec.rns_g1 import FQ_RNS, to_rns
from snark_verifier_tpu.msm import pallas_ops as po
from snark_verifier_tpu_torch.ec import G1, from_affine_int, limbs_to_words, py_ec
from snark_verifier_tpu_torch.ec import to_affine_int, words_to_limbs
from snark_verifier_tpu_torch.msm import cuda_ops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- the kernel's schedule


def fold_segments_schedule(mat, G, CW, S, count, width, team):
    """svt_fold_segments' team schedule in plain torch: (nb, w, 3, 8) words
    -> (nb, width / count, 3, 8)."""
    nb, w = mat.shape[:2]
    wout = width // count
    j = torch.arange(wout)
    first = (j // G) * CW + j % G
    n_real = torch.where(first < w, torch.clamp(-(-(w - first) // S), max=count), 0)
    lane = torch.arange(team)
    pts = words_to_limbs(mat)
    acc = G1.infinity((nb, wout, team))
    has = lane[None, :] < n_real[:, None]  # (wout, team)
    for step in range(-(-count // team)):
        k = lane[None, :] + step * team
        live = k < n_real[:, None]
        p = pts[:, (first[:, None] + k * S).clamp(max=w - 1)]
        acc = torch.where(live[None, ..., None, None], p if step == 0 else G1.add(acc, p), acc)
    m = team >> 1
    while m:
        partner = lane ^ m
        q, qhas = acc[:, :, partner], has[:, partner]
        both = (has & qhas)[None, ..., None, None]
        only_q = (qhas & ~has)[None, ..., None, None]
        acc = torch.where(both, G1.add(acc, q), torch.where(only_q, q, acc))
        has = has | qhas
        m >>= 1
    return limbs_to_words(acc[:, :, 0].contiguous())


# ----------------------------------------------------------------- inputs

GROUPINGS = {
    "level": lambda w: cuda_ops.level_grouping(w, 8),
    "halving": lambda w: cuda_ops.halving_grouping(w, 4),
    "grid": lambda w: cuda_ops.grid_grouping(w, 32, 3),
}
# widths that tile each grouping, and widths read as padded with identities
WIDTHS = {"level": (64, 45), "halving": (96, 41), "grid": (96, 77)}


def _multiples(nb, w, seed):
    """(nb, w) cells of c·G, c in 0..5 (0: the identity): the words and the
    multiples."""
    mult = np.random.default_rng(seed).integers(0, 6, size=(nb, w))
    table = [None] + [py_ec.scalar_mul(py_ec.G1_GEN, c) for c in range(1, 6)]
    flat = from_affine_int([table[c] for c in mult.reshape(-1)])
    return limbs_to_words(flat).view(nb, w, 3, 8), mult


def _oracle(mult, grp):
    """Σ c·G over each slot's members inside the matrix, as python ints."""
    G, CW, S, count, width = grp
    nb, w = mult.shape
    out = []
    for b in range(nb):
        row = []
        for j in range(width // count):
            members = [(j // G) * CW + j % G + k * S for k in range(count)]
            row.append(py_ec.scalar_mul(py_ec.G1_GEN, int(sum(mult[b, m] for m in members
                                                              if m < w))))
        out.append(row)
    return out


def _affine(words):
    nb, g = words.shape[:2]
    flat = to_affine_int(words_to_limbs(words.reshape(nb * g, 3, 8)))
    return [flat[i * g : (i + 1) * g] for i in range(nb)]


_CASES = {}


def _case(kind, w):
    """The matrix, grouping, oracle and plain version of one shape, made
    once for every team size."""
    if (kind, w) not in _CASES:
        mat, mult = _multiples(3, w, seed=w)
        grp = GROUPINGS[kind](w)
        want = _oracle(mult, grp)
        assert _affine(cuda_ops.fold_segments_plain(mat, *grp)) == want
        _CASES[kind, w] = (mat, grp, want)
    return _CASES[kind, w]


@pytest.mark.parametrize("team", cuda_ops.TEAMS)
@pytest.mark.parametrize("kind,w", [(k, w) for k, ws in WIDTHS.items() for w in ws])
def test_schedule_matches_plain_and_oracle(kind, w, team):
    mat, grp, want = _case(kind, w)
    assert _affine(fold_segments_schedule(mat, *grp, team)) == want


# -------------------------------------------------- against the Pallas folds

# One small shape per grouping: (real width, width the Pallas side pads to,
# the Pallas call on the padded RNS matrix, the port's wrapper).
PALLAS = {
    "level": (10, 12, lambda m: po._pallas_fold_level(m, 4, interpret=True),
              lambda m: cuda_ops.fold_level(m, 4)),
    "halving": (10, 12, lambda m: po._pallas_fold_halving(m, 2, interpret=True),
                lambda m: cuda_ops.fold_halving(m, 2)),
    "grid": (13, 16, lambda m: po._pallas_fold_grid(m, 8, 2, interpret=True),
             lambda m: cuda_ops.fold_grid(m, 8, 2)),
}


@pytest.fixture(scope="module")
def pallas_ref():
    """Each Pallas fold, once per module, on a matrix of random points and
    identities padded with identity rows: kind -> (unpadded words, affine
    output)."""
    base = py_ec.rand_points(4, seed=90)
    ref = {}
    for kind, (w, padded, pallas, _) in PALLAS.items():
        pick = np.random.default_rng(91 + w).integers(0, 5, size=(2, w))
        aff = [[(base + [None])[k] for k in row] for row in pick]
        cells = [p for row in aff for p in row + [None] * (padded - w)]
        limbs = np.asarray(j_from_affine(cells)).reshape(2, padded, 3, 16)
        rns = jnp.asarray(np.asarray(to_rns(jnp.asarray(limbs))).reshape(2, padded, 105)
                          .astype(np.uint16))
        out = pallas(rns)
        g = out.shape[1]
        flat = j_to_affine(FQ_RNS.to_limbs(jnp.asarray(out).reshape(2 * g, 3, 35)))
        words = from_affine_int([p for row in aff for p in row])
        ref[kind] = (limbs_to_words(words).view(2, w, 3, 8), [flat[:g], flat[g:]])
    return ref


@pytest.mark.parametrize("team", cuda_ops.TEAMS)
@pytest.mark.parametrize("kind", list(PALLAS))
def test_schedule_matches_pallas_interpret(pallas_ref, kind, team):
    """The twin on the unpadded matrix, skipping what the Pallas side pads,
    equals the Pallas fold of the padded one; so does the wrapper."""
    words, want = pallas_ref[kind]
    w, padded, _, wrapper = PALLAS[kind]
    grp = {"level": cuda_ops.level_grouping(w, 4), "halving": cuda_ops.halving_grouping(w, 2),
           "grid": cuda_ops.grid_grouping(w, 8, 2)}[kind]
    assert grp[4] == padded
    assert _affine(fold_segments_schedule(words, *grp, team)) == want
    if team == 1:
        assert _affine(wrapper(words)) == want


def test_identity_rows_read_as_skipped_members():
    """A matrix padded with identity rows to the width its grouping reads
    folds to the same points as the unpadded one; the walks, which no
    longer pad, still sum every row."""
    mat, mult = _multiples(2, 45, seed=7)
    for grp in (cuda_ops.level_grouping(45, 8), cuda_ops.halving_grouping(45, 4),
                cuda_ops.grid_grouping(45, 32, 3)):
        padded = torch.cat([mat, cuda_ops.identity((2, grp[4] - 45), "cpu")], 1)
        assert grp[4] > 45
        want = _affine(cuda_ops.fold_segments(padded, *grp))
        assert _affine(cuda_ops.fold_segments(mat, *grp)) == want
        assert _affine(fold_segments_schedule(mat, *grp, 4)) == want
    sums = [[py_ec.scalar_mul(py_ec.G1_GEN, int(r.sum()))] for r in mult]
    for drive in (cuda_ops.fold_buckets_chunked, cuda_ops.fold_buckets_halving,
                  lambda m: cuda_ops.fold_buckets_grid_dense(m, wb=32, layers=3)):
        assert _affine(drive(mat)[:, None]) == sums


# ------------------------------------------------------ the wrapper's team


def test_dense_walks_levels_and_teams():
    """The three walks' levels over the micro-benchmarks' (256, 4,624)
    matrix and the team `grouping_team` gives each on a card of 132 SMs: one
    thread a slot where the slots fill the card, teams of 2 or 4 where they
    do not, and never more dependent adds than one thread a slot."""
    walks = {
        "chunked": (cuda_ops.chunked_levels(4624, 8), [578, 73, 10, 2, 1], [1, 2, 4, 4, 1]),
        "halving": (cuda_ops.halving_levels(4624, 4), [289, 19, 2, 1], [1, 4, 4, 1]),
        "grid": (cuda_ops.grid_levels(4624, 512, 4), [320, 20, 2, 1], [1, 4, 4, 1]),
    }
    for name, (levels, widths, teams) in walks.items():
        w, got_w, got_t = 4624, [], []
        for grp in levels:
            team = cuda_ops.grouping_team(256, w, grp, 132)
            members = min(grp[3], -(-w // grp[2]))
            assert cuda_ops.chain_adds(members, team) <= cuda_ops.chain_adds(members, 1)
            got_t.append(team)
            w = grp[4] // grp[3]
            got_w.append(w)
        assert (got_w, got_t) == (widths, teams), name


def test_segment_team_model():
    """T = 1 where the slots fill the card many times; the least chain of
    dependent adds for a handful of slots, the smallest team on a tie; the
    card's SM count moves the choice."""
    assert cuda_ops.segment_team(147_968, 8, 132) == 1
    assert cuda_ops.segment_team(1, 32, 132) == 16  # 1 + 4 adds, as T = 32's 0 + 5
    assert cuda_ops.segment_team(1, 2, 132) == 1
    assert cuda_ops.segment_team(256, 8, 132) == 4  # 1 + 2 adds
    assert cuda_ops.segment_team(18_688, 8, 132) == 2
    assert cuda_ops.segment_team(18_688, 8, 66) == 1  # half the SMs: the slots fill them
    assert cuda_ops.segment_team(4_864, 16, 264) == 8
    assert cuda_ops.segment_team(0, 8, 132) == 4
    for n_out in (1, 49, 512, 4864, 81_920):
        for members in (1, 2, 7, 16, 32):
            assert cuda_ops.segment_team(n_out, members, 132) in cuda_ops.TEAMS


def test_split_second_pass_team():
    """The MSM's top window, (49, 25,846): `fold_buckets_split` cuts each row
    into SPLIT_ROWS // 49 segments, and its `fold_level` pass over the
    (49, segments) partial sums gets the team of fewest dependent adds."""
    segs = cuda_ops.SPLIT_ROWS // 49
    team = cuda_ops.grouping_team(49, segs, cuda_ops.level_grouping(segs, segs), 132)
    best = min(cuda_ops.chain_adds(segs, t) for t in cuda_ops.TEAMS)
    assert cuda_ops.chain_adds(segs, team) == best
    assert team == min(t for t in cuda_ops.TEAMS if cuda_ops.chain_adds(segs, t) == best)
