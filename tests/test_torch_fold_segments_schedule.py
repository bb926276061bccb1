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


# ------------------------------------------- the chain probe's own C++ (g++)

# csrc/probe/chain_variants.cu (which includes ../fold_kernels.cu) on the
# host: the launches of fold_kernels.cu run each block's threads one after
# another (the chains have no barrier), a stub of the CUDA runtime
# (tests/test_torch_g1_batch_schedule.py's, with the SM count a parameter),
# the portable fq.cuh of tests/test_torch_g1_team_schedule.py, the real
# g1.cuh and fq_f64.cuh (the intrinsics of tests/test_torch_fq_f64_schedule.py).
# Reads (mode, variant, n, ch, route, sms, has_b, dedicated) and the
# inputs; mode 0 the add chain (variant 0: the entry point, else the blocks
# an SM), 1 the multiply chain (b absent: the squares; variant 0: the entry
# point, 1: the probe's variant of the given route and square form).
CHAIN_HARNESS = r"""
#include <cstdio>
#include <vector>
#include "cuda_runtime.h"
thread_local dim3_ threadIdx, blockIdx;
dim3_ gridDim;
int svt_sms = 1, svt_smem_limit = 232448;
template <class Kernel> void svt_grid(long long blocks, int threads, Kernel kernel) {
  gridDim.x = (unsigned)blocks;
  for (long long blk = 0; blk < blocks; blk++)
    for (int t = 0; t < threads; t++) {
      blockIdx.x = (unsigned)blk; threadIdx.x = (unsigned)t;
      kernel();
    } }
#include "probe/chain_variants.cpp"
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  long long h[8];
  if (fread(h, 8, 8, f) != 8) return 2;
  const long long mode = h[0], variant = h[1], n = h[2];
  const int ch = (int)h[3], route = (int)h[4];
  svt_sms = (int)h[5];
  const bool has_b = h[6] != 0;
  const int words = mode == 0 ? 24 : 8;
  std::vector<uint32_t> a(n * words + 4), b(n * words + 4), out(n * words + 4);
  if (n && fread(a.data(), 4, n * words, f) != (size_t)(n * words)) return 3;
  if (n && has_b && fread(b.data(), 4, n * words, f) != (size_t)(n * words)) return 3;
  const void* bp = has_b ? b.data() : nullptr;
  int err;
  if (mode == 0)
    err = variant ? svt_g1_add_chain_variant((int)variant, a.data(), bp, out.data(), n, ch, nullptr)
                  : svt_g1_add_chain(a.data(), bp, out.data(), n, ch, nullptr);
  else if (variant == 0)
    err = svt_fq_mul_chain(a.data(), bp, out.data(), n, ch, route, nullptr);
  else
    err = svt_fq_mul_chain_variant((int)h[7], a.data(), bp, out.data(), n, ch, route, nullptr);
  if (err) return 10 + err;
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 4, n * words, o);
  fclose(o);
  return 0; }
"""

CHAIN_N = 1000  # 8 tiles of 128 lanes, the last ragged
CHAIN_CH = 5


@pytest.fixture(scope="module")
def chain_harness(tmp_path_factory):
    import shutil
    import subprocess

    import test_torch_fq_f64_schedule as f64
    import test_torch_g1_batch_schedule as batch
    import test_torch_g1_team_schedule as team

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the kernels' C++ on the host")
    d = tmp_path_factory.mktemp("chain_schedule")
    (d / "probe").mkdir()
    (d / "cuda_runtime.h").write_text(batch.RUNTIME_STUB + f64.INTRINSICS + r"""
inline long long min(long long a, long long b) { return a < b ? a : b; }  // the fold's
""")
    (d / "fq.cuh").write_text(team.FIELD_STUB)
    for h in ("g1.cuh", "fq_f64.cuh"):
        shutil.copy(batch.CSRC / h, d / h)
    src = team._host_source((batch.CSRC / "fold_kernels.cu").read_text())
    assert "<<<" not in src
    (d / "fold_kernels.cu").write_text(src)
    probe = team._host_source((batch.CSRC / "probe" / "chain_variants.cu").read_text())
    assert "<<<" not in probe
    (d / "probe" / "chain_variants.cpp").write_text(probe)
    (d / "harness.cpp").write_text(CHAIN_HARNESS)
    subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-frounding-math", "-I",
                    str(d), "-o", str(d / "harness"), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)

    def run(mode, a, b, variant, ch, route=0, sms=1, dedicated=1, expect_rc=0):
        n = a.shape[0]
        inp, out = d / "in.bin", d / "out.bin"
        with open(inp, "wb") as f:
            f.write(np.array([mode, variant, n, ch, route, sms, b is not None, dedicated],
                             np.int64).tobytes())
            for x in (a,) if b is None else (a, b):
                f.write(np.ascontiguousarray(x.numpy(), dtype=np.int32).tobytes())
        r = subprocess.run([str(d / "harness"), str(inp), str(out)], capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == expect_rc, (r.returncode, r.stderr)
        if expect_rc:
            return None
        return torch.from_numpy(np.fromfile(out, np.int32).reshape(a.shape))

    return run


def _canon_words(w):
    from snark_verifier_tpu_torch.ff import FQ_FIELD

    return FQ_FIELD.canon(words_to_limbs(w))


@pytest.mark.parametrize("variant", [0, 3, 4, 5, 6],
                         ids=["entry", "blocks-3", "blocks-4", "blocks-5", "blocks-6"])
def test_add_chain_kernel_matches_plain_and_python_ints(chain_harness, variant):
    """svt_g1_add_chain (the library's blocks an SM) and every variant of
    csrc/probe/chain_variants.cu: canonical words equal to CH steps of the
    plain version after `canon`, and p + CH q as python ints, with the
    identity, P = Q and P = -Q among the lanes; persistent blocks on 1 SM
    walk the 8 tiles with a stride of the grid, on 132 SMs a tile each.
    CH = 0 writes a itself, canonical."""
    import test_torch_g1_batch_schedule as batch

    ps, qs, pw, qw = batch._inputs(CHAIN_N, 90 + variant)
    got = chain_harness(0, pw, qw, variant, CHAIN_CH)
    assert torch.equal(words_to_limbs(got), _canon_words(got)), "a word at or above p"
    assert torch.equal(_canon_words(got), _canon_words(cuda_ops.g1_add_chain_plain(pw, qw,
                                                                                   CHAIN_CH)))
    want = []
    for p, q in zip(ps, qs):
        for _ in range(CHAIN_CH):
            p = py_ec.add(p, q)
        want.append(p)
    assert to_affine_int(words_to_limbs(got)) == want
    assert torch.equal(chain_harness(0, pw, qw, variant, CHAIN_CH, sms=132), got)
    got0 = chain_harness(0, pw, qw, variant, 0)
    assert torch.equal(words_to_limbs(got0), _canon_words(pw))


@pytest.mark.parametrize("route,square,variant,dedicated", [
    (0, False, 0, 1), (0, True, 0, 1), (1, False, 0, 1), (1, True, 0, 1), (1, True, 1, 0),
    (2, False, 1, 1), (2, True, 1, 1)],
    ids=["int-mul", "int-square", "f64-mul", "f64-square", "f64-square-by-mul", "mixed-mul",
         "mixed-square"])
def test_mul_chain_kernel_routes_match_plain(chain_harness, route, square, variant, dedicated):
    """svt_fq_mul_chain by route, and the probe's variants (the FP64 square
    as the product by itself; route 2's warps of both routes in one
    launch): route 0's lazy words equal CH steps of the plain version word
    for word, route 1's are canonical and equal them after `canon`, route
    2's lanes each one or the other; the entry point refuses an unknown
    route (cudaErrorInvalidValue)."""
    rng = np.random.default_rng(7 + route)
    a = _fq_lazy(rng, CHAIN_N)
    b = None if square else _fq_lazy(rng, CHAIN_N)
    got = chain_harness(1, a, b, variant, CHAIN_CH, route=route, dedicated=dedicated)
    want = (cuda_ops.fq_sqr_chain_plain(a, CHAIN_CH) if square
            else cuda_ops.fq_mul_chain_plain(a, b, CHAIN_CH))
    lanes = torch.arange(CHAIN_N)
    f64 = (lanes % 128 // 32) % 2 == 1 if route == 2 else torch.full((CHAIN_N,), route == 1)
    assert torch.equal(got[~f64], want[~f64])
    assert torch.equal(words_to_limbs(got[f64]), _canon_words(got[f64])), "a word at or above p"
    assert torch.equal(_canon_words(got), _canon_words(want))
    if variant == 0:
        chain_harness(1, a, b, 0, CHAIN_CH, route=2, expect_rc=11)


def _fq_lazy(rng, n):
    """n lazy Fq words in [0, 2p], the edges 0, p and 2p first."""
    from snark_verifier_tpu_torch.ff import limbs_to_words
    from snark_verifier_tpu_torch.ff.spec import FQ

    vals = [int.from_bytes(rng.bytes(32), "little") % (2 * FQ.p + 1) for _ in range(n)]
    vals[:3] = [0, FQ.p, 2 * FQ.p]
    raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), dtype="<u2")
    return limbs_to_words(torch.from_numpy(raw.astype(np.int64).reshape(n, 16)))
