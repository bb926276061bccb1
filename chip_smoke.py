#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives `snark_verifier_tpu_torch` only (never jax, never snark_verifier_tpu):

1. environment: the card's name, the device count and its power limit;
2. builds the CUDA kernels from this checkout's sources (nvcc, sm_90a);
3. holds each kernel against its plain PyTorch twin on the card: `add` and
   `double` at B = 65,536 (with identity, P == Q and P == -Q lanes) exactly,
   after canonicalization (their launches here are reported as
   `launches_kat`: no main path launches them any more); `fold_buckets` at
   the MSM's real shapes, in affine form: one main window (256, 4,624), all
   31 main windows in one launch (7,936, 4,624), and the top window (49,
   25,846) both whole and split into segments (`fold_buckets_split`);
4. the main path: `msm` at n = 2^20, c = 8 over [1..n]·G (built on the card
   with the add kernel) and bench.py's scalars (numpy seed 42), with every
   kernel's launch count read around that one call; gates: no overflow, the
   result equals k_total·G (python-int oracle), one incremented scalar
   moves the result by exactly (i+1)·G, at most 3 fold launches, at most 2
   `bucket_reduce` launches and none of `add` or `double`; then best-of-3
   points/s; `bucket_reduce` against its plain version on that call's
   (32, 256) bucket sums, in affine form;
5. kernel timings with CUDA events at the main path's shapes, beside each
   kernel's bound and its plain twin's time;
6. the dense bucket folds (fold_buckets_chunked K=8, fold_buckets_halving 4
   layers per call, fold_buckets_grid_dense wb=512 4 layers) over the
   micro-benchmarks' (256, 4,624) matrix of G or the identity (numpy seed
   1), each run with its launch count read around it; gates: every bucket
   sum equals count·G (python-int oracle), each driver's first level equals
   its plain version slot for slot in affine form; ms per driver and level;
7. the add-chain probe: CH = 16 chained RC15 adds, Fq multiplies and Fq
   squares at B = 256 and 2^17, bit-identical to 16 steps of their plain
   versions;
8. the field kernels (Fq and Fr, B = 65,536), the Poseidon permutation
   (B = 1,024, plus the hadeshash x5_254_3 vector) and the fused sponge
   squeeze `poseidon_absorb` (B = 1,024, buffers of 0 to 5 elements),
   bit-identical to their plain versions;
9. the verify path: `parallel.batch_verify` (the succinct phase, then the
   pairing decide) at batch 1,024 (the 16 committed vanilla-PLONK k=10
   fixtures tiled) with every kernel's launch count read around one call;
   gates: every lane accepts, every lane's accumulator equals the port's
   python-int oracle for its fixture, a tampered instance in lane 0 rejects
   lane 0 alone (and moves its accumulator alone), one launch each of
   `fr_tape` (the recorded Fr program of `verifier/plonk/plan.py`),
   `msm_windowed`, `miller_loop` and `final_exp`, at most 3 single-op field
   launches (the transcript's batched Fq -> Fr map) and none of `add` or
   `double`; then best-of-3 verify proofs/s, and from three more runs the
   succinct and decide phases and the succinct phase's steps as
   `batch_verify` records them in its `timings`; `fr_tape`
   (on the batch's own gathered inputs and on the tampered batch's, exact
   canonical words), `msm_windowed`, `miller_loop` and `final_exp` against
   their plain versions on that call's own inputs;
10. the pairing phase (bench.py's bench_pairing): the decide of B = 256
   valid accumulators lhs = τ·rhs on the port's toy_srs(8, seed=0xA11CE),
   best-of-3 checks/s; gates: all accept, lhs + G in lane 0 rejects lane 0
   alone, a lane whose lhs and rhs are both the identity accepts;
11. the pairing kernels (a warp per proof, csrc/tower_team.cuh) against
   their plain versions on the verify batch's decide inputs and at
   B = 1,024 on random lazy words (`miller_loop` over the SRS's lines,
   `final_exp`, each `fq12_op` code, `cyclo_square` on cyclotomic-subgroup
   elements and against the plain square), with their times at B = 1, 256
   and 1,024, the Fq12 inverse alone (`inversion_ms`), their bounds (the
   least multiplies), chain floors (the least critical path: dependent
   multiplies when each Fq12 operation's products run at once), their own
   counts (`muls_per_proof`, `depth_muls`), clocks per level and ptxas
   usage.

Prints the `nvidia-smi` name/power-limit line, then one JSON line with every
kernel, then the last line {"ok": true, "device": {...}}.  Any failed check
raises: the exit code is then not 0 and the last line is not printed.
Exits 2 without a result when no CUDA card is present.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

LOG2N = 20
C_BITS = 8
CHECK_B = 1 << 16
DENSE_SHAPE = (256, 4624)  # the Pallas fold micro-benchmarks' window
PROBE_BATCHES = (256, 1 << 17)
VERIFY_BATCH = 1024
PAIRING_BATCH = 256  # bench.py's BENCH_BATCH_PAIRING
PAIR_CHECK_B = 1024  # the pairing kernels' checks against their plain versions
# Peak rates of one H100 SXM (700 W): HBM3 bandwidth, and the 32-bit integer
# multiply-add throughput (64 per SM per clock, 132 SMs, 1.98 GHz boost).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 64 * 132 * 1.98e9
MULADDS_PER_FQ_MUL = 136  # word-serial Montgomery, 8x32-bit words: 64 a*b + 8 m + 64 m*p
MULS_PER_PERMUTATION = 828  # 8 full rounds of 9 + 9, 57 partial rounds of 3 + 9
# The multiplies one lane runs per permutation when a team of lanes shares
# a state: 65 rounds of 3 (S-box) + 3 (its MDS row).  A warp alone on its
# scheduler starts each multiply's 136 multiply-adds two clocks apart at the
# 1.98 GHz boost clock, whatever their dependence: the floor of one launch
# at a batch too small to give a scheduler a second warp.
POSEIDON_CHAIN_MULS = 65 * 6
CHAIN_FLOOR_MS_PER_MUL = 136 * 2 / 1.98e9 * 1e3
MULADDS_PER_ADD = 12 * MULADDS_PER_FQ_MUL
MULADDS_PER_DOUBLE = 8 * MULADDS_PER_FQ_MUL
POINT_BYTES = 96
# svt_msm_windowed (csrc/msm_loops.cu): a warp per proof, a group of 32
# bases (one a lane) at a time, 64 windows of 4 bits.
MSMW_WINDOWS = 64
# hadeshash poseidonperm_x5_254_3: the permutation of (0, 1, 2) (T = 3, R_F = 8,
# R_P = 57), the reference's Poseidon test vector.
PERM_X5_254_3 = [
    7853200120776062878684798364095072458815029376092732009249414926327459813530,
    7142104613055408817911962100316808866448378443474503659992478482890339429929,
    6549537674122432311777789598043107870002137484850126429160507761192163713804,
]


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound_ms(n_bytes, n_muladds):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_muladds / IMAD_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def msm_windowed_ops(n):
    """(adds, doubles) of the windowed MSM of n bases as the reference runs
    it: a table of 14 adds a base; per window a tree of n - 1 adds, one add
    into the accumulator and 4 doublings."""
    return 14 * n + MSMW_WINDOWS * n, 4 * MSMW_WINDOWS


def msm_windowed_chain_muls(n):
    """Fq multiplies on one lane's chain in svt_msm_windowed: per group of
    32 bases its table (14 adds), its ladder (63 windows of 4 doublings and
    an add) and the add into its sum; then the warp's 5-level shuffle tree."""
    groups = -(-n // 32)
    adds = groups * (14 + (MSMW_WINDOWS - 1) + 1) + 5
    doubles = groups * 4 * (MSMW_WINDOWS - 1)
    return 12 * adds + 8 * doubles


def bucket_reduce_ops(W, nb, c):
    """(adds, doubles) of the least reduction of (W, nb) bucket sums: running
    sums (2 (nb - 1) adds a window) and Horner (c (W - 1) doublings, W - 1
    adds)."""
    return W * 2 * (nb - 1) + W - 1, c * (W - 1)


# Fq multiplies of the pairing kernels' tower operations (csrc/
# tower_team.cuh), each the least formula for its function: an Fq12
# product 54 (3 Fq6 products of 6 Fq2 products of 3, Karatsuba), a square
# 36 (the complex form: two Fq6 products), a sparse 034 line product 39
# (13 Fq2 products), a square in the cyclotomic subgroup 18 (nine Fq2
# squares of 2), a line's coefficients 6 (three Fq2-by-Fq products).  The
# least critical path counts one dependent multiply per operation (every
# independent product at once); the kernels' own counts what a lane runs in
# sequence: an Fq2 product on one lane (`team_mul`, a Frobenius map) 3, on
# two lanes (the Miller square and line product) 2, the cyclotomic square's
# one multiply a lane 1.  The Fq12 inverse (team_inv) around its Fq
# inversion: 12 Fq2 squares, 6 + 3 Fq2 products, the Fq2 inverse's two
# squares and two products, 3 + 12 Fq2 products: 7 operations, 18 dependent
# multiplies on its lanes.
MULS_PER_FQ12_MUL = 54
MULS_FQ12_SQR, MULS_LINE_034, MULS_CYCLO_SQR = 36, 39, 18
MULS_LINE_COEFFS = 6
MULS_FQ12_INV_OUTER = 24 + 18 + 9 + 4 + 9 + 36
DEPTH_FQ12_INV_OUTER = {True: 7, False: 2 + 3 + 3 + 2 + 2 + 3 + 3}


def _lines(npairs, has_add):
    return npairs * (len(has_add) + int(np.sum(has_add)) + 2)


def miller_muls(npairs, has_add):
    """Fq multiplies of one proof's multi-Miller loop, the kernel's and the
    function's least alike: the square of f at every step but the first
    (f = 1 there), and each line's coefficients and its product with f."""
    sqr = MULS_FQ12_SQR * (len(has_add) - 1)
    return sqr + (MULS_LINE_COEFFS + MULS_LINE_034) * _lines(npairs, has_add)


def miller_ops(npairs, has_add):
    """Fq12 operations on one proof's Miller chain: the square at every
    step but the first, and one sparse product per line."""
    return len(has_add) - 1 + _lines(npairs, has_add)


def miller_depth(npairs, has_add, least=False):
    """Dependent Fq multiplies on one proof's Miller loop: with `least` one
    per operation (the line coefficients do not depend on f); the kernel's
    two per operation (its Fq2 products run two lanes each) and one before
    them for the first line's coefficients (later lines' are made by idle
    lanes during the line product before)."""
    ops = miller_ops(npairs, has_add)
    return ops if least else 1 + 2 * ops


def fq_inv_chain(least=False):
    """(multiplies, dependent multiplies) of the Fq inversion x^(p - 2):
    the kernel's square-and-multiply (fq.cuh::fe_inv: 254 squares and one
    multiply per set bit), or the fewest over sliding-window addition chains
    (ff/fr_tape.py::window_chain, windows of 1 to 8 bits)."""
    from snark_verifier_tpu_torch.ff import FQ
    from snark_verifier_tpu_torch.ff.fr_tape import window_chain

    e = FQ.p - 2
    if not least:
        n = e.bit_length() + bin(e).count("1")
        return n, n
    muls, depths = [], []
    for w in range(1, 9):
        steps, _ = window_chain(e, w)
        depth = [0]
        for a, b in steps:
            depth.append(1 + max(depth[a], depth[b]))
        muls.append(len(steps))
        depths.append(depth[-1])
    return min(muls), min(depths)


def _frob_least_muls(tid):
    """Fq multiplies of one transform: an Fq2 coefficient of (±1, 0) costs
    none, a real one 2, any other 3."""
    from snark_verifier_tpu_torch.ff import FQ
    from snark_verifier_tpu_torch.pairing import fq12_vm

    return sum(0 if c in ((1, 0), (FQ.p - 1, 0)) else 2 if c[1] == 0 else 3
               for c in fq12_vm.transform(tid)[1])


def _tape_rows():
    """Masks of the final-exponentiation tape's rows: cyclotomic squares
    (src1 == src2, the identity transform), other products, and the
    transform id of each row."""
    from snark_verifier_tpu_torch.pairing import fq12_vm

    tape = fq12_vm.build_final_exp_tape()
    src1, src2, tid = tape[:, 0], tape[:, 1], tape[:, 3]
    product = src2 != fq12_vm.R_ONE
    square = product & (src1 == src2) & (tid == fq12_vm.T_IDENTITY)
    return square, product & ~square, tid


def final_exp_muls(least=False):
    """Fq multiplies of one proof's final exponentiation: the easy part (the
    Fq12 inverse with its Fq inversion, then conj(f)·f^-1) and the tape
    (a cyclotomic square for each square row: the tape runs after the easy
    part, so every value it squares is in the cyclotomic subgroup; 54 for
    each other product).  The kernel's count (Fermat's inversion, 15 per
    Frobenius map: five full Fq2 coefficient products), or with `least` the
    least inversion chain and each Frobenius map at its coefficients' cost."""
    from snark_verifier_tpu_torch.pairing import fq12_vm

    square, product, tid = _tape_rows()
    inv, _ = fq_inv_chain(least)
    frob = [t for t in tid if t >= fq12_vm.T_FROB1]
    transforms = (sum(_frob_least_muls(int(t)) for t in frob) if least else 15 * len(frob))
    return (MULS_FQ12_INV_OUTER + inv + MULS_PER_FQ12_MUL + MULS_CYCLO_SQR * int(square.sum())
            + MULS_PER_FQ12_MUL * int(product.sum()) + transforms)


def final_exp_depth(least=False):
    """Dependent Fq multiplies on one proof's final exponentiation: the Fq12
    inverse's operations and its Fq inversion chain (the kernel's
    square-and-multiply, or with `least` the shallowest window chain), the
    easy part's product, then each tape row that squares, multiplies or
    maps by Frobenius (conj12 and copies cost none): one multiply per
    operation with `least`; the kernel's 3 for a product or a Frobenius map
    (one lane's Fq2 product), 1 for a cyclotomic square."""
    from snark_verifier_tpu_torch.pairing import fq12_vm

    square, product, tid = _tape_rows()
    _, inv = fq_inv_chain(least)
    frob = int((tid >= fq12_vm.T_FROB1).sum())
    per = 1 if least else 3
    return (DEPTH_FQ12_INV_OUTER[least] + inv + per + int(square.sum())
            + per * (int(product.sum()) + frob))


# Fq multiplies on the top window's chain in svt_bucket_reduce: 29 adds
# (its lane's running sums 13, the suffix scan 5, the lane weight 1, two
# shuffle trees 10) and 251 doublings (the lane weight 3, the window's
# 2^248 scale 248).
BUCKET_REDUCE_CHAIN_MULS = 12 * 29 + 8 * 251


def ptxas_usage(fragment):
    """What ptxas reported in this process's build for the kernel whose
    mangled name holds `fragment`: {registers, stack_bytes, spill_bytes
    (stores), smem_bytes} (every value None when this process did not
    build the library)."""
    from snark_verifier_tpu_torch import _build

    keys = {"registers": r"Used (\d+) registers", "stack_bytes": r"(\d+) bytes stack frame",
            "spill_bytes": r"(\d+) bytes spill stores", "smem_bytes": r"(\d+) bytes smem"}
    out = dict.fromkeys(keys)
    lines = _build.build_log.splitlines()
    for i, line in enumerate(lines):
        if "entry function" in line and fragment in line:
            for nxt in lines[i + 1 : i + 6]:
                for k, pat in keys.items():
                    m = re.search(pat, nxt)
                    if m:
                        out[k] = int(m.group(1))
                if "Used" in nxt:
                    break
            break
    return out


def time_ms(fn, reps, warmup=2):
    """Mean ms per call over `reps` calls, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def proj_equal(a, b):
    """(..., 3, 8) projective words -> bool (...): the same affine point.
    Cross-multiplied: X1·Z2 = X2·Z1 and Y1·Z2 = Y2·Z1 with both Z nonzero,
    or both Z zero (the identity)."""
    import torch
    from snark_verifier_tpu_torch.ff import FQW

    z1, z2 = a[..., 2, :], b[..., 2, :]
    lhs = FQW.canon(FQW.mul(a[..., :2, :], z2[..., None, :]))
    rhs = FQW.canon(FQW.mul(b[..., :2, :], z1[..., None, :]))
    same = (lhs == rhs).all(-1).all(-1)
    z1z, z2z = FQW.is_zero(z1), FQW.is_zero(z2)
    return torch.where(z1z | z2z, z1z & z2z, same)


def word_err(got, want):
    """The largest difference between two word tensors' int32 words (0 when
    they are bit-identical)."""
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def affine_err(a, b):
    """The largest word difference between the canonical affine coordinates
    of two (..., 3, 8) point tensors: 0 when they hold the same points (the
    identity maps to (0, 0), which no curve point has)."""
    from snark_verifier_tpu_torch.ff import FQW
    from snark_verifier_tpu_torch.msm import cuda_ops

    xa, ya, _ = cuda_ops.to_affine(a)
    xb, yb, _ = cuda_ops.to_affine(b)
    return max(word_err(FQW.canon(xa), FQW.canon(xb)), word_err(FQW.canon(ya), FQW.canon(yb)))


def rand_lazy_words(rng, shape, p, device):
    """int32 words of values uniform in [0, 2p], the lazy contract."""
    import torch
    from snark_verifier_tpu_torch.ff import limbs_to_words

    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") % (2 * p + 1) for _ in range(n)]
    vals[: min(n, 3)] = [0, p, 2 * p][: min(n, 3)]
    raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), dtype="<u2")
    limbs = torch.from_numpy(raw.astype(np.int64).reshape(*shape, 16))
    return limbs_to_words(limbs).to(device)


def dense_fold_phase(dev, kernels):
    """The dense bucket-fold path: the three drivers over the
    micro-benchmarks' (256, 4,624) matrix of G or the identity."""
    import torch
    from snark_verifier_tpu_torch.ec import from_affine_int, limbs_to_words, py_ec, to_affine_int
    from snark_verifier_tpu_torch.ec import words_to_limbs
    from snark_verifier_tpu_torch.msm import cuda_ops

    NB, cap = DENSE_SHAPE
    pad = (-cap) % 512
    rng = np.random.default_rng(1)  # micro_pallas_fold20.py's matrix
    fill = rng.integers(0, 2, size=(NB, cap)).astype(bool)
    counts = fill.sum(1)
    g = limbs_to_words(from_affine_int([py_ec.G1_GEN], device=dev))[0]
    mat = torch.where(torch.from_numpy(fill).to(dev)[..., None, None], g,
                      cuda_ops.identity((), dev)).contiguous()
    want = [py_ec.scalar_mul(py_ec.G1_GEN, int(c)) for c in counts]
    drivers = {
        "fold_buckets_chunked": (lambda m, **k: cuda_ops.fold_buckets_chunked(m, K=8, **k),
                                 lambda m: cuda_ops.fold_level(m, 8),
                                 lambda m: cuda_ops.fold_segments_plain(m, 1, 8, 1, 8)),
        "fold_buckets_halving": (lambda m, **k: cuda_ops.fold_buckets_halving(m, 4, **k),
                                 lambda m: cuda_ops.fold_halving(m, 4),
                                 lambda m: cuda_ops.fold_segments_plain(m, cap >> 4, cap,
                                                                        cap >> 4, 16)),
        "fold_buckets_grid_dense": (
            lambda m, **k: cuda_ops.fold_buckets_grid_dense(m, wb=512, layers=4, **k),
            lambda m: cuda_ops.fold_grid(cuda_ops._pad_identity(m, pad), 512, 4),
            lambda m: cuda_ops.fold_segments_plain(cuda_ops._pad_identity(m, pad), 32, 512, 32, 16)),
    }
    full_adds = NB * (cap - 1)
    full_bound = bound_ms(mat.numel() * 4 + NB * POINT_BYTES, full_adds * MULADDS_PER_ADD)
    launches, err, drv_ms, level_ms = 0, 0, {}, {}
    for name, (drive, first, first_plain) in drivers.items():
        cuda_ops.reset_launches()
        out = drive(mat)
        torch.cuda.synchronize()
        n_launch = cuda_ops.LAUNCHES["fold_segments"]
        check(n_launch > 0, f"{name} launched no fold_segments kernel")
        launches += n_launch
        got = to_affine_int(words_to_limbs(out))
        bad = sum(x != y for x, y in zip(got, want))
        check(bad == 0, f"{name}: {bad} of {NB} bucket sums differ from count·G")
        lk, lp = first(mat), first_plain(mat)
        torch.cuda.synchronize()
        eq = proj_equal(lk, lp)
        check(bool(eq.all()), f"{name}: first level differs from its plain version in "
                              f"{int((~eq).sum())} slots")
        err = max(err, affine_err(lk, lp))
        check(err == 0, f"{name}: first level's affine words differ from its plain version")
        drv_ms[name] = time_ms(lambda: drive(mat), 3, warmup=1)
        marks = []

        def on_level(m):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((tuple(m.shape[:2]), ev))

        start = torch.cuda.Event(enable_timing=True)
        start.record()
        drive(mat, on_level=on_level)
        torch.cuda.synchronize()
        prev, levels = start, []
        for shape, ev in marks:
            levels.append((shape, round(prev.elapsed_time(ev), 4)))
            prev = ev
        level_ms[name] = levels
        log(f"# {name} at ({NB}, {cap}): {drv_ms[name]:.3f} ms, {n_launch} launches, "
            f"== count·G in all {NB} buckets, first level == plain version slot for slot; "
            f"levels (out shape, ms): {levels}")
    log(f"# dense fold bound (full fold, {full_adds} adds): {full_bound[0]:.4f} ms "
        f"({full_bound[1]})")
    lvl_mat = mat
    ms = time_ms(lambda: cuda_ops.fold_level(lvl_mat, 8), 5)
    plain = time_ms(lambda: cuda_ops.fold_segments_plain(lvl_mat, 1, 8, 1, 8), 1, warmup=1)
    lvl_adds = NB * (cap // 8) * 7
    bms, by = bound_ms(mat.numel() * 4 + NB * (cap // 8) * POINT_BYTES, lvl_adds * MULADDS_PER_ADD)
    kernels.append(dict(
        name="fold_segments", route="cuda", source="snark_verifier_tpu_torch/csrc/fold_kernels.cu",
        replaces="snark_verifier_tpu/msm/pallas_ops.py:246", launches=launches, max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
        shape=[NB, cap, 3, 8], timed="first K=8 level (one launch)",
        also_replaces=["snark_verifier_tpu/msm/pallas_ops.py:326",
                       "snark_verifier_tpu/msm/pallas_ops.py:589"],
        drivers_ms=drv_ms, full_fold_bound_ms=full_bound[0], tolerance="exact, affine"))


def probe_phase(dev, kernels):
    """The add-chain probe (micro_packed_dissect.py): CH = 16 chained RC15
    adds and Fq multiplies on register-resident data, against CH steps of
    their plain versions."""
    import torch
    from snark_verifier_tpu_torch.ff import FQ
    from snark_verifier_tpu_torch.msm import cuda_ops

    CH = 16
    rng = np.random.default_rng(3)
    ins = {B: (rand_lazy_words(rng, (B, 3), FQ.p, dev), rand_lazy_words(rng, (B, 3), FQ.p, dev))
           for B in PROBE_BATCHES}
    cuda_ops.reset_launches()
    outs = {B: (cuda_ops.g1_add_chain(a, b, CH), cuda_ops.fq_mul_chain(a[:, 0].contiguous(),
                                                                       b[:, 0].contiguous(), CH))
            for B, (a, b) in ins.items()}
    torch.cuda.synchronize()
    counts = {k: cuda_ops.LAUNCHES[k] for k in ("g1_add_chain", "fq_mul_chain")}
    rows, errs, sqr_ms = {}, [0, 0], {}
    for B, (a, b) in ins.items():
        x, y = a[:, 0].contiguous(), b[:, 0].contiguous()
        errs[0] = max(errs[0], word_err(outs[B][0], cuda_ops.g1_add_chain_plain(a, b, CH)))
        errs[1] = max(errs[1], word_err(outs[B][1], cuda_ops.fq_mul_chain_plain(x, y, CH)),
                      word_err(cuda_ops.fq_sqr_chain(x, CH), cuda_ops.fq_sqr_chain_plain(x, CH)))
        check(errs == [0, 0], f"a chain differs from {CH} steps of its plain version at B={B}")
        ms_a = time_ms(lambda: cuda_ops.g1_add_chain(a, b, CH), 10)
        ms_m = time_ms(lambda: cuda_ops.fq_mul_chain(x, y, CH), 10)
        sqr_ms[B] = time_ms(lambda: cuda_ops.fq_sqr_chain(x, CH), 10)
        pa = time_ms(lambda: cuda_ops.g1_add_chain_plain(a, b, CH), 1, warmup=0)
        pm = time_ms(lambda: cuda_ops.fq_mul_chain_plain(x, y, CH), 1, warmup=0)
        ba = bound_ms(3 * POINT_BYTES * B, B * CH * MULADDS_PER_ADD)
        bm = bound_ms(3 * 32 * B, B * CH * MULADDS_PER_FQ_MUL)
        rows[B] = (ms_a, pa, ba, ms_m, pm, bm)
        log(f"# probe B={B} CH={CH}: add chain {ms_a:.4f} ms = {ms_a / CH * 1e3:.3f} us/add-step, "
            f"{B * CH / ms_a / 1e6:.3f} G adds/s (bound {ba[0]:.4f} ms, "
            f"{B * CH / ba[0] / 1e6:.3f} G adds/s); Fq mul chain {ms_m:.4f} ms = "
            f"{B * CH / ms_m / 1e6:.3f} G Fq-muls/s (bound {bm[0]:.4f} ms, "
            f"{B * CH / bm[0] / 1e6:.3f} G Fq-muls/s), the same chain of squares (fe_sqr) "
            f"{sqr_ms[B]:.4f} ms = {B * CH / sqr_ms[B] / 1e6:.3f} G squares/s; "
            f"plain {pa:.1f} / {pm:.1f} ms")
    small, big = PROBE_BATCHES
    ms_a, pa, ba, ms_m, pm, bm = rows[big]
    kernels.append(dict(
        name="g1_add_chain", route="cuda", source="snark_verifier_tpu_torch/csrc/fold_kernels.cu",
        replaces="benchmarks/micro_packed_dissect.py:48", launches=counts["g1_add_chain"],
        max_abs_err=errs[0], ms=ms_a, plain_ms=pa, bound_ms=ba[0], bound_by=ba[1], library_ms=None,
        shape=[big, 3, 8], ch=CH, ms_b256=rows[small][0], tolerance="exact, lazy words"))
    kernels.append(dict(
        name="fq_mul_chain", route="cuda", source="snark_verifier_tpu_torch/csrc/fold_kernels.cu",
        replaces="benchmarks/micro_packed_dissect.py:48", launches=counts["fq_mul_chain"],
        max_abs_err=errs[1], ms=ms_m, plain_ms=pm, bound_ms=bm[0], bound_by=bm[1], library_ms=None,
        shape=[big, 8], ch=CH, ms_b256=rows[small][3], sqr_ms=sqr_ms[big],
        sqr_ms_b256=sqr_ms[small], tolerance="exact, lazy words"))


def field_checks(dev):
    """Every field kernel and the Poseidon permutation against their plain
    versions on the card, bit for bit on lazy words; the hadeshash vector.
    Returns each kernel's largest word difference (all 0)."""
    from snark_verifier_tpu_torch.ff import FQW, FRW
    from snark_verifier_tpu_torch.hash import absorb, absorb_plain, permute, permute_plain
    from snark_verifier_tpu_torch.msm import cuda_ops

    rng = np.random.default_rng(4)
    B = CHECK_B
    errs = {}
    for F in (FQW, FRW):
        a = rand_lazy_words(rng, (B,), F.spec.p, dev)
        b = rand_lazy_words(rng, (B,), F.spec.p, dev)
        c = a[5]  # one element broadcast over the batch, as the verifier's constants
        cases = [(op, (x, y)) for op in ("mul", "add", "sub") for x, y in ((a, b), (a, c))]
        cases += [("neg", (a,)), ("canon", (a,)), ("inv", (a[:8192],))]
        for op, args in cases:
            e = word_err(getattr(F, op)(*args), F.plain(op, *args))
            check(e == 0, f"field_{op} ({F.spec.name}) differs from its plain version")
            errs[f"field_{op}"] = max(errs.get(f"field_{op}", 0), e)
    st = rand_lazy_words(rng, (1024, 3), FRW.spec.p, dev)
    errs["poseidon_permute"] = word_err(permute(st), permute_plain(st))
    check(errs["poseidon_permute"] == 0, "poseidon_permute differs from its plain version")
    # The bare permutation's own path is `hash.permute`, as the tests and
    # this vector call it (the verify path squeezes through poseidon_absorb).
    cuda_ops.reset_launches()
    kat = permute(FRW.from_int([0, 1, 2]).view(1, 3, 8).to(dev))
    check([int(v) for v in FRW.to_int(kat[0])] == PERM_X5_254_3, "poseidon hadeshash vector")
    errs["poseidon_permute_kat_launches"] = cuda_ops.LAUNCHES["poseidon_permute"]
    check(errs["poseidon_permute_kat_launches"] > 0, "permute launched no kernel")
    errs["poseidon_absorb"] = 0
    for k in range(6):
        buf = rand_lazy_words(rng, (1024, k), FRW.spec.p, dev)
        e = word_err(absorb(st, buf), absorb_plain(st, buf))
        check(e == 0, f"poseidon_absorb differs from the plain sponge at k={k}")
        errs["poseidon_absorb"] = max(errs["poseidon_absorb"], e)
    log(f"# field kernels (Fq, Fr) at B={B}, poseidon_permute at B=1024 and poseidon_absorb at "
        f"B=1024, k=0..5: bit-identical to their plain versions; hadeshash x5_254_3 vector OK")
    return errs


def verify_phase(dev, kernels, errs):
    """The verify path: batch_verify at batch 1024 over the 16 committed
    vanilla-PLONK k=10 fixtures, tiled.  Returns (verify proofs/s, the
    decide's captured Miller-loop arguments and final-exponentiation input,
    its launch counts)."""
    import torch
    from pathlib import Path

    from snark_verifier_tpu_torch.ec import to_affine_int, words_to_limbs
    from snark_verifier_tpu_torch.ff import FRW, digits4, fr_tape
    from snark_verifier_tpu_torch.hash import absorb, absorb_plain, permute, permute_plain
    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.pairing import pairing
    from snark_verifier_tpu_torch.parallel import batch_verify
    from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21
    from snark_verifier_tpu_torch.sdk import aggregation as agg
    from snark_verifier_tpu_torch.sdk.snark import Snark
    from snark_verifier_tpu_torch.sdk.srs import load_params
    from snark_verifier_tpu_torch.verifier.plonk import verifier as pv
    from snark_verifier_tpu_torch.verifier.plonk.plan import succinct_plan

    B = VERIFY_BATCH
    d = Path(__file__).resolve().parent / "benchmarks" / "fixtures" / "vanilla_k10"
    t0 = time.time()
    srs = load_params(str(d / "srs.bin"))
    base = [Snark.load(str(d / f"snark_{i:02d}.json")) for i in range(16)]
    snarks = [base[i % 16] for i in range(B)]
    oracle = [pv.succinct_verify_native(s, srs)[0] for s in base]
    log(f"# verify inputs: SRS + 16 fixtures + 16 oracle runs: {time.time() - t0:.2f}s")

    # The Fr program's and the decide's inputs, captured around the kernel
    # wrappers (which count their own launches).
    seen_tape, seen_ml, seen_fe = [], [], []
    real_tape = fr_tape.run
    real_ml, real_fe = pairing.miller_loop, pairing.final_exponentiation

    def capture_tape(tape, inputs):
        seen_tape.append((tape, inputs))
        return real_tape(tape, inputs)

    def capture_ml(*args):
        seen_ml.append(args)
        return real_ml(*args)

    def capture_fe(f):
        seen_fe.append(f)
        return real_fe(f)

    fr_tape.run, pairing.miller_loop, pairing.final_exponentiation = (
        capture_tape, capture_ml, capture_fe)
    try:
        cuda_ops.reset_launches()
        oks = batch_verify(snarks, srs)
        torch.cuda.synchronize()
        launches = dict(cuda_ops.LAUNCHES)
        tam = Snark(base[0].protocol, [list(c) for c in base[0].instances], base[0].scalars,
                    base[0].points)
        tam.instances[0][0] = (tam.instances[0][0] + 1) % FRW.spec.p
        oks_t = batch_verify([tam] + snarks[1:], srs)
    finally:
        fr_tape.run, pairing.miller_loop, pairing.final_exponentiation = real_tape, real_ml, real_fe
    path = ("fr_tape", "msm_windowed", "poseidon_absorb", "miller_loop", "final_exp")
    field = {k: v for k, v in launches.items() if k.startswith("field_")}
    log(f"# verify path launches per batch of {B}: "
        f"{ {k: launches[k] for k in path + ('add', 'double', 'fq12_op')} }; single-op field "
        f"kernels {field}")
    for k in path:
        check(launches[k] > 0, f"kernel {k} was not launched on the verify path")
    for k in ("fr_tape", "msm_windowed", "miller_loop", "final_exp"):
        check(launches[k] == 1, f"the verify batch launched {k} {launches[k]} times, not once")
    check(sum(field.values()) <= 3,
          f"the verify batch launched {sum(field.values())} single-op field kernels, not at most 3")
    check(launches["add"] == 0 and launches["double"] == 0,
          "the verify batch launched the add or double kernel")
    check(len(seen_tape) == 2, "the Fr program did not run once per batch")
    check(len(seen_ml) == 2 and len(seen_fe) == 2, "the decide did not run once per batch")
    check(oks.dtype == torch.bool and tuple(oks.shape) == (B,), "batch_verify's result shape")
    check(bool(oks.all()), f"{int((~oks).sum())} of {B} valid proofs rejected")
    check(not bool(oks_t[0]) and bool(oks_t[1:].all()),
          f"tampered lane 0: rejected lanes {torch.nonzero(~oks_t).flatten()[:5].tolist()}")

    def accumulators(args):
        """(lhs, rhs) (B, 3, 8) from the Miller loop's (xs, ys, zs)."""
        xs, ys, zs = args[:3]
        pts = torch.stack([xs, ys, zs], dim=-2)  # (B, pair, coord, 8)
        return pts[:, 0].contiguous(), pts[:, 1].contiguous()

    lhs, rhs = accumulators(seen_ml[0])
    got = list(zip(to_affine_int(words_to_limbs(lhs)), to_affine_int(words_to_limbs(rhs))))
    bad = [b for b in range(B) if got[b] != oracle[b % 16]]
    check(not bad, f"{len(bad)} lanes differ from the native oracle, first {bad[:5]}")
    tl, tr = accumulators(seen_ml[1])
    moved = ~(proj_equal(tl, lhs) & proj_equal(tr, rhs))
    check(bool(moved[0]) and not bool(moved[1:].any()),
          f"tampered lane 0: moved lanes {torch.nonzero(moved).flatten()[:5].tolist()}")
    tgot = (to_affine_int(words_to_limbs(tl[0])), to_affine_int(words_to_limbs(tr[0])))
    check(tgot == pv.succinct_verify_native(tam, srs)[0], "tampered lane != its oracle")
    log(f"# verify gates: all {B} lanes accept, their accumulators == the native oracle of their "
        f"fixture; the tampered instance rejects lane 0 alone and moved its accumulator alone")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        batch_verify(snarks, srs)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    best = min(times)
    log(f"# verify at batch {B}: best-of-3 {best * 1e3:.2f} ms = {B / best:.1f} verify proofs/s "
        f"(runs {[round(t * 1e3, 2) for t in times]} ms) on {smi_line()}")

    # Phases and the succinct phase's steps, as batch_verify records them in
    # `timings` (host clock, each step between two synchronizes), three runs.
    steps = ("stack_s", "plan_s", "read_s", "gather_s", "fr_tape_s", "msm_s")
    phases = []
    for _ in range(3):
        tm = {}
        batch_verify(snarks, srs, timings=tm)
        phases.append(tm)
    check(all(set(steps) <= set(tm) for tm in phases), "batch_verify recorded no succinct steps")

    def ms_list(key):
        return [round(tm[key] * 1e3, 3) for tm in phases]

    log(f"# verify succinct phase (ms, the three runs): {ms_list('succinct_s')}")
    log(f"# verify decide phase (ms, the three runs): {ms_list('decide_s')}")
    log("# verify succinct steps (ms, the three runs): stacking and upload "
        f"{ms_list('stack_s')}, transcript and read_proof {ms_list('read_s')}, plan lookup "
        f"{ms_list('plan_s')}, gather {ms_list('gather_s')}, fr_tape {ms_list('fr_tape_s')}, "
        f"bases and MSM {ms_list('msm_s')}")
    plan = succinct_plan(base[0].protocol, Bdfg21, "shplonk", "poseidon")
    log(f"# verify plan: recorded once per protocol, on this process's first batch, in "
        f"{plan.record_s * 1e3:.2f} ms; {len(plan.tape.rows)} rows {plan.tape.op_counts()}, "
        f"{plan.tape.n_slots} slots, {len(plan.tape.inputs)} inputs, "
        f"{len(plan.tape.outputs)} outputs")

    # Device busy share of one batch: kernel time from a torch.profiler
    # trace over the host-clock wall time of the same (traced) call; the
    # decide's two kernels apart from the succinct phase's.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        batch_verify(snarks, srs)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:6]
    decide_ms = sum(e.self_device_time_total for e in on_card
                    if "miller_loop" in e.key or "final_exp" in e.key) / 1e3
    if busy_ms > 0:
        log(f"# verify device time (torch.profiler, one traced batch): {busy_ms:.2f} ms busy of "
            f"{wall_ms:.2f} ms wall = {busy_ms / wall_ms:.1%} busy; decide kernels {decide_ms:.2f} "
            f"ms, succinct {busy_ms - decide_ms:.2f} ms; top: " + ", ".join(
                f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}" for e in top))
    else:
        log("# verify device time: not measured (the profiler recorded no device events)")

    # Kernel rows: times at the verify path's (1024, ·) shapes.
    rng = np.random.default_rng(5)
    a = rand_lazy_words(rng, (B,), FRW.spec.p, dev)
    b = rand_lazy_words(rng, (B,), FRW.spec.p, dev)
    n_inv = 254 + bin(FRW.spec.p - 2).count("1")
    rows = {
        "field_mul": (lambda: FRW.mul(a, b), lambda: FRW.plain("mul", a, b), 3 * 32 * B,
                      MULADDS_PER_FQ_MUL * B, "snark_verifier_tpu/ff/jnp_field.py:145"),
        "field_add": (lambda: FRW.add(a, b), lambda: FRW.plain("add", a, b), 3 * 32 * B, 0,
                      "snark_verifier_tpu/ff/jnp_field.py:127"),
        "field_sub": (lambda: FRW.sub(a, b), lambda: FRW.plain("sub", a, b), 3 * 32 * B, 0,
                      "snark_verifier_tpu/ff/jnp_field.py:132"),
        "field_neg": (lambda: FRW.neg(a), lambda: FRW.plain("neg", a), 2 * 32 * B, 0,
                      "snark_verifier_tpu/ff/jnp_field.py:141"),
        "field_canon": (lambda: FRW.canon(a), lambda: FRW.plain("canon", a), 2 * 32 * B, 0,
                        "snark_verifier_tpu/ff/jnp_field.py:121"),
        "field_inv": (lambda: FRW.inv(a), lambda: FRW.plain("inv", a), 2 * 32 * B,
                      n_inv * MULADDS_PER_FQ_MUL * B, "snark_verifier_tpu/ff/jnp_field.py:211"),
    }
    st = rand_lazy_words(rng, (B, 3), FRW.spec.p, dev)
    perm_ops = MULS_PER_PERMUTATION * MULADDS_PER_FQ_MUL
    rows["poseidon_permute"] = (lambda: permute(st), lambda: permute_plain(st), 2 * 96 * B,
                                perm_ops * B, "snark_verifier_tpu/hash/poseidon.py:110")
    K_ABSORB = 2  # a two-element buffer: two chained permutations
    buf = rand_lazy_words(rng, (B, K_ABSORB), FRW.spec.p, dev)
    n_perm = K_ABSORB // 2 + 1
    rows["poseidon_absorb"] = (lambda: absorb(st, buf), lambda: absorb_plain(st, buf),
                               (2 * 96 + 32 * K_ABSORB) * B, n_perm * perm_ops * B,
                               "snark_verifier_tpu/hash/poseidon.py:192")
    for name, (kern, plain, nbytes, nops, where) in rows.items():
        ms = time_ms(kern, 50)
        pms = time_ms(plain, 2, warmup=1)
        bms, by = bound_ms(nbytes, nops)
        src = "poseidon_kernels.cu" if name.startswith("poseidon") else "field_kernels.cu"
        kernels.append(dict(
            name=name, route="cuda", source=f"snark_verifier_tpu_torch/csrc/{src}",
            replaces=where, launches=launches[name], max_abs_err=errs[name], ms=ms, plain_ms=pms,
            bound_ms=bms, bound_by=by, library_ms=None,
            shape=[B, 3, 8] if name.startswith("poseidon") else [B, 8],
            tolerance="exact, lazy words"))
    # Poseidon at this batch is held to the latency of one state's chain of
    # dependent multiplies, not to throughput; at B = 65,536 to throughput.
    BIG = 1 << 16
    st_big = rand_lazy_words(rng, (BIG, 3), FRW.spec.p, dev)
    ms_big = time_ms(lambda: permute(st_big), 10)
    big_bound = bound_ms(2 * 96 * BIG, perm_ops * BIG)[0]
    floor = POSEIDON_CHAIN_MULS * CHAIN_FLOOR_MS_PER_MUL
    for row in kernels:
        if row["name"] == "poseidon_permute":
            # `launches` is the verify call's own count: 0 since a squeeze is one
            # poseidon_absorb launch.  The bare permutation is `hash.permute`'s
            # kernel; the hadeshash vector's launch is counted apart.
            row.update(launches_kat=errs["poseidon_permute_kat_launches"],
                       chain_floor_ms=floor, ms_b65536=ms_big, bound_ms_b65536=big_bound)
            log(f"# poseidon_permute: B={B} {row['ms']:.4f} ms (throughput bound "
                f"{row['bound_ms']:.4f} ms; chain floor {floor:.4f} ms = {POSEIDON_CHAIN_MULS} "
                f"multiplies per lane: the yardstick at this batch); B={BIG} {ms_big:.4f} ms "
                f"(throughput bound {big_bound:.4f} ms)")
        if row["name"] == "poseidon_absorb":
            row.update(k=K_ABSORB, permutations=n_perm, chain_floor_ms=n_perm * floor)
    for row in kernels:
        if row["name"] in ("add", "double"):
            row["launches_verify"] = launches[row["name"]]
            row["launches"] += launches[row["name"]]

    # The Fr program against its plain version on the batch's own gathered
    # inputs and on the tampered batch's, exact canonical words.
    tape = plan.tape
    err, plain_ms = 0, None
    for label, (tp, ins) in zip(("batch", "tampered batch"), seen_tape):
        got = fr_tape.run(tp, ins)
        torch.cuda.synchronize()
        t0 = time.time()
        want = fr_tape.run_plain(tp, ins)
        torch.cuda.synchronize()
        plain_ms = plain_ms or (time.time() - t0) * 1e3
        e = word_err(got, want)
        check(e == 0, f"fr_tape differs from run_plain on the {label}'s inputs")
        err = max(err, e)
    ins = seen_tape[0][1]
    check(not torch.equal(ins, seen_tape[1][1]), "the tampered batch's Fr inputs did not move")
    ins1 = ins[:, :1].contiguous()
    ms = time_ms(lambda: fr_tape.run(tape, ins), 50)
    ms1 = time_ms(lambda: fr_tape.run(tape, ins1), 50)
    # The plan's three inversions alone (chained, then one output): their
    # share of the kernel's time.
    slot0, in0 = fr_tape.SLOT << fr_tape.KIND_SHIFT, fr_tape.INPUT << fr_tape.KIND_SHIFT
    inv_rows = [(fr_tape.INV, 0, in0, 0), (fr_tape.INV, 0, slot0, 0), (fr_tape.INV, 0, slot0, 0),
                (fr_tape.OUT, 0, slot0, 0)]
    inv_tape = fr_tape.FrTape(rows=np.array(inv_rows, np.int32), consts=np.zeros((1, 8), np.int32),
                              inputs=["x"], outputs=["x^-3"], n_slots=1)
    check(tape.op_counts()["inv"] == 3, "the plan's inversion count changed")
    ins_inv = ins[:1].contiguous()
    ms_inv = time_ms(lambda: fr_tape.run(inv_tape, ins_inv), 50)
    # The bound and the chain floor count the least work the function needs
    # (squares at fe_sqr's cost, OUT a reduction, INV an addition chain);
    # `muls_per_lane` is the kernel's own count of multiplies.
    muls, chain = tape.muls(), tape.chain_muls()
    least = tape.row_muladds(least=True)
    least_work, least_chain = int(least.sum()), tape.chain(least)
    least_muls = least_work / MULADDS_PER_FQ_MUL
    nbytes = (ins.shape[0] + len(tape.outputs)) * B * 32 + tape.rows.nbytes + tape.consts.nbytes
    bms, by = bound_ms(nbytes, B * least_work)
    floor = least_chain * CHAIN_FLOOR_MS_PER_MUL / MULADDS_PER_FQ_MUL
    clocks = ms1 / (muls * CHAIN_FLOOR_MS_PER_MUL) * 272
    use = ptxas_usage("fr_tape_kernel")
    regs, stack = use["registers"], use["stack_bytes"]
    smem = tape.n_slots * 8 * 32 * 4
    log(f"# fr_tape at ({ins.shape[0]}, {B}, 8) -> ({len(tape.outputs)}, {B}, 8): {ms:.4f} ms, "
        f"B=1 {ms1:.4f} ms (bound {bms:.6f} ms, {by}, from the least {least_muls:.1f} multiplies "
        f"a lane; chain floor {floor:.4f} ms = the least longest chain, {least_chain} "
        f"multiply-adds; the kernel runs {muls} multiplies a lane, {chain} of them chained, "
        f"{clocks:.0f} clocks per multiply alone; the three inversions alone {ms_inv:.4f} ms = "
        f"{ms_inv / ms:.1%}); plain {plain_ms:.1f} ms; slots "
        f"{tape.n_slots} in shared memory ({smem} B a block), ptxas {regs} registers, "
        f"{stack} B stack; == run_plain on the batch's and the tampered batch's inputs")
    kernels.append(dict(
        name="fr_tape", route="cuda", source="snark_verifier_tpu_torch/csrc/fr_tape.cu",
        replaces="snark_verifier_tpu/ff/jnp_field.py:145",
        also_replaces=["snark_verifier_tpu/ff/jnp_field.py:236",
                       "snark_verifier_tpu/ff/jnp_field.py:200",
                       "snark_verifier_tpu/parallel/batch_verify.py:86"],
        launches=launches["fr_tape"], max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None, shape=list(ins.shape), ms_b1=ms1, chain_floor_ms=floor,
        chain_muls=chain, muls_per_lane=muls, least_muls_per_lane=least_muls,
        least_chain_muladds=least_chain, inversions_ms=ms_inv, rows=len(tape.rows),
        slots=tape.n_slots,
        slot_layout="shared memory [slot][word][lane]", shared_bytes=smem,
        ptxas_registers=regs, ptxas_stack_bytes=stack, tolerance="exact, canonical"))

    # The verify MSM against its plain version on the batch's own bases and
    # scalars, captured from one more call.
    seen = []
    kernel = cuda_ops.msm_windowed

    def capture(pts, scalars, c=4):
        seen.append((pts, scalars))
        return kernel(pts, scalars, c)

    cuda_ops.msm_windowed = capture
    try:
        agg.batch_succinct_verify(snarks, srs)
    finally:
        cuda_ops.msm_windowed = kernel
    check(len(seen) == 1, f"the verify batch called msm_windowed {len(seen)} times")
    pts, scs = seen[0]
    n = pts.shape[1]
    got = cuda_ops.msm_windowed(pts, scs)
    torch.cuda.synchronize()
    t0 = time.time()
    want = cuda_ops.msm_windowed_plain(pts, digits4(scs))
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = affine_err(got, want)
    check(err == 0, "msm_windowed differs from its plain version")
    ms = time_ms(lambda: cuda_ops.msm_windowed(pts, scs), 20)
    w_adds, w_dbls = msm_windowed_ops(n)
    bms, by = bound_ms(pts.numel() * 4 + scs.numel() * 4 + B * POINT_BYTES,
                       B * (w_adds * MULADDS_PER_ADD + w_dbls * MULADDS_PER_DOUBLE))
    chain = msm_windowed_chain_muls(n)
    floor = chain * CHAIN_FLOOR_MS_PER_MUL
    ms_one = time_ms(lambda: cuda_ops.msm_windowed(pts[:1].contiguous(), scs[:1].contiguous()),
                     20)
    log(f"# msm_windowed at {tuple(pts.shape[:2])}: {ms:.4f} ms (bound {bms:.4f} ms, {by}; "
        f"chain floor {floor:.4f} ms = {chain} multiplies on a lane); B=1 {ms_one:.4f} ms; "
        f"plain {plain_ms:.1f} ms; affine-equal to the plain version")
    kernels.append(dict(
        name="msm_windowed", route="cuda", source="snark_verifier_tpu_torch/csrc/msm_loops.cu",
        replaces="snark_verifier_tpu/ec/curve.py:194",
        also_replaces=["snark_verifier_tpu/ec/curve.py:245"], launches=launches["msm_windowed"],
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
        shape=list(pts.shape), chain_floor_ms=floor, ms_b1=ms_one, tolerance="exact, affine"))
    return B / best, (seen_ml[0], seen_fe[0]), launches


def pairing_phase(dev):
    """bench.py's bench_pairing on the port: the decide of B = 256 valid
    accumulators lhs = τ·rhs on toy_srs(8, seed=0xA11CE).  Returns checks/s."""
    import torch

    from snark_verifier_tpu_torch.ec import from_affine_int_np, py_ec
    from snark_verifier_tpu_torch.ff import FR
    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.pcs.kzg.decider import decide
    from snark_verifier_tpu_torch.sdk.srs import toy_srs

    B = PAIRING_BATCH
    t0 = time.time()
    srs = toy_srs(8, seed=0xA11CE)
    rng = np.random.default_rng(3)
    ks = [int.from_bytes(rng.bytes(31), "big") for _ in range(B)]
    rhs_pts = [py_ec.scalar_mul(py_ec.G1_GEN, k) for k in ks]
    lhs_pts = [py_ec.scalar_mul(py_ec.G1_GEN, k * srs.tau % FR.p) for k in ks]
    up = lambda pts: torch.from_numpy(from_affine_int_np(pts)).to(dev)
    lhs, rhs = up(lhs_pts), up(rhs_pts)
    # lane 0: lhs + G (rejects); lane 1: both sides the identity (accepts)
    neg_lhs = up([py_ec.add(lhs_pts[0], py_ec.G1_GEN), None] + lhs_pts[2:])
    neg_rhs = up([rhs_pts[0], None] + rhs_pts[2:])
    log(f"# pairing inputs: toy_srs(8) and {B} accumulators on the host: {time.time() - t0:.2f}s")
    cuda_ops.reset_launches()
    ok = decide(srs, lhs, rhs)
    torch.cuda.synchronize()
    launches = {k: cuda_ops.LAUNCHES[k] for k in ("miller_loop", "final_exp")}
    check(launches == {"miller_loop": 1, "final_exp": 1},
          f"the pairing batch launched {launches}, not one of each")
    check(bool(ok.all()), f"{int((~ok).sum())} of {B} valid accumulators rejected")
    neg = decide(srs, neg_lhs, neg_rhs)
    want = [False, True] + [True] * (B - 2)
    check(neg.tolist() == want, f"negative control: rejected lanes "
                                f"{torch.nonzero(~neg).flatten()[:5].tolist()}, want [0]")
    log(f"# pairing gates: all {B} valid accept; lhs + G rejects lane 0 alone; the all-identity "
        f"lane accepts")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        decide(srs, lhs, rhs)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    best = min(times)
    log(f"# pairing at B={B}: best-of-3 {best * 1e3:.2f} ms = {B / best:.1f} checks/s (runs "
        f"{[round(t * 1e3, 2) for t in times]} ms) on {smi_line()}")
    return B / best


def pairing_kernel_checks(dev, kernels, decide_inputs, launches):
    """The pairing kernels against their plain versions: on the verify
    batch's own decide inputs, and at B = 1,024 on random lazy words
    (`miller_loop` over the fixture SRS's lines, `final_exp`, each
    `fq12_op` code; `cyclo_square` on cyclotomic-subgroup elements, also
    against the plain square); their times at B = 1, 256 and 1,024, the
    Fq12 inverse alone (`inversion_ms`), and their rows of the kernels
    line."""
    import torch

    from snark_verifier_tpu_torch.ff import FQ, FQ_FIELD, words_to_limbs
    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.pairing import pairing

    def canon_err(got, want):
        return word_err(FQ_FIELD.canon(words_to_limbs(got)), FQ_FIELD.canon(words_to_limbs(want)))

    def plain_timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.time() - t0) * 1e3

    (ml_args, f_path) = decide_inputs
    xs, ys, zs, dbl, addc, has_add, finals = ml_args
    npairs = xs.shape[1]
    errs = {"miller_loop": 0, "final_exp": 0, "fq12_op": 0}
    # the verify batch's own inputs
    cuda_ops.reset_launches()
    e = canon_err(pairing.miller_loop(*ml_args), pairing.miller_loop_plain(*ml_args))
    check(e == 0, "miller_loop differs from its plain version on the verify batch's inputs")
    e = word_err(pairing.final_exponentiation(f_path), pairing.final_exponentiation_plain(f_path))
    check(e == 0, "final_exp differs from its plain version on the verify batch's inputs")
    # random lazy words at B = 1,024
    rng = np.random.default_rng(8)
    B = PAIR_CHECK_B
    X, Y, Z = (rand_lazy_words(rng, (B, npairs), FQ.p, dev) for _ in range(3))
    got = pairing.miller_loop(X, Y, Z, dbl, addc, has_add, finals)
    want, ml_plain_ms = plain_timed(pairing.miller_loop_plain, X, Y, Z, dbl, addc, has_add, finals)
    errs["miller_loop"] = canon_err(got, want)
    check(errs["miller_loop"] == 0, "miller_loop differs from its plain version at B=1024")
    fr = rand_lazy_words(rng, (B, 2, 3, 2), FQ.p, dev)
    got = pairing.final_exponentiation(fr)
    want, fe_plain_ms = plain_timed(pairing.final_exponentiation_plain, fr)
    errs["final_exp"] = word_err(got, want)
    check(errs["final_exp"] == 0, "final_exp differs from its plain version at B=1024")
    gb = rand_lazy_words(rng, (B, 2, 3, 2), FQ.p, dev)
    g034 = rand_lazy_words(rng, (B, 3, 2), FQ.p, dev)
    # f^((p^6 - 1)(p^2 + 1)) of the random f: the cyclotomic square's inputs
    m = pairing.fq12_op_plain("mul", pairing.fq12_op_plain("conj", fr),
                              pairing.fq12_op_plain("inv", fr))
    cyc = pairing.fq12_op_plain("mul", pairing.fq12_op_plain("frob2", m), m)
    op_ms, op_plain_ms = {}, {}
    for op in pairing.OPS:
        a = cyc if op == "cyclo_square" else fr
        b = gb if op == "mul" else g034 if op == "mul_by_034" else None
        got = pairing.fq12_op(op, a, b)
        want, op_plain_ms[op] = plain_timed(pairing.fq12_op_plain, op, a, b)
        e = canon_err(got, want)
        check(e == 0, f"fq12_op {op} differs from its plain version at B=1024")
        if op == "cyclo_square":
            e = max(e, canon_err(got, pairing.fq12_op_plain("square", a)))
            check(e == 0, "fq12_op cyclo_square is not the square on the cyclotomic subgroup")
        errs["fq12_op"] = max(errs["fq12_op"], e)
        op_ms[op] = time_ms(lambda: pairing.fq12_op(op, a, b), 10)
    check_launches = {k: cuda_ops.LAUNCHES[k] for k in errs}
    log(f"# pairing kernels == their plain versions on the verify batch's decide inputs and at "
        f"B={B} on random lazy words (every fq12_op code; cyclo_square on cyclotomic-subgroup "
        f"elements, == the square); launches by these checks {check_launches}")
    runs = {
        "miller_loop": lambda n: (lambda a=tuple(t[:n].contiguous() for t in (X, Y, Z)):
                                  pairing.miller_loop(*a, dbl, addc, has_add, finals)),
        "final_exp": lambda n: (lambda a=fr[:n].contiguous(): pairing.final_exponentiation(a)),
    }
    ms = {name: {n: time_ms(fn(n), 5, warmup=1) for n in (B, PAIRING_BATCH, 1)}
          for name, fn in runs.items()}
    inv_ms = {n: time_ms(lambda a=fr[:n].contiguous(): pairing.fq12_op("inv", a), 5, warmup=1)
              for n in (B, 1)}
    fq12_bytes = 96 * 4
    line_bytes = (dbl.numel() + addc.numel() + finals.numel()) * 4
    rows = (
        ("miller_loop", ml_plain_ms, miller_muls(npairs, has_add), miller_muls(npairs, has_add),
         miller_depth(npairs, has_add), miller_depth(npairs, has_add, least=True),
         B * (3 * npairs * 32 + fq12_bytes) + line_bytes,
         "snark_verifier_tpu/pairing/pairing.py:151",
         ["snark_verifier_tpu/pairing/pairing.py:99"], [B, npairs, 8]),
        ("final_exp", fe_plain_ms, final_exp_muls(), final_exp_muls(least=True),
         final_exp_depth(), final_exp_depth(least=True), B * 2 * fq12_bytes,
         "snark_verifier_tpu/pairing/pairing.py:257",
         ["snark_verifier_tpu/pairing/fq12_vm.py:145"], [B, 2, 3, 2, 8]),
    )
    for name, pms, muls, least, depth, least_depth, nbytes, where, also, shape in rows:
        t = ms[name]
        ops = miller_ops(npairs, has_add) if name == "miller_loop" else 0
        bms, by = bound_ms(nbytes, B * least * MULADDS_PER_FQ_MUL)
        floor = least_depth * CHAIN_FLOOR_MS_PER_MUL
        clocks = t[1] * 1.98e6 / depth  # per dependent multiply of the kernel's own chain
        use = ptxas_usage(name + "_kernel")
        extra = dict(inversion_ms=inv_ms[B], inversion_ms_b1=inv_ms[1]) if name == "final_exp" else {}
        log(f"# {name}: B={B} {t[B]:.4f} ms, B={PAIRING_BATCH} {t[PAIRING_BATCH]:.4f} ms, B=1 "
            f"{t[1]:.4f} ms (bound {bms:.4f} ms, {by}, the least {least} multiplies a proof; chain "
            f"floor {floor:.4f} ms = the least critical path, {least_depth} dependent multiplies "
            f"at 272 clocks); the kernel runs {muls} multiplies a proof, {depth} of them dependent, "
            f"{clocks:.0f} clocks per level (a dependent multiply of its chain) at B=1"
            + (f", {t[1] * 1.98e6 / ops:.0f} per Fq12 operation ({ops})" if ops else "")
            + f"; plain {pms:.1f} ms; ptxas {use}"
            + (f"; the Fq12 inverse alone (fq12_op inv) {inv_ms[B]:.4f} ms at B={B}, "
               f"{inv_ms[1]:.4f} at B=1" if extra else "") + "; == plain version")
        kernels.append(dict(
            name=name, route="cuda", source="snark_verifier_tpu_torch/csrc/pairing_kernels.cu",
            replaces=where, also_replaces=also, launches=launches[name], max_abs_err=errs[name],
            ms=t[B], plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=None, shape=shape,
            ms_b1=t[1], ms_b256=t[PAIRING_BATCH], chain_floor_ms=floor,
            least_depth_muls=least_depth, depth_muls=depth, least_muls_per_proof=least,
            muls_per_proof=muls, clocks_per_level_b1=clocks, **extra,
            **({"clocks_per_fq12_op_b1": t[1] * 1.98e6 / ops, "fq12_ops": ops} if ops else {}),
            ptxas=use, launches_checks=check_launches[name], tolerance="exact, canonical"))
    bms, by = bound_ms(B * 3 * fq12_bytes, B * MULS_PER_FQ12_MUL * MULADDS_PER_FQ_MUL)
    floor = CHAIN_FLOOR_MS_PER_MUL  # one level: 18 independent Fq2 products
    use = ptxas_usage("fq12_op_kernel")
    log(f"# fq12_op at B={B} (ms per op): {({k: round(v, 4) for k, v in op_ms.items()})}; plain "
        f"{({k: round(v, 1) for k, v in op_plain_ms.items()})}; ptxas {use}")
    kernels.append(dict(
        name="fq12_op", route="cuda", source="snark_verifier_tpu_torch/csrc/pairing_kernels.cu",
        replaces="snark_verifier_tpu/tower/tower.py:223",
        also_replaces=["snark_verifier_tpu/pairing/pairing.py:213"], launches=launches["fq12_op"],
        max_abs_err=errs["fq12_op"], ms=op_ms["mul"], plain_ms=op_plain_ms["mul"], bound_ms=bms,
        bound_by=by, library_ms=None, shape=[B, 2, 3, 2, 8], timed="mul",
        chain_floor_ms=floor, ops_ms=op_ms, ops_plain_ms=op_plain_ms, ptxas=use,
        launches_checks=check_launches["fq12_op"], tolerance="exact, canonical"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2

    from snark_verifier_tpu_torch import _build
    from snark_verifier_tpu_torch.ec import (
        G1, from_affine_int, limbs_to_words, py_ec, to_affine_int, words_to_limbs,
    )
    from snark_verifier_tpu_torch.ff import FQ, FQ_FIELD, FR
    from snark_verifier_tpu_torch.msm import cuda_ops, msm, scalars_from_int
    from snark_verifier_tpu_torch.msm import pippenger as pip

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    log(f"# device: {name} (count {count}); nvidia-smi: {smi}")
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---------------------------------------------------------------- build
    t0 = time.time()
    lib_path = _build.build()
    log(f"# build: {time.time() - t0:.1f}s -> {lib_path.name}")
    for line in _build.build_log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"#   ptxas: {line.strip()}")
    _build.load_library()

    rng = np.random.default_rng(7)

    def canon_words(w):
        return FQ_FIELD.canon(words_to_limbs(w))

    # --------------------------------------------- add / double vs twin
    def rand_coords(b):
        """(b, 3, 16) Montgomery limbs of uniform values < p: arbitrary
        projective triples (RC15 is polynomial, so the twins agree on any)."""
        raw = rng.integers(0, 1 << 16, size=(b, 3, 16), dtype=np.int64)
        raw[..., 15] &= 0x1FFF  # < 2^253 < p
        return torch.as_tensor(raw, device=dev)

    P5 = py_ec.scalar_mul(py_ec.G1_GEN, 5)
    specials_a = from_affine_int([None, P5, P5, P5, None], device=dev)
    specials_b = from_affine_int([P5, None, P5, py_ec.neg(P5), None], device=dev)
    a = rand_coords(CHECK_B)
    b = rand_coords(CHECK_B)
    a[: len(specials_a)] = specials_a
    b[: len(specials_b)] = specials_b
    aw, bw = limbs_to_words(a), limbs_to_words(b)
    errs = {}
    # Every add/double launch from here to the main path is a check's or the
    # point ladder's, none the main paths' (reported as launches_kat).
    cuda_ops.reset_launches()
    out_k = cuda_ops.add(aw, bw)
    out_p = cuda_ops.add_plain(aw, bw)
    torch.cuda.synchronize()
    errs["add"] = int((canon_words(out_k) - canon_words(out_p)).abs().max())
    check(errs["add"] == 0, "add kernel disagrees with its twin")
    log(f"# add: lazy words bit-identical to the twin's: {torch.equal(out_k, out_p)}")
    got = to_affine_int(words_to_limbs(out_k[:5]))
    want = [P5, P5, py_ec.double(P5), None, None]
    check(got == want, f"add special lanes wrong: {got}")
    out_k = cuda_ops.double(aw)
    out_p = cuda_ops.double_plain(aw)
    torch.cuda.synchronize()
    errs["double"] = int((canon_words(out_k) - canon_words(out_p)).abs().max())
    check(errs["double"] == 0, "double kernel disagrees with its twin")
    log(f"# double: lazy words bit-identical to the twin's: {torch.equal(out_k, out_p)}")
    check(to_affine_int(words_to_limbs(out_k[1:2])) == [py_ec.double(P5)], "double of P wrong")
    log(f"# add/double vs twin at B={CHECK_B}: canonical-equal")
    kat = {k: cuda_ops.LAUNCHES[k] for k in ("add", "double")}

    # ------------------------------------------------- main path's inputs
    n = 1 << LOG2N
    t0 = time.time()
    offs = []
    pt = py_ec.G1_GEN
    for _ in range(LOG2N):
        offs.append(pt)
        pt = py_ec.double(pt)
    offs_w = limbs_to_words(from_affine_int(offs, device=dev))
    pts_w = limbs_to_words(from_affine_int([py_ec.G1_GEN], device=dev))
    for k in range(LOG2N):  # bench.py's doubling ladder: arr[i] = (i+1)·G
        step = cuda_ops.add(pts_w, offs_w[k : k + 1].expand_as(pts_w).contiguous())
        pts_w = torch.cat([pts_w, step], 0)
    points = words_to_limbs(pts_w)  # (n, 3, 16): the JAX package's layout
    torch.cuda.synchronize()
    log(f"# point gen [1..2^{LOG2N}]·G on the card: {time.time() - t0:.2f}s")
    check(to_affine_int(points[n - 1]) == py_ec.scalar_mul(py_ec.G1_GEN, n), "point ladder wrong")

    t0 = time.time()
    rng_k = np.random.default_rng(42)  # bench.py's scalars
    ks = [int.from_bytes(rng_k.bytes(32), "little") % FR.p for _ in range(n)]
    scalars = scalars_from_int(ks).to(dev)
    k_total = sum(s * (i + 1) for i, s in enumerate(ks)) % FR.p
    want = py_ec.scalar_mul(py_ec.G1_GEN, k_total)
    log(f"# scalars + oracle: {time.time() - t0:.2f}s")

    # ------------------------------------------ fold vs twin at real shapes
    points_ext = torch.cat([pts_w, pip._identity(1, dev)], 0)
    digits = pip.extract_digits(scalars, C_BITS)
    cap = pip.default_capacity(n, 1 << C_BITS)
    trange = pip.top_range(C_BITS)
    tcap = max(cap, pip.top_capacity(n, C_BITS))
    idx_all, _ = pip._slot_indices(digits[:-1], 1 << C_BITS, cap)  # (31, 256, cap)
    idx_top, _ = pip._slot_indices(digits[-1:], trange, tcap)
    idx_main, idx_top = idx_all[0].contiguous(), idx_top[0]
    idx_rows = idx_all.view(-1, cap)  # every main window's rows, as msm folds them
    errs["fold_buckets"] = 0
    plain_main = cuda_ops.fold_buckets_plain(points_ext, idx_main)
    plain_top = cuda_ops.fold_buckets_plain(points_ext, idx_top)
    for label, out_k, out_p in (
        ("main", cuda_ops.fold_buckets(points_ext, idx_main), plain_main),
        ("top", cuda_ops.fold_buckets(points_ext, idx_top), plain_top),
        ("top, split", cuda_ops.fold_buckets_split(points_ext, idx_top), plain_top),
    ):
        torch.cuda.synchronize()
        ga = to_affine_int(words_to_limbs(out_k))
        gb = to_affine_int(words_to_limbs(out_p))
        bad = sum(x != y for x, y in zip(ga, gb))
        check(bad == 0, f"fold_buckets ({label}) disagrees with its twin in {bad} buckets")
        errs["fold_buckets"] = max(errs["fold_buckets"], affine_err(out_k, out_p))
        check(errs["fold_buckets"] == 0, f"fold_buckets ({label}): affine words differ")
        log(f"# fold_buckets vs twin at {tuple(out_k.shape[:1])} buckets ({label}): affine-equal")
    # All main windows in one launch, against the plain version window by
    # window (its gathered matrix is 0.45 GB per window).
    out_all = cuda_ops.fold_buckets(points_ext, idx_rows).view(idx_all.shape[0], -1, 3, 8)
    for w in range(idx_all.shape[0]):
        out_p = plain_main if w == 0 else cuda_ops.fold_buckets_plain(points_ext, idx_all[w])
        eq = proj_equal(out_all[w], out_p)
        check(bool(eq.all()), f"fold_buckets (all windows in one launch): window {w} differs "
                              f"from its twin in {int((~eq).sum())} buckets")
        errs["fold_buckets"] = max(errs["fold_buckets"], affine_err(out_all[w], out_p))
    check(errs["fold_buckets"] == 0, "fold_buckets (all windows in one launch): affine words differ")
    log(f"# fold_buckets vs twin at {tuple(idx_rows.shape)} (all main windows, one launch): "
        f"affine-equal in every window")
    del out_all, plain_main, plain_top

    # ---------------------------------------------------------- main path
    cuda_ops.reset_launches()
    t0 = time.time()
    out, ovf = msm(points, scalars, c=C_BITS)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = dict(cuda_ops.LAUNCHES)
    log(f"# msm 2^{LOG2N} first call: {first_s:.3f}s, launches {launches}")
    for k in ("fold_buckets", "fold_segments", "bucket_reduce"):
        check(launches[k] > 0, f"kernel {k} was not launched on the main path")
    check(launches["fold_buckets"] <= 3, "more than 3 fold_buckets launches per msm")
    check(launches["bucket_reduce"] <= 2, "more than 2 bucket_reduce launches per msm")
    check(launches["add"] == 0 and launches["double"] == 0,
          "the msm launched the add or double kernel")
    check(not bool(ovf), "bucket overflow at 2^20")
    got = to_affine_int(out)
    check(got == want, "msm result != k_total·G")
    j = 12345
    check(ks[j] < FR.p - 1, "negative control needs k_j < r - 1")
    sc2 = scalars.clone()
    sc2[j] = scalars_from_int([ks[j] + 1])[0].to(dev)
    out2, ovf2 = msm(points, sc2, c=C_BITS)
    got2 = to_affine_int(out2)
    check(not bool(ovf2), "bucket overflow in the negative control")
    check(got2 != got, "negative control: perturbed scalar left the result unchanged")
    check(got2 == py_ec.add(got, py_ec.scalar_mul(py_ec.G1_GEN, j + 1)),
          "negative control: result moved by the wrong amount")
    log("# msm gates: no overflow, == k_total·G, negative control moved by (j+1)·G")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        out, _ = msm(points, scalars, c=C_BITS)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    best = min(times)
    log(f"# msm 2^{LOG2N} c={C_BITS}: best-of-3 {best * 1e3:.2f} ms = "
        f"{n / best:.1f} points/s (runs {[round(t * 1e3, 2) for t in times]} ms) "
        f"on {name}, {smi}")

    # Phases of one msm, host clock around synchronized steps.
    def phase(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.time() - t0) * 1e3

    (pe, d_all), t_prep = phase(lambda: (
        torch.cat([limbs_to_words(points), pip._identity(1, dev)], 0),
        pip.extract_digits(scalars, C_BITS)))
    (idx_all, idx_t), t_slots = phase(lambda: (
        pip._slot_indices(d_all[:-1], 1 << C_BITS, cap)[0],
        pip._slot_indices(d_all[-1:], trange, tcap)[0]))
    stacked, t_fold = phase(lambda: pip.bucket_sums(pe, idx_all, idx_t[0]))
    _, t_reduce = phase(lambda: pip.bucket_reduce(stacked, C_BITS))
    log(f"# msm phases (ms): prep {t_prep:.2f}, slot indices {t_slots:.2f}, "
        f"folds {t_fold:.2f}, reduce {t_reduce:.2f}")

    # ------------------------------------------------------ kernel timings
    W = pip.n_windows(C_BITS)
    nb = 1 << C_BITS
    scan_pairs = W * (nb - 2)  # first suffix-scan step of the weighted sums
    sa = rand_coords(scan_pairs)
    sb = rand_coords(scan_pairs)
    saw, sbw = limbs_to_words(sa), limbs_to_words(sb)
    one = saw[:1].contiguous()
    # The kernels against their twins at the shapes the host loops ran them
    # at before csrc/msm_loops.cu: the first suffix-scan step (8,128 pairs)
    # and one Horner point.
    cuda_ops.reset_launches()
    for label, out_k, out_p in (
        ("add", cuda_ops.add(saw, sbw), cuda_ops.add_plain(saw, sbw)),
        ("double", cuda_ops.double(one), cuda_ops.double_plain(one)),
    ):
        err = int((canon_words(out_k) - canon_words(out_p)).abs().max())
        check(err == 0, f"{label} kernel disagrees with its twin at {tuple(out_k.shape)}")
        errs[label] = max(errs[label], err)
    for k in kat:
        kat[k] += cuda_ops.LAUNCHES[k]
    kernels = []

    # The bucket reduction against its plain version on the main path's own
    # (32, 256) bucket sums; its bound is the least reduction's operations,
    # its yardstick the top window's chain.
    red_k = pip.bucket_reduce(stacked, C_BITS)
    torch.cuda.synchronize()
    t0 = time.time()
    red_p = pip.bucket_reduce_plain(stacked, C_BITS)
    torch.cuda.synchronize()
    red_plain_ms = (time.time() - t0) * 1e3
    errs["bucket_reduce"] = affine_err(red_k, red_p)
    check(errs["bucket_reduce"] == 0, "bucket_reduce differs from its plain version")
    ms = time_ms(lambda: pip.bucket_reduce(stacked, C_BITS), 20)
    r_adds, r_dbls = bucket_reduce_ops(*stacked.shape[:2], C_BITS)
    bms, by = bound_ms(stacked.numel() * 4 + POINT_BYTES,
                       r_adds * MULADDS_PER_ADD + r_dbls * MULADDS_PER_DOUBLE)
    floor = BUCKET_REDUCE_CHAIN_MULS * CHAIN_FLOOR_MS_PER_MUL
    log(f"# bucket_reduce at {tuple(stacked.shape[:2])}: {ms:.4f} ms (bound {bms:.6f} ms, "
        f"{by}; chain floor {floor:.4f} ms = {BUCKET_REDUCE_CHAIN_MULS} multiplies); plain "
        f"{red_plain_ms:.1f} ms; affine-equal to the plain version")
    kernels.append(dict(
        name="bucket_reduce", route="cuda", source="snark_verifier_tpu_torch/csrc/msm_loops.cu",
        replaces="snark_verifier_tpu/msm/pippenger.py:276",
        also_replaces=["snark_verifier_tpu/msm/pippenger.py:284"],
        launches=launches["bucket_reduce"], max_abs_err=errs["bucket_reduce"], ms=ms,
        plain_ms=red_plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
        shape=list(stacked.shape), chain_floor_ms=floor, tolerance="exact, affine"))

    ms = time_ms(lambda: cuda_ops.add(saw, sbw), 20)
    plain = time_ms(lambda: cuda_ops.add_plain(saw, sbw), 3, warmup=1)
    bms, by = bound_ms(3 * POINT_BYTES * scan_pairs, MULADDS_PER_ADD * scan_pairs)
    kernels.append(dict(
        name="add", route="cuda", source="snark_verifier_tpu_torch/csrc/msm_kernels.cu",
        replaces="snark_verifier_tpu/msm/pallas_ops.py:178", launches=launches["add"],
        launches_msm=launches["add"], launches_kat=kat["add"],
        max_abs_err=errs["add"], ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=None, shape=[scan_pairs, 3, 8], tolerance="exact, canonical"))

    ms = time_ms(lambda: cuda_ops.double(one), 50)
    plain = time_ms(lambda: cuda_ops.double_plain(one), 3, warmup=1)
    bms, by = bound_ms(2 * POINT_BYTES, MULADDS_PER_DOUBLE)
    kernels.append(dict(
        name="double", route="cuda", source="snark_verifier_tpu_torch/csrc/msm_kernels.cu",
        replaces="snark_verifier_tpu/msm/pallas_ops.py:657", launches=launches["double"],
        launches_msm=launches["double"], launches_kat=kat["double"],
        max_abs_err=errs["double"], ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=None, shape=[1, 3, 8], tolerance="exact, canonical"))

    fold_bounds = {}
    for label, idx in (("main", idx_main), ("all", idx_rows), ("top", idx_top)):
        live = (idx != n).sum(1)
        adds = int((live - 1).clamp(min=0).sum())
        n_bytes = points_ext.numel() * 4 + idx.numel() * 4 + idx.shape[0] * POINT_BYTES
        fold_bounds[label] = bound_ms(n_bytes, adds * MULADDS_PER_ADD)
    ms = time_ms(lambda: cuda_ops.fold_buckets(points_ext, idx_main), 5)
    ms_all = time_ms(lambda: cuda_ops.fold_buckets(points_ext, idx_rows), 3, warmup=1)
    ms_top = time_ms(lambda: cuda_ops.fold_buckets(points_ext, idx_top), 5)
    ms_split = time_ms(lambda: cuda_ops.fold_buckets_split(points_ext, idx_top), 5)
    plain = time_ms(lambda: cuda_ops.fold_buckets_plain(points_ext, idx_main), 1, warmup=1)
    bms, by = fold_bounds["main"]
    log(f"# fold_buckets: one main window {tuple(idx_main.shape)} {ms:.4f} ms (bound {bms:.4f}); "
        f"all main windows {tuple(idx_rows.shape)} in one launch {ms_all:.4f} ms (bound "
        f"{fold_bounds['all'][0]:.4f}); top window {tuple(idx_top.shape)} whole {ms_top:.4f} ms, "
        f"split (fold_buckets_split, with its fold_segments pass) {ms_split:.4f} ms (bound "
        f"{fold_bounds['top'][0]:.4f})")
    kernels.append(dict(
        name="fold_buckets", route="cuda", source="snark_verifier_tpu_torch/csrc/msm_kernels.cu",
        replaces="snark_verifier_tpu/msm/pallas_ops.py:490", launches=launches["fold_buckets"],
        max_abs_err=errs["fold_buckets"], ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=None, shape=list(idx_main.shape), tolerance="exact, affine",
        all_shape=list(idx_rows.shape), all_ms=ms_all, all_bound_ms=fold_bounds["all"][0],
        top_shape=list(idx_top.shape), top_ms=ms_top, top_split_ms=ms_split,
        top_bound_ms=fold_bounds["top"][0], launches_fold_segments_msm=launches["fold_segments"]))

    # add throughput at a large batch (the ladder's last step), for PERF.md
    big = 1 << 19
    ba, bb2 = pts_w[:big].contiguous(), pts_w[big:].contiguous()
    ms_big = time_ms(lambda: cuda_ops.add(ba, bb2), 10)
    ms_dbig = time_ms(lambda: cuda_ops.double(ba), 10)
    log(f"# add at B=2^19: {ms_big:.4f} ms ({big / ms_big / 1e6:.3f} G adds/s, bound "
        f"{bound_ms(3 * POINT_BYTES * big, MULADDS_PER_ADD * big)[0]:.4f} ms); "
        f"double at B=2^19: {ms_dbig:.4f} ms (bound "
        f"{bound_ms(2 * POINT_BYTES * big, MULADDS_PER_DOUBLE * big)[0]:.4f} ms)")
    del pts_w, points, points_ext, scalars, digits, sa, sb, saw, sbw, ba, bb2, stacked
    del idx_all, idx_rows, idx_main, idx_top, idx_t, pe, d_all
    torch.cuda.empty_cache()

    # ------------------------- the dense folds, the probe, the succinct verify
    t0 = time.time()
    dense_fold_phase(dev, kernels)
    log(f"# dense fold phase: {time.time() - t0:.1f}s")
    t0 = time.time()
    probe_phase(dev, kernels)
    log(f"# probe phase: {time.time() - t0:.1f}s")
    t0 = time.time()
    errs_field = field_checks(dev)
    log(f"# field checks: {time.time() - t0:.1f}s")
    t0 = time.time()
    rate, decide_inputs, verify_launches = verify_phase(dev, kernels, errs_field)
    log(f"# verify phase: {time.time() - t0:.1f}s; {rate:.1f} verify proofs/s")
    t0 = time.time()
    checks = pairing_phase(dev)
    log(f"# pairing phase: {time.time() - t0:.1f}s; {checks:.1f} checks/s")
    t0 = time.time()
    pairing_kernel_checks(dev, kernels, decide_inputs, verify_launches)
    log(f"# pairing kernel checks: {time.time() - t0:.1f}s")

    check("jax" not in sys.modules and "snark_verifier_tpu" not in sys.modules,
          "the port pulled in jax or the JAX package")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
