#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives `snark_verifier_tpu_torch` only (never jax, never snark_verifier_tpu):

1. environment: the card's name, the device count and its power limit;
2. builds the CUDA kernels from this checkout's sources (nvcc, sm_90a);
3. holds each kernel against its plain PyTorch twin on the card: `add` and
   `double` at B = 65,536 (with identity, P == Q and P == -Q lanes) exactly,
   after canonicalization (their launches here are reported as
   `launches_kat`; of the paths only step 25's sharded MSM launches `add`,
   for the fold of its partials); `fold_buckets` at
   the MSM's real shapes, in affine form: one main window (256, 4,624), all
   31 main windows in one launch (7,936, 4,624), and the top window (49,
   25,846) both whole and split into segments (`fold_buckets_split`);
4. the main path: `msm` at n = 2^20, c = 8 over [1..n]·G (built on the card
   with the add kernel) and bench.py's scalars (numpy seed 42), with every
   kernel's launch count read around that one call; gates: no overflow, the
   result equals k_total·G (python-int oracle), one incremented scalar
   moves the result by exactly (i+1)·G, at most 3 fold launches, exactly
   one `fold_segments` launch, at most 2 `bucket_reduce` launches and none
   of `add` or `double`; then best-of-3
   points/s; `bucket_reduce` against its plain version on that call's
   (32, 256) bucket sums, in affine form;
5. kernel timings with CUDA events at the main path's shapes, beside each
   kernel's bound and its plain twin's time;
6. the add-chain probe: CH = 16 chained RC15 adds, Fq multiplies and Fq
   squares at B = 256 and 2^17, bit-identical to 16 steps of their plain
   versions (the lone add's µs at B = 256 is each fold level's chain floor
   per dependent add);
7. the dense bucket folds (fold_buckets_chunked K=8, fold_buckets_halving 4
   layers per call, fold_buckets_grid_dense wb=512 4 layers) over the
   micro-benchmarks' (256, 4,624) matrix of G or the identity (numpy seed
   1), each run with its launch count read around it; gates: every bucket
   sum equals count·G (python-int oracle), one `fold_segments` launch per
   level (no padding copy, no other launch), every level equals its plain
   version slot for slot in affine form; ms per walk; per level its
   shape, team, the kernel's own time (calls queued behind a spin of the
   card), the `on_level` wall, chain floor and bound; every level's time at
   each team size; in step 5, `fold_buckets_split` at the top window for
   several SPLIT_ROWS;
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
   `msm_windowed`, `miller_loop`, `final_exp` and `points_to_fr` (the
   transcript's batched Fq -> Fr map), no single-op field launch and none
   of `add` or `double`; then best-of-3 verify proofs/s,
   and from three more runs the
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
   usage;
12. the GWC19 verify path: `batch_verify(..., "gwc")` at batch 1,024 (the
   16 committed gwcsnark fixtures tiled) with its launch counts read around
   one call; gates: every lane accepts, every lane's accumulator equals the
   port's python-int oracle for its fixture, a tampered instance rejects
   lane 0 alone, one launch each of `fr_tape`, `miller_loop`, `final_exp`
   and `points_to_fr`, two of `msm_windowed` (a side each), no single-op
   field launch; best-of-3 proofs/s, the
   steps of three runs, and the two MSM sides as launched beside one
   stacked launch;
13. the tree (bench.py's bench_tree): `tree_aggregate_root` over 1,024
   leaves (the vanilla-PLONK fixtures tiled) with its launch counts read
   around one call; gates: the root accepts, a tampered leaf 0 makes it
   reject, one `fr_powers` launch per fold level, one `points_to_fr`
   launch in the succinct phase and one per fold level (the affine
   normalisation and the Fq -> Fr map: 4 a tree) and no single-op field
   launch, each fold level (group 0
   of layer 1, the fold of the 32 group accumulators, the root) equals the
   python-int `create_proof` on the device's own inputs to that level;
   best-of-3 leaves/s, the phases of three runs, one traced tree's device
   time; then `aggregate_and_decide` on the same leaves (accepts; the
   tampered batch rejects);
14. `fr_powers` (a warp-scan a transcript) against `powers_plain` at the
   tree's shapes (32, 32), (1, 32), (1, 1), at (1,024, 33) and at n = 31,
   33, 64 and 65 (32 transcripts), its times, bound, chain floor (the
   scan's least depth, ceil(log2 n) + 1 products) and ptxas usage;
   `poseidon_absorb` at the fold's 32 states × 128 elements and
   `msm_windowed` at the fold's shapes, each against its plain version on
   random inputs and timed beside its chain floor;
15. instance-encoded old accumulators (the committed
   `snark_verifier_tpu_torch/fixtures/old_acc_*.json`, k = 4 on
   toy_srs(32)) on the card at batch 1,024: the limb decode alone equals
   the host codec with one launch each of `field_mul` (Fr), `field_canon`
   and `field_mul` (Fq); a batch's single-op field launches are those of
   the same protocol naming no accumulator (none: its map is one
   `points_to_fr`) plus exactly those three, with one `fr_tape` and one
   `msm_windowed`; every lane's [fresh, old] equals
   the port's python-int oracle; the valid snark accepts on every lane, the
   bogus one (on the curve, not a valid accumulator) rejects on every lane;
16. the keccak verify path: `batch_verify(..., "shplonk", "evm")` at batch
   1,024 (the 16 committed evmsnark fixtures, each first carried through
   `proof_to_bytes(fmt="evm")` -> `proof_from_bytes` and equal to its
   loaded streams, tiled) with its launch counts read around one call;
   gates: every lane accepts, every lane's accumulator equals the port's
   python-int oracle (`succinct_verify_native(..., transcript="evm")`), a
   tampered instance rejects lane 0 alone, a Poseidon read of the batch
   rejects every lane, one launch of `keccak_read` (the whole read, over
   the plan's recorded schedule) and none of `keccak_squeeze`, no
   `poseidon_absorb`, one each of `fr_tape`, `msm_windowed`, `miller_loop`
   and `final_exp`, no single-op field launch and no `points_to_fr` (the
   keccak read maps no point); best-of-3 keccak
   verify proofs/s, the steps of three runs, one traced batch;
17. the single squeeze (`svt_keccak_read` with a schedule of one squeeze,
   on the team permutation) against `squeeze_plain` (exact words) and the
   python `keccak256` at B = 1,024 for W = 1 ... 30 (all three tags,
   hash-sized raw words);
18. `keccak_read` on step 16's own read (its schedule, instance block and
   streams) against `read_plain` word for word, every challenge against the
   python-int `EvmTranscriptPy`'s, timed beside its bound, chain floor
   (the team's round depth) and ptxas usage; the same buffers as nine
   single squeezes, each against `squeeze_plain`, timed;
19. `field_inv` (binary GCD, `csrc/fe_inv.cuh`) against the canonical plain
   Fermat inverse and python ints in both fields at (1,024) and the tree's
   2,048, 64 and 4 elements (0, 1, p - 1, p, 2p - 1, 2p among them), each
   shape timed beside its bound and chain floor, with ptxas usage (no path
   launches it: `points_to_fr` inverts in its own launch);
20. `points_to_fr` against `points_to_fr_plain` word for word: affine mode
   on step 9's own (1,024, m, 2, 8) stream points and on lazy words,
   projective mode on each fold level's own points from step 13 and at the
   tree's 2,048, 64 and 4 points (Z = 1, random Z, identity lanes with
   Z = 0, p and 2p), each equal to the launches it replaced (affine: mul,
   canon, mul; projective: inv, mul, then the three) on the same inputs;
   each shape timed beside its bound, its chain floor and those launches,
   with ptxas usage;
21. the instance-committing-key read (the stub protocol of
   tests/test_instance_committing_key.py with 16 bases and a constant, 16
   instance sets tiled to batch 1,024): the plan's commitment before the
   read (`commit_instances`, one `msm_windowed` launch) absorbed as a lane
   point (one `points_to_fr`); gates: every lane's committed point equals
   `py_ec.msm` + constant, z and the next squeeze equal
   `PoseidonTranscriptPy`'s, exactly those launches and two
   `poseidon_absorb`.  Then the same batch with the keccak transcript,
   through the plan's recorded schedule (`keccak_challenges`); gates: every
   lane's challenges equal `EvmTranscriptPy`'s, one `msm_windowed`, one
   `points_to_fr` (`map_fr=False`: the commitments to canonical affine Fq
   words), one `keccak_read`, no `poseidon_absorb` and no single-op field
   launch, a tampered instance moves its own lane only; the normalisation
   timed against `affine_xy`'s two launches.  Then a whole protocol: the
   evmsnark fixtures' protocol given an instance committing key (its
   instance column queried, an extra stream scalar), through
   `batch_succinct_verify(..., "shplonk", "evm")` at 1,024; gates: every
   lane equals the python-int `succinct_verify_native(..., "evm")`, a
   tampered instance moves lane 0 alone, two `msm_windowed` (the
   commitment, the accumulator), one each of `points_to_fr`, `keccak_read`
   and `fr_tape`;
22. IPA openings at k = 11 (the committed
   `snark_verifier_tpu_torch/fixtures/ipa_openings_k11.json`): the 16
   without zk tiled to 1,024 and the 16 with zk tiled to 256 through
   `batch_ipa_verify`; gates: every lane accepts with the prover's ξ and U,
   eval + 1 on lane 0 rejects lane 0 alone, one `fr_tape`, one
   `msm_windowed` (lhs − rhs), one `points_to_fr`, k + 1 (+1 with zk)
   `poseidon_absorb`, no single-op field launch; best-of-3 IPA succinct
   proofs/s and the steps of three runs; the path's `fr_tape` and
   `msm_windowed` against their plain versions on their own inputs, timed;
23. BGH19 (the 4 committed multiopens tiled to 1,024: all accept with the
   prover's ξ, a tampered query eval rejects its lane alone), IpaAs (both
   committed folds, of 16 and of 4 zk accumulators: accept, the prover's
   ξ, the read timed) and `decide_all` at 2^11 points (the 16 opening
   accumulators and both folded ones accept, U = H rejects);
24. the decide at 2^20 points over step 4's [1..2^20]·G: `svt_ipa_h_coeffs`
   equals `h_coeffs_plain` word for word at k = 5, 11 and 20 and python
   ints (all at k = 5 and 11, a sample at 20); ξ from default_rng(24) and
   U = (Σ_j h_j·(j+1))·G by python ints: `decide` accepts U and rejects
   U + G with one `ipa_h_coeffs` launch and one MSM; best-of-3 ms beside
   the MSM alone; the kernel timed beside its bound, with its share of the
   bound, the bytes it stores a second and ptxas's registers, stack and
   spills.
25. the mesh paths (`parallel/`, `sdk/tree_aggregation.py`) on a mesh of this
   one card listed 4 times, at `__graft_entry__.py::dryrun_multichip`'s
   full sizes (the shards run one after another on the card: no scaling is
   claimed): `msm_sharded` at n = 2^20 over step 4's points and scalars
   (gates: == k_total·G, no overflow, one MSM a shard, exactly 2 `add`
   launches for the partials' fold, each equal to its plain version on its
   own inputs; best-of-3 ms beside step 4's and a 2^18 MSM's), its
   gathers (2: 4·96 + 4 B) and `predict_efficiency` at D = 2, 4, 8 from this
   run's MSM rate, add and gather times and the NVLink data-sheet figure;
   `batch_msm_sharded` on a (2, 2) mesh at the dryrun's (4, 32) and at (4,
   2^18), each element equal to the one-device `msm` and python ints;
   `batch_verify_sharded` at 1,024 (all accept, the shards' accumulators
   equal the one-device batch's, lane 0's tamper rejects it alone, the
   dryrun's 4-lane mixed pattern exact, one launch a shard of each verify
   kernel, no gather; proofs/s beside step 9's); `tree_aggregate_sharded`
   at 1,024 leaves (the root accepts, a tampered leaf rejects, every group
   of each fold level == `create_proof` on its own inputs, 2 gathers equal to
   `tree_comm_inventory`'s; leaves/s beside step 13's); then the warm start
   (`bench.py:243-280`): a fresh process loads the SRS and the fixtures
   and verifies 1,024 proofs through `batch_verify_sharded` on a one-device
   mesh, once over an empty `SNARK_AOT_DIR` and once over what the first
   left (the plan and the G2 lines loaded), each timed part by part, the
   hash of the sources that keys the cache included;
26. host proving (`system/`, `pcs/kzg/prover_py.py`, `pcs/ipa`), every
   commitment one `msm` on the card (`Srs.commit`, `IpaProvingKey.commit`
   through `msm/pippenger.py::msm_int`): `Srs.commit` equals `py_ec.msm`
   at n = 1, 4, 5, 1,023 and 1,024 (srs.bin's powers) and is None on an
   all-zero polynomial, its ms at n = 1, 64, 1,024 and 8,192;
   `compile_protocol` of `demo_spec(10)` equals `protocol.json`;
   `gen_snark` with seed 0 equals `snark_00.json` (SHPLONK, Poseidon),
   `gwcsnark_00.json` (GWC19) and `evmsnark_00.json` (SHPLONK, keccak);
   each through `batch_verify` at 16 lanes with its scheme and transcript
   (all accept, a tampered instance rejects lane 0 alone), and
   `verify_snark_native` accepts snark_00; with the committed k = 11 key,
   `Ipa.create_proof` rebuilds opening 0 without and with zk, `Bgh19.open`
   BGH19 opening 0 and `IpaAs.create_proof` the fold of the 16
   accumulators, each equal to its `ipa_*_k11.json` entry.  Each proof's
   wall, its commitments' share (synchronized) and the host's, its
   commitments and `msm` calls, and the kernels' launches it adds (the
   kernels line's `launches_host_proving`).
27. the EVM verifier, the CLI and the native oracle (host code beside the
   card): (a) `sdk.evm.gen_evm_verifier_report` for the evmsnark protocol
   (vanilla k = 10, SHPLONK, `srs.bin`): the Yul's bytes, the generation's
   seconds, the estimated gas and code size (under EIP-170's 24,576); the
   in-process interpreter on each of the 16 `evmsnark_*` proofs' EVM bytes
   and on lane 0 with `instances[0][0]` + 1, gas_used and seconds an
   execution; gates: the 16 accepted, the tampered one reverted, each
   verdict equal to the card's `batch_verify(the 16 + the tampered,
   "shplonk", "evm")` lane by lane; (b) the CLI in this process,
   `__main__.main([...])` on the card: verify (SHPLONK and GWC19),
   aggregate --n 4, aggregate-mixed, tree --n 16 --fanout 4, bench-msm
   --log2n 20 and gen-evm-verifier --k 3, each its PASS, wall, cost-meter
   span and kernel launches (the kernels line's `launches_cli`); gates:
   every command passes, the tree's meter counts 20 MSMs, 80 terms and 4
   pairings (2 MSMs and 2·N terms a fold of N, 2 pairings a decide: two
   trees of four group folds of 4 and a root fold of 4, two decides),
   gen-evm-verifier launches nothing; bench-msm's points/s beside step 4's;
   (c) `utils.native` (g++, the port's `csrc/host/bn254.cpp`): `available()`
   and `native.msm` over [1..1,024]·G with numpy seed 27's scalars equal to
   the card's `msm` and to k_total·G.

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
from pathlib import Path

import numpy as np

LOG2N = 20
C_BITS = 8
CHECK_B = 1 << 16
DENSE_SHAPE = (256, 4624)  # the Pallas fold micro-benchmarks' window
PROBE_BATCHES = (256, 1 << 17)
VERIFY_BATCH = 1024
PAIRING_BATCH = 256  # bench.py's BENCH_BATCH_PAIRING
PAIR_CHECK_B = 1024  # the pairing kernels' checks against their plain versions
TREE_LEAVES = 1024  # bench.py's BENCH_BATCH_TREE
SPLIT_SEGMENTS = (4, 7, 8, 12, 16, 24, 32, 48)  # fold_buckets_split's segments a top row, timed
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
# svt_msm_windowed (csrc/msm_loops.cuh): a ladder a team of T lanes over
# the 32 windows of 4 bits of a GLV half (ec/glv.py), T and the proofs a
# block from cuda_ops.msm_windowed_layout.
MSMW_WINDOWS = 32
# Dependent Fq multiplies of one group operation on a team of T lanes
# (csrc/g1_team.cuh; T = 1 is g1.cuh on one lane, T = 6 one product a lane
# and layer).  The least is 2 an operation, every product of a layer at
# once.
G1_ADD_CHAIN = {1: 12, 6: 2}
G1_DOUBLE_CHAIN = {1: 8, 6: 2}
# hadeshash poseidonperm_x5_254_3: the permutation of (0, 1, 2) (T = 3, R_F = 8,
# R_P = 57), the reference's Poseidon test vector.
PERM_X5_254_3 = [
    7853200120776062878684798364095072458815029376092732009249414926327459813530,
    7142104613055408817911962100316808866448378443474503659992478482890339429929,
    6549537674122432311777789598043107870002137484850126429160507761192163713804,
]

# The keccak permutation's least 32-bit logic instructions, each a LOP3 (up
# to three inputs and any function of them, so a five-lane XOR is two and
# chi's x ^ (~y & z) one) or a funnel shift (SHF: half of a 64-bit
# rotation) per 32-bit half, counted alike at the card's 32-bit integer
# rate (64 per SM per clock, IMAD_PER_S): theta's column parities
# 5 x 2 x 2, the rotations of its parities 5 x 2 SHF, and each lane's
# a ^ C[x-1] ^ rotl(C[x+1], 1) one LOP3 a half, 25 x 2 (D never has to
# exist on its own); rho's 24 rotations x 2 (lane 0 is not rotated); chi
# 25 x 2; iota one XOR per nonzero half of the round constant.  A block
# also XORs its 17 lanes into the state (34); a tagged word's from_mont is
# a Montgomery reduction (72 multiply-adds), the challenge one product
# (136).  A lone warp issues an integer instruction every two clocks (32
# threads on a scheduler's 16 integer lanes): its chain floor per block is
# 24 rounds of those instructions, the blocks chained.
KECCAK_OPS_PER_ROUND = 20 + 10 + 50 + 48 + 50
CLOCK_HZ = 1.98e9
MULADDS_FROM_MONT = 72
# svt_keccak_read runs the permutation as a warp a state (csrc/keccak.cuh's
# team permutation).  A round's critical path there is four dependent
# shuffle stages (the column's parity, D, pi, chi; a 64-bit shuffle is two
# independent 32-bit ones), each counted at KECCAK_SHFL_CLOCKS (a typical
# warp-shuffle latency, not measured on this card), beside ~10 dependent
# integer instructions at 4 clocks (the parity's two LOP3, D's funnel shift
# and XOR, a ^ D, the rotation's select and two funnel shifts, chi's LOP3,
# iota's XOR): a read's chain floor is that round x 24 rounds x its blocks.
KECCAK_SHFL_CLOCKS = 24
KECCAK_TEAM_ROUND_CLOCKS = 4 * KECCAK_SHFL_CLOCKS + 10 * 4
# svt_field_inv is csrc/fe_inv.cuh's binary GCD: rounds of 30 steps on
# 62-bit approximations, then a 2x2 update of the 256-bit values.  Its
# least work, at the card's 32-bit integer rate: 12 integer instructions a
# step (the 64-bit compare, swap, subtract and shift of a~ and b~, each
# factor row's subtract and doubling as one packed 64-bit word) and the
# update's 80 multiply-adds (4 combinations of 2 x 8 word products, 2
# reductions of 8), for the rounds these inputs take (`gcd_rounds`).  Its
# chain floor a round: 30 steps of 8 dependent integer instructions at 4
# clocks, then ~200 clocks of the update's carry chains; a warp waits for
# its slowest lane's rounds.
INV_STEPS = 30
INV_STEP_OPS = 12
INV_ROUND_MULADDS = 80
INV_STEP_CLOCKS = 8 * 4
INV_UPDATE_CLOCKS = 200


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound_ms(n_bytes, n_muladds):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_muladds / IMAD_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def msm_windowed_muladds(n):
    """Multiply-adds of the windowed MSM of n bases, the smaller of two
    schedules' counts: the reference's over the 64 windows of a whole
    scalar (a table of 14 adds a base; per window a tree of n - 1 adds, one
    add into the accumulator and 4 doublings: 78 n adds, 256 doublings), and
    the GLV halves' (ec/glv.py: the same 78 n adds over 2 n half-scalars of
    32 windows, 128 doublings, and 15 products by beta a base for the
    table of phi(P))."""
    dbls = min(256 * MULADDS_PER_DOUBLE,
               128 * MULADDS_PER_DOUBLE + 15 * n * MULADDS_PER_FQ_MUL)
    return 78 * n * MULADDS_PER_ADD + dbls


def msm_windowed_chain_muls(B, n, sms, least=False):
    """Fq multiplies on one team's chain in svt_msm_windowed at the
    wrapper's layout for B proofs of n bases on `sms` SMs: per ladder its
    table (14 adds), 32 windows of 2 adds (the top one's first into the
    identity) with the product by beta of the second's entry, 4 doublings
    before each but the top one, and the add into the team's sum; then the
    proof's tree over its tp teams.  The kernel's own at its team size, or
    with `least` 2 an operation on the same operations (each layer's
    products at once; the products by beta off the chain)."""
    from snark_verifier_tpu_torch.msm import cuda_ops

    team, per_block = cuda_ops.msm_windowed_layout(B, n, sms)
    tp, _ = cuda_ops.msm_windowed_geometry(n, team, per_block)
    ladders = -(-n // tp)
    adds = ladders * (14 + 2 * MSMW_WINDOWS + 1) + (tp - 1).bit_length()
    doubles = ladders * 4 * (MSMW_WINDOWS - 1)
    if least:
        return 2 * (adds + doubles)
    return (G1_ADD_CHAIN[team] * adds + G1_DOUBLE_CHAIN[team] * doubles
            + MSMW_WINDOWS * ladders)


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
# (its team's running sums 13, the suffix scan 5, the team weight 1, two
# xor trees 10) and 251 doublings (the team weight 3, the window's 2^248
# scale 248), on teams of BUCKET_REDUCE_TEAM lanes (csrc/msm_loops.cuh:
# RED_T); the least, 2 an operation.
BUCKET_REDUCE_TEAM = 6
BUCKET_REDUCE_CHAIN_MULS = (G1_ADD_CHAIN[BUCKET_REDUCE_TEAM] * 29
                            + G1_DOUBLE_CHAIN[BUCKET_REDUCE_TEAM] * 251)
BUCKET_REDUCE_LEAST_CHAIN_MULS = 2 * (29 + 251)


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


def kernel_ms(fn, reps, warmup=2):
    """Mean ms per call over `reps` calls queued behind a spin of the card
    (~2 ms), so that the host has launched them all before the first one
    runs: the kernels' own time, without the host's time per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def load_fixtures(prefix):
    """The fixture SRS and the 16 committed `prefix`_*.json snarks."""
    from pathlib import Path

    from snark_verifier_tpu_torch.sdk.snark import Snark
    from snark_verifier_tpu_torch.sdk.srs import load_params

    d = Path(__file__).resolve().parent / "benchmarks" / "fixtures" / "vanilla_k10"
    return (load_params(str(d / "srs.bin")),
            [Snark.load(str(d / f"{prefix}_{i:02d}.json")) for i in range(16)])


def tampered(s):
    """s with instances[0][0] moved by one."""
    from snark_verifier_tpu_torch.ff import FR
    from snark_verifier_tpu_torch.sdk.snark import Snark

    t = Snark(s.protocol, [list(c) for c in s.instances], s.scalars, s.points)
    t.instances[0][0] = (t.instances[0][0] + 1) % FR.p
    return t


def affine_pairs(lhs, rhs):
    from snark_verifier_tpu_torch.ec import to_affine_int, words_to_limbs

    return list(zip(to_affine_int(words_to_limbs(lhs)), to_affine_int(words_to_limbs(rhs))))


def best_of_3(fn):
    """(best, runs) host seconds of fn(), each call ended by a synchronize."""
    import torch

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    return min(times), times


def traced(fn):
    """(busy ms, wall ms, [(kernel, ms, count)] by device time) of one call
    under torch.profiler: the kernels' device time over the host-clock wall
    time of the same call; busy None when no device event was recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / 1e3
    events = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in on_card),
                    key=lambda e: -e[1])
    return (busy or None), wall, events


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


def word_ints(t):
    """The (n, 8) little-endian 32-bit words of a tensor as n python ints."""
    rows = t.cpu().numpy().astype("<u4")
    return [int.from_bytes(r.tobytes(), "little") for r in rows]


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


def level_work(nb, w, grp):
    """(adds, bytes) a `fold_segments` launch of grouping `grp` over an (nb,
    w) matrix needs: each slot's real members less one, and the matrix read
    once and the output written once."""
    G, CW, S, count, width = grp
    wout = width // count
    j = np.arange(wout)
    first = (j // G) * CW + j % G
    real = np.where(first < w, np.minimum(count, -(-(w - first) // S)), 0)
    return nb * int(np.maximum(real - 1, 0).sum()), (nb * w + nb * wout) * POINT_BYTES


def dense_fold_phase(dev, kernels, us_per_add):
    """The dense bucket-fold path: the three drivers over the
    micro-benchmarks' (256, 4,624) matrix of G or the identity.
    `us_per_add` is the lone add chain's µs per add (the probe at B = 256),
    each level's chain floor per dependent add."""
    import torch
    from snark_verifier_tpu_torch.ec import from_affine_int, limbs_to_words, py_ec, to_affine_int
    from snark_verifier_tpu_torch.ec import words_to_limbs
    from snark_verifier_tpu_torch.msm import cuda_ops

    NB, cap = DENSE_SHAPE
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(1)  # micro_pallas_fold20.py's matrix
    fill = rng.integers(0, 2, size=(NB, cap)).astype(bool)
    counts = fill.sum(1)
    g = limbs_to_words(from_affine_int([py_ec.G1_GEN], device=dev))[0]
    mat = torch.where(torch.from_numpy(fill).to(dev)[..., None, None], g,
                      cuda_ops.identity((), dev)).contiguous()
    want = [py_ec.scalar_mul(py_ec.G1_GEN, int(c)) for c in counts]
    drivers = {
        "fold_buckets_chunked": (lambda m, **k: cuda_ops.fold_buckets_chunked(m, K=8, **k),
                                 cuda_ops.chunked_levels(cap, 8)),
        "fold_buckets_halving": (lambda m, **k: cuda_ops.fold_buckets_halving(m, 4, **k),
                                 cuda_ops.halving_levels(cap, 4)),
        "fold_buckets_grid_dense": (
            lambda m, **k: cuda_ops.fold_buckets_grid_dense(m, wb=512, layers=4, **k),
            cuda_ops.grid_levels(cap, 512, 4)),
    }
    full_adds = NB * (cap - 1)
    full_bound = bound_ms(mat.numel() * 4 + NB * POINT_BYTES, full_adds * MULADDS_PER_ADD)
    launches, err, drv_ms, level_rows, sweep = 0, 0, {}, {}, {}
    for name, (drive, levels) in drivers.items():
        cuda_ops.reset_launches()
        out = drive(mat)
        torch.cuda.synchronize()
        n_launch = cuda_ops.LAUNCHES["fold_segments"]
        check(n_launch == len(levels), f"{name} launched fold_segments {n_launch} times for "
                                       f"{len(levels)} levels")
        launches += n_launch
        got = to_affine_int(words_to_limbs(out))
        bad = sum(x != y for x, y in zip(got, want))
        check(bad == 0, f"{name}: {bad} of {NB} bucket sums differ from count·G")
        drv_ms[name] = time_ms(lambda: drive(mat), 3, warmup=1)
        marks = []

        def on_level(m):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)

        start = torch.cuda.Event(enable_timing=True)
        start.record()
        drive(mat, on_level=on_level)
        torch.cuda.synchronize()
        walls = [start.elapsed_time(marks[0])] + [a.elapsed_time(b) for a, b in
                                                  zip(marks, marks[1:])]
        # Every level against its plain version, slot for slot in affine
        # form, on the kernel's own input; then the launch alone, timed.
        prev, rows = mat, []
        for i, grp in enumerate(levels):
            w = prev.shape[1]
            team = cuda_ops.grouping_team(NB, w, grp, sms)
            lk = cuda_ops.fold_segments(prev, *grp)
            lp = cuda_ops.fold_segments_plain(prev, *grp)
            torch.cuda.synchronize()
            eq = proj_equal(lk, lp)
            check(bool(eq.all()), f"{name}: level {i} differs from its plain version in "
                                  f"{int((~eq).sum())} slots")
            err = max(err, affine_err(lk, lp))
            check(err == 0, f"{name}: level {i}'s affine words differ from its plain version")
            ms = kernel_ms(lambda: cuda_ops.fold_segments(prev, *grp), 10)
            members = min(grp[3], -(-w // grp[2]))
            adds, n_bytes = level_work(NB, w, grp)
            rows.append(dict(
                shape=[NB, w], out=list(lk.shape[:2]), grouping=list(grp), team=team, ms=ms,
                wall_ms=walls[i], chain_floor_ms=cuda_ops.chain_adds(members, team) * us_per_add
                / 1e3, bound_ms=bound_ms(n_bytes, adds * MULADDS_PER_ADD)[0]))
            # every team the kernel takes, for the record of the wrapper's choice
            for t in cuda_ops.TEAMS:
                if t <= 2 * members:
                    key = f"{name} level {i} ({NB}, {w}) count {grp[3]}"
                    sweep.setdefault(key, {})[t] = kernel_ms(
                        lambda: cuda_ops.fold_segments(prev, *grp, team=t), 10)
            prev = lk
        level_rows[name] = rows
        log(f"# {name} at ({NB}, {cap}): {drv_ms[name]:.4f} ms, {n_launch} launches "
            f"(one per level), == count·G in all {NB} buckets, every level == plain version "
            f"slot for slot")
        for r in rows:
            log(f"#   level {tuple(r['shape'])} -> {tuple(r['out'])} count {r['grouping'][3]}: "
                f"team {r['team']}, kernel {r['ms']:.4f} ms (on_level wall {r['wall_ms']:.4f}), "
                f"chain floor {r['chain_floor_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    log(f"# dense fold bound (full fold, {full_adds} adds): {full_bound[0]:.4f} ms "
        f"({full_bound[1]})")
    for key, by_team in sweep.items():
        log(f"# fold_segments team sweep {key}: " +
            ", ".join(f"T={t} {ms:.4f}" for t, ms in by_team.items()) + " ms")
    first = cuda_ops.level_grouping(cap, 8)
    ms = kernel_ms(lambda: cuda_ops.fold_segments(mat, *first), 10)
    plain = time_ms(lambda: cuda_ops.fold_segments_plain(mat, *first), 1, warmup=1)
    lvl_adds, lvl_bytes = level_work(NB, cap, first)
    bms, by = bound_ms(lvl_bytes, lvl_adds * MULADDS_PER_ADD)
    kernels.append(dict(
        name="fold_segments", route="cuda", source="snark_verifier_tpu_torch/csrc/fold_kernels.cu",
        replaces="snark_verifier_tpu/msm/pallas_ops.py:246", launches=launches, max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
        shape=[NB, cap, 3, 8], timed="first K=8 level (one launch, queued behind a spin)",
        also_replaces=["snark_verifier_tpu/msm/pallas_ops.py:326",
                       "snark_verifier_tpu/msm/pallas_ops.py:589"],
        drivers_ms=drv_ms, levels=level_rows, team_sweep=sweep,
        full_fold_bound_ms=full_bound[0], us_per_add_b256=us_per_add,
        tolerance="exact, affine"))


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
    return rows[small][0] / CH * 1e3


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
            want = F.plain(op, *args)
            if op == "inv":  # the card's binary GCD is canonical, the plain Fermat lazy
                want = F.plain("canon", want)
            e = word_err(getattr(F, op)(*args), want)
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

    from snark_verifier_tpu_torch.ec import from_affine_int, limbs_to_words, py_ec
    from snark_verifier_tpu_torch.ec import to_affine_int, words_to_limbs
    from snark_verifier_tpu_torch.ff import FR, FRW, digits4, fr_tape
    from snark_verifier_tpu_torch.hash import absorb, absorb_plain, permute, permute_plain
    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.pairing import pairing
    from snark_verifier_tpu_torch.parallel import batch_verify
    from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21
    from snark_verifier_tpu_torch.sdk import aggregation as agg
    from snark_verifier_tpu_torch.verifier.plonk import verifier as pv
    from snark_verifier_tpu_torch.verifier.plonk.plan import succinct_plan

    B = VERIFY_BATCH
    t0 = time.time()
    srs, base = load_fixtures("snark")
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
        tam = tampered(base[0])
        oks_t = batch_verify([tam] + snarks[1:], srs)
    finally:
        fr_tape.run, pairing.miller_loop, pairing.final_exponentiation = real_tape, real_ml, real_fe
    path = ("fr_tape", "msm_windowed", "poseidon_absorb", "miller_loop", "final_exp",
            "points_to_fr")
    field = {k: v for k, v in launches.items() if k.startswith("field_")}
    log(f"# verify path launches per batch of {B}: "
        f"{ {k: launches[k] for k in path + ('add', 'double', 'fq12_op')} }; single-op field "
        f"kernels {field}")
    for k in path:
        check(launches[k] > 0, f"kernel {k} was not launched on the verify path")
    for k in ("fr_tape", "msm_windowed", "miller_loop", "final_exp", "points_to_fr"):
        check(launches[k] == 1, f"the verify batch launched {k} {launches[k]} times, not once")
    check(sum(field.values()) == 0,
          f"the verify batch launched {sum(field.values())} single-op field kernels, not 0")
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

    best, times = best_of_3(lambda: batch_verify(snarks, srs))
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

    # Device busy share of one batch, the decide's two kernels apart from
    # the succinct phase's.
    busy_ms, wall_ms, events = traced(lambda: batch_verify(snarks, srs))
    decide_ms = sum(ms for k, ms, _ in events if "miller_loop" in k or "final_exp" in k)
    if busy_ms:
        log(f"# verify device time (torch.profiler, one traced batch): {busy_ms:.2f} ms busy of "
            f"{wall_ms:.2f} ms wall = {busy_ms / wall_ms:.1%} busy; decide kernels {decide_ms:.2f} "
            f"ms, succinct {busy_ms - decide_ms:.2f} ms; top: " + ", ".join(
                f"{k[:40]} {ms:.2f} ms x{c}" for k, ms, c in events[:6]))
    else:
        log("# verify device time: not measured (the profiler recorded no device events)")

    # Kernel rows: times at the verify path's (1024, ·) shapes.
    rng = np.random.default_rng(5)
    a = rand_lazy_words(rng, (B,), FRW.spec.p, dev)
    b = rand_lazy_words(rng, (B,), FRW.spec.p, dev)
    inv_bytes, inv_ops, _ = inv_work([gcd_rounds(x, FRW.spec.p) for x in word_ints(a)])
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
        "field_inv": (lambda: FRW.inv(a), lambda: FRW.plain("inv", a), inv_bytes, inv_ops,
                      "snark_verifier_tpu/ff/jnp_field.py:211"),
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
    bms, by = bound_ms(pts.numel() * 4 + scs.numel() * 4 + B * POINT_BYTES,
                       B * msm_windowed_muladds(n))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chain = msm_windowed_chain_muls(B, n, sms)
    least = msm_windowed_chain_muls(B, n, sms, least=True)
    floor = chain * CHAIN_FLOOR_MS_PER_MUL
    ms_one = time_ms(lambda: cuda_ops.msm_windowed(pts[:1].contiguous(), scs[:1].contiguous()),
                     20)
    # The tree's fold level (64, 32), random bases and scalars.
    rng = np.random.default_rng(64)
    base = limbs_to_words(from_affine_int(py_ec.rand_points(32, seed=64), device=dev))
    pts64 = base.expand(64, 32, 3, 8).contiguous()
    ks = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(64 * 32)]
    raw = np.frombuffer(b"".join(k.to_bytes(32, "little") for k in ks), dtype="<i4")
    scs64 = torch.from_numpy(raw.reshape(64, 32, 8).copy()).to(dev)
    err64 = affine_err(cuda_ops.msm_windowed(pts64, scs64),
                       cuda_ops.msm_windowed_plain(pts64, digits4(scs64)))
    check(err64 == 0, "msm_windowed differs from its plain version at (64, 32)")
    ms64 = time_ms(lambda: cuda_ops.msm_windowed(pts64, scs64), 20)
    layouts = {shape: cuda_ops.msm_windowed_layout(*shape, sms)
               for shape in ((B, n), (1, n), (64, 32))}
    chains = {shape: (msm_windowed_chain_muls(*shape, sms),
                      msm_windowed_chain_muls(*shape, sms, least=True)) for shape in layouts}
    log(f"# msm_windowed at {tuple(pts.shape[:2])}: {ms:.4f} ms (bound {bms:.4f} ms, {by}; "
        f"chain floor {floor:.4f} ms = {chain} multiplies on a team, the least {least}); B=1 "
        f"{ms_one:.4f} ms; (64, 32) {ms64:.4f} ms; (team, proofs a block) {layouts}, chains "
        f"(kernel, least) {chains}; plain {plain_ms:.1f} ms; affine-equal to the plain version")
    kernels.append(dict(
        name="msm_windowed", route="cuda", source="snark_verifier_tpu_torch/csrc/msm_loops.cuh",
        replaces="snark_verifier_tpu/ec/curve.py:194",
        also_replaces=["snark_verifier_tpu/ec/curve.py:245"], launches=launches["msm_windowed"],
        max_abs_err=max(err, err64), ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=None, shape=list(pts.shape), chain_floor_ms=floor, chain_muls=chain,
        least_chain_muls=least, ms_b1=ms_one, ms_64x32=ms64,
        layouts={str(k): v for k, v in layouts.items()}, tolerance="exact, affine"))
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
    best, times = best_of_3(lambda: decide(srs, lhs, rhs))
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


def gwc_phase(dev, kernels):
    """The GWC19 verify path: batch_verify(..., "gwc") at batch 1,024 over
    the 16 committed gwcsnark fixtures, tiled.  Returns proofs/s."""
    import torch

    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.parallel import batch_verify
    from snark_verifier_tpu_torch.sdk import aggregation as agg
    from snark_verifier_tpu_torch.verifier.plonk import verifier as pv

    B = VERIFY_BATCH
    t0 = time.time()
    srs, base = load_fixtures("gwcsnark")
    snarks = [base[i % 16] for i in range(B)]
    oracle = [pv.succinct_verify_native(s, srs, "gwc")[0] for s in base]
    log(f"# gwc inputs: SRS + 16 fixtures + 16 oracle runs: {time.time() - t0:.2f}s")
    cuda_ops.reset_launches()
    oks = batch_verify(snarks, srs, "gwc")
    torch.cuda.synchronize()
    launches = dict(cuda_ops.LAUNCHES)
    path = ("fr_tape", "msm_windowed", "poseidon_absorb", "miller_loop", "final_exp",
            "points_to_fr")
    field = {k: v for k, v in launches.items() if k.startswith("field_") and v}
    log(f"# gwc path launches per batch of {B}: "
        f"{ {k: launches[k] for k in path + ('add', 'double')} }; single-op field kernels "
        f"{field}")
    for k in ("fr_tape", "miller_loop", "final_exp", "points_to_fr"):
        check(launches[k] == 1, f"the gwc batch launched {k} {launches[k]} times, not once")
    check(not field, f"the gwc batch launched single-op field kernels {field}")
    check(launches["msm_windowed"] == 2,
          f"the gwc batch launched msm_windowed {launches['msm_windowed']} times, not twice")
    check(launches["poseidon_absorb"] > 0, "the gwc batch launched no poseidon_absorb")
    check(launches["add"] == 0 and launches["double"] == 0, "the gwc batch launched add/double")
    check(bool(oks.all()), f"{int((~oks).sum())} of {B} valid gwc proofs rejected")
    # Each lane's accumulator against the oracle; the MSM's inputs captured.
    seen, kernel = [], cuda_ops.msm_windowed

    def capture(pts, scalars, c=4):
        seen.append((pts, scalars))
        return kernel(pts, scalars, c)

    cuda_ops.msm_windowed = capture
    try:
        (lhs, rhs), = agg.batch_succinct_verify(snarks, srs, "gwc")
    finally:
        cuda_ops.msm_windowed = kernel
    got = affine_pairs(lhs, rhs)
    bad = [b for b in range(B) if got[b] != oracle[b % 16]]
    check(not bad, f"{len(bad)} gwc lanes differ from the native oracle, first {bad[:5]}")
    oks_t = batch_verify([tampered(base[0])] + snarks[1:], srs, "gwc")
    check(not bool(oks_t[0]) and bool(oks_t[1:].all()),
          f"gwc tampered lane 0: rejected lanes {torch.nonzero(~oks_t).flatten()[:5].tolist()}")
    log(f"# gwc gates: all {B} lanes accept, their accumulators == the native oracle of their "
        f"fixture; the tampered instance rejects lane 0 alone")
    best, runs = best_of_3(lambda: batch_verify(snarks, srs, "gwc"))
    log(f"# gwc verify at batch {B}: best-of-3 {best * 1e3:.2f} ms = {B / best:.1f} proofs/s "
        f"(runs {[round(t * 1e3, 2) for t in runs]} ms) on {smi_line()}")
    steps = ("stack_s", "plan_s", "read_s", "gather_s", "fr_tape_s", "msm_s", "succinct_s",
             "decide_s")
    phases = []
    for _ in range(3):
        tm = {}
        batch_verify(snarks, srs, "gwc", timings=tm)
        phases.append(tm)
    log("# gwc steps (ms, the three runs): " + ", ".join(
        f"{k[:-2]} {[round(tm[k] * 1e3, 3) for tm in phases]}" for k in steps))
    # The two sides' MSMs: as launched (one launch a side), and, for
    # PERF.md, stacked into one launch with the rhs padded.
    sides = [(p.shape[1], p, s) for p, s in seen]
    desc = ", ".join(f"({p.shape[0]}, {n})" for n, p, _ in sides)
    ms_as = sum(time_ms(lambda p=p, s=s: cuda_ops.msm_windowed(p, s), 10) for _, p, s in sides)
    if len(sides) == 2:
        n = max(n for n, _, _ in sides)
        pts, scs = [], []
        for k, p, sc in sides:
            pts.append(torch.cat([p, p[:, :1].expand(-1, n - k, 3, 8)], 1))
            scs.append(torch.cat([sc, sc.new_zeros((B, n - k, 8))], 1))
        pts, scs = torch.cat(pts, 0).contiguous(), torch.cat(scs, 0).contiguous()
        stacked = cuda_ops.msm_windowed(pts, scs)
        check(affine_err(stacked[:B], lhs) == 0 and affine_err(stacked[B:], rhs) == 0,
              "the stacked gwc MSM differs from the two launches")
        ms_stacked = time_ms(lambda: cuda_ops.msm_windowed(pts, scs), 10)
        log(f"# gwc MSM sides {desc}: as launched {ms_as:.4f} ms; stacked into one launch at "
            f"{tuple(pts.shape[:2])} {ms_stacked:.4f} ms (same points)")
    else:
        ms_stacked = None
        log(f"# gwc MSM sides {desc}: {ms_as:.4f} ms")
    for row in kernels:
        if row["name"] == "msm_windowed":
            row.update(gwc_shapes=desc, gwc_ms=ms_as, gwc_stacked_ms=ms_stacked,
                       launches_gwc=launches["msm_windowed"])
        if row["name"] == "fr_tape":
            row["launches_gwc"] = launches["fr_tape"]
    return B / best, launches


def old_acc_phase(dev):
    """Instance-encoded old accumulators on the card: the committed
    old_acc_{valid,bogus}.json (a k = 4 snark carrying a folded accumulator
    as 12 limbs; tests/test_torch_old_accumulators.py writes them from the
    host prover), at batch 1,024."""
    import torch

    from snark_verifier_tpu_torch.ff import FRW
    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.parallel import batch_verify
    from snark_verifier_tpu_torch.pcs.kzg.accumulator import (
        accumulator_from_limbs,
        accumulator_from_limbs_int,
    )
    from snark_verifier_tpu_torch.sdk.aggregation import batch_succinct_verify
    from snark_verifier_tpu_torch.sdk.snark import Snark
    from snark_verifier_tpu_torch.sdk.srs import toy_srs
    from snark_verifier_tpu_torch.verifier.plonk import verifier as pv
    from pathlib import Path

    B = VERIFY_BATCH
    d = Path(__file__).resolve().parent / "snark_verifier_tpu_torch" / "fixtures"
    raw = {n: json.loads((d / f"old_acc_{n}.json").read_text()) for n in ("valid", "bogus")}
    valid, bogus = Snark.from_json(raw["valid"]), Snark.from_json(raw["bogus"])
    raw["valid"]["protocol"]["accumulator_indices"] = []
    plain = Snark.from_json(raw["valid"])  # the same proof, its protocol naming no accumulator
    srs = toy_srs(32)

    def field_launches():
        return {k: v for k, v in cuda_ops.LAUNCHES.items() if k.startswith("field_") and v}

    old = accumulator_from_limbs_int(valid.instances[0])
    limbs = FRW.from_int(valid.instances[0], dev)[:, None].expand(12, B, 8).unbind(0)
    cuda_ops.reset_launches()
    lhs, rhs = accumulator_from_limbs(limbs)
    torch.cuda.synchronize()
    decode = field_launches()
    check(decode == {"field_mul": 2, "field_canon": 1},
          f"the limb decode launched {decode}, not field_mul 2 and field_canon 1")
    check(affine_pairs(lhs, rhs) == [old] * B, "the card's limb decode differs from the host codec")
    want = pv.succinct_verify_native(valid, srs)
    check(want[1] == old, "the oracle's old accumulator differs from the host codec")
    cuda_ops.reset_launches()
    fresh_only = batch_succinct_verify([plain] * B, srs)
    torch.cuda.synchronize()
    base = field_launches()
    check(base == {} and cuda_ops.LAUNCHES["points_to_fr"] == 1,
          f"the batch naming no accumulator launched {base} and points_to_fr "
          f"{cuda_ops.LAUNCHES['points_to_fr']} times, not only points_to_fr once")
    cuda_ops.reset_launches()
    accs = batch_succinct_verify([valid] * B, srs)
    torch.cuda.synchronize()
    got = field_launches()
    log(f"# old accumulators at batch {B}: single-op field launches {got}; the same protocol "
        f"naming no accumulator {base}; the decode alone {decode}")
    check(got == {k: base.get(k, 0) + decode.get(k, 0) for k in base.keys() | decode.keys()},
          "the old-accumulator batch's field launches are not the plain batch's plus the decode's")
    check(cuda_ops.LAUNCHES["fr_tape"] == 1 and cuda_ops.LAUNCHES["msm_windowed"] == 1,
          "the old-accumulator batch's fr_tape / msm_windowed launches")
    check(len(accs) == 2, f"{len(accs)} accumulators, not [fresh, old]")
    lanes = list(zip(*(affine_pairs(l, r) for l, r in accs)))
    bad = [b for b in range(B) if list(lanes[b]) != want]
    check(not bad, f"{len(bad)} lanes' [fresh, old] differ from the oracle, first {bad[:5]}")
    check(affine_pairs(*fresh_only[0]) == [want[0]] * B,
          "the fresh accumulator differs with and without the old one")
    oks = batch_verify([valid] * B, srs)
    check(bool(oks.all()), f"{int((~oks).sum())} of {B} valid old-accumulator lanes rejected")
    oks = batch_verify([bogus] * B, srs)
    check(not bool(oks.any()), f"{int(oks.sum())} of {B} bogus old-accumulator lanes accepted")
    log(f"# old-accumulator gates: the decode == the host codec, every lane's [fresh, old] == "
        f"the native oracle, valid accepts and bogus rejects on all {B} lanes")


def tree_phase(dev):
    """bench.py's bench_tree on the port: tree_aggregate_root over 1,024
    leaves (the 16 committed vanilla-PLONK k=10 fixtures tiled), then
    aggregate_and_decide on the same leaves.  Returns (leaves/s, the tree's
    launch counts, the fold levels' (inputs, outputs))."""
    import torch

    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.pcs.kzg.accumulation import KzgAs
    from snark_verifier_tpu_torch.sdk.aggregation import aggregate_and_decide
    from snark_verifier_tpu_torch.sdk.tree_aggregation import tree_aggregate_root
    from snark_verifier_tpu_torch.transcript.poseidon_transcript import PoseidonTranscriptPy

    B = TREE_LEAVES
    srs, base = load_fixtures("snark")
    snarks = [base[i % 16] for i in range(B)]
    bad = [tampered(base[0])] + snarks[1:]
    levels, real = [], KzgAs._fold_once

    def capture(pairs):
        out = real(pairs)
        levels.append((pairs, out))
        return out

    KzgAs._fold_once = capture
    try:
        cuda_ops.reset_launches()
        lhs, rhs, ok = tree_aggregate_root(snarks, srs)
        torch.cuda.synchronize()
        launches = dict(cuda_ops.LAUNCHES)
    finally:
        KzgAs._fold_once = real
    path = ("fr_tape", "msm_windowed", "poseidon_absorb", "fr_powers", "miller_loop", "final_exp",
            "points_to_fr")
    log(f"# tree launches per tree of {B} leaves: "
        f"{ {k: v for k, v in launches.items() if v} }")
    for k in path:
        check(launches[k] > 0, f"kernel {k} was not launched on the tree path")
    g = KzgAs.group_size(B)
    want_shapes = ([(B // g, g), (1, B // g)] if g else [(1, B)]) + [(1, 1)]
    shapes = [tuple(p.shape[:2]) for p, _ in levels]
    check(shapes == want_shapes, f"the tree's fold levels {shapes}, not {want_shapes}")
    check(launches["fr_powers"] == len(shapes), "the tree did not launch fr_powers once per "
                                                "fold level")
    check(launches["points_to_fr"] == len(shapes) + 1,
          f"the tree launched points_to_fr {launches['points_to_fr']} times, not once in the "
          f"succinct phase and once per fold level ({len(shapes) + 1})")
    field = {k: v for k, v in launches.items() if k.startswith("field_") and v}
    check(not field, f"the tree launched single-op field kernels {field}")
    check(launches["miller_loop"] == 1 and launches["final_exp"] == 1, "the tree's decide")
    check(launches["add"] == 0 and launches["double"] == 0, "the tree launched add/double")
    check(ok.dtype == torch.bool and ok.shape == () and bool(ok), "the tree's root rejected")
    # Each level against the python-int prover on the device's own inputs:
    # group 0 of layer 1, the fold of the 32 group accumulators, the root.
    t0 = time.time()
    for k, (pairs, (l_out, r_out)) in enumerate(levels):
        pts = affine_pairs(pairs[0, :, 0], pairs[0, :, 1])
        want = KzgAs.create_proof(None, pts, PoseidonTranscriptPy())
        check(affine_pairs(l_out[:1], r_out[:1]) == [want],
              f"fold level {k} {shapes[k]} differs from create_proof on its inputs")
        if k:
            prev = torch.stack(levels[k - 1][1], 1)
            check(proj_equal(pairs[0], prev).all(), f"fold level {k} did not take level "
                                                    f"{k - 1}'s accumulators")
    check(proj_equal(levels[-1][1][0][0], lhs) and proj_equal(levels[-1][1][1][0], rhs),
          "the root is not the last fold level's")
    log(f"# tree gates: the root accepts; every fold level {shapes} (group 0 of layer 1, the "
        f"group accumulators, the root) == create_proof on its own inputs "
        f"({time.time() - t0:.2f}s)")
    _, _, ok_t = tree_aggregate_root(bad, srs)
    check(not bool(ok_t), "the tree with a tampered leaf 0 accepted")
    log("# tree gate: leaf 0's instances[0][0] + 1 makes the root reject")
    best, runs = best_of_3(lambda: tree_aggregate_root(snarks, srs))
    log(f"# tree at {B} leaves: best-of-3 {best * 1e3:.2f} ms = {B / best:.1f} leaves/s "
        f"(runs {[round(t * 1e3, 2) for t in runs]} ms) on {smi_line()}")
    keys = ("succinct_s", "fold_groups_s", "fold_top_s", "fold_root_s", "decide_s", "stack_s",
            "plan_s", "read_s", "gather_s", "fr_tape_s", "msm_s")
    phases = []
    for _ in range(3):
        tm = {}
        tree_aggregate_root(snarks, srs, timings=tm)
        phases.append(tm)
    log("# tree phases (ms, the three runs): " + ", ".join(
        f"{k[:-2]} {[round(tm[k] * 1e3, 3) for tm in phases]}" for k in keys if k in phases[0]))
    busy, wall, events = traced(lambda: tree_aggregate_root(snarks, srs))
    if busy:
        log(f"# tree device time (torch.profiler, one traced tree): {busy:.2f} ms busy of "
            f"{wall:.2f} ms wall = {busy / wall:.1%} busy; top: " + ", ".join(
                f"{k[:40]} {ms:.3f} ms x{c}" for k, ms, c in events[:8]))
    else:
        log("# tree device time: not measured (the profiler recorded no device events)")
    cuda_ops.reset_launches()
    ok_a = aggregate_and_decide(snarks, srs)
    torch.cuda.synchronize()
    agg_launches = {k: v for k, v in cuda_ops.LAUNCHES.items() if v}
    check(bool(ok_a), "aggregate_and_decide rejected the 1,024 valid leaves")
    check(not bool(aggregate_and_decide(bad, srs)), "aggregate_and_decide accepted the tampered "
                                                    "batch")
    best_a, _ = best_of_3(lambda: aggregate_and_decide(snarks, srs))
    log(f"# aggregate_and_decide at {B}: accepts, the tampered batch rejects; launches "
        f"{agg_launches}; best-of-3 {best_a * 1e3:.2f} ms = {B / best_a:.1f} proofs/s")
    return B / best, launches, levels


def accumulation_kernel_checks(dev, kernels, launches, levels):
    """svt_fr_powers against powers_plain at the tree's shapes, with its
    bound, chain floor and ptxas usage; svt_poseidon_absorb and
    svt_msm_windowed at the fold's shapes on random inputs, against their
    plain versions, timed."""
    import torch

    from snark_verifier_tpu_torch.ff import FRW, digits4
    from snark_verifier_tpu_torch.hash import absorb, absorb_plain
    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.pcs.kzg.accumulation import powers, powers_plain

    rng = np.random.default_rng(11)
    shapes = [(32, 32), (1, 32), (1, 1), (1024, 33), (32, 31), (32, 33), (32, 64), (32, 65)]
    rs = {B: rand_lazy_words(rng, (B,), FRW.spec.p, dev) for B, _ in shapes}
    err = 0
    for B, n in shapes:
        e = word_err(powers(rs[B], n), powers_plain(rs[B], n))
        check(e == 0, f"fr_powers differs from powers_plain at ({B}, {n})")
        err = max(err, e)
    ms = {(B, n): kernel_ms(lambda B=B, n=n: powers(rs[B], n), 50) for B, n in shapes}
    plain_ms = time_ms(lambda: powers_plain(rs[32], 32), 1, warmup=1)
    bounds = {(B, n): fr_powers_bound(B, n) for B, n in shapes}
    floors = {(B, n): fr_powers_depth(n) * CHAIN_FLOOR_MS_PER_MUL for B, n in shapes}
    use = ptxas_usage("fr_powers_kernel")
    bms, by = bounds[(32, 32)]
    log("# fr_powers (a warp-scan a transcript): " + "; ".join(
        f"({B}, {n}) {ms[(B, n)]:.4f} ms (bound {bounds[(B, n)][0]:.6f} ms, chain floor "
        f"{floors[(B, n)]:.4f} ms = {fr_powers_depth(n)} products)" for B, n in shapes)
        + f"; plain at (32, 32) {plain_ms:.1f} ms; ptxas {use['registers']} registers, "
          f"{use['spill_bytes']} B spill, {use['stack_bytes']} B stack; == powers_plain word "
          f"for word")
    kernels.append(dict(
        name="fr_powers", route="cuda",
        source="snark_verifier_tpu_torch/csrc/accumulation_kernels.cu",
        replaces="snark_verifier_tpu/pcs/kzg/accumulation.py:196", launches=launches["fr_powers"],
        max_abs_err=err, ms=ms[(32, 32)], plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=None, shape=[32, 32, 8], chain_floor_ms=floors[(32, 32)],
        shapes=[dict(B=B, n=n, ms=ms[(B, n)], bound_ms=bounds[(B, n)][0],
                     bound_by=bounds[(B, n)][1], chain_floor_ms=floors[(B, n)],
                     depth_products=fr_powers_depth(n)) for B, n in shapes],
        ms_1x32=ms[(1, 32)], ms_1x1=ms[(1, 1)], ms_1024x33=ms[(1024, 33)],
        bound_ms_1x32=bounds[(1, 32)][0], bound_ms_1x1=bounds[(1, 1)][0],
        chain_floor_ms_1x32=floors[(1, 32)], chain_floor_ms_1x1=floors[(1, 1)],
        ptxas_registers=use["registers"], ptxas_spill_bytes=use["spill_bytes"],
        ptxas_stack_bytes=use["stack_bytes"], tolerance="exact, canonical words"))
    # The fold's absorb: 32 transcripts of 128 elements, 65 chained
    # permutations each; its chain floor is 65 permutations of 390
    # multiplies a lane.
    st = rand_lazy_words(rng, (32, 3), FRW.spec.p, dev)
    buf = rand_lazy_words(rng, (32, 128), FRW.spec.p, dev)
    n_perm = 128 // 2 + 1
    ab_err = word_err(absorb(st, buf), absorb_plain(st, buf))
    check(ab_err == 0, "poseidon_absorb differs from absorb_plain at the fold's (32, 128)")
    ab_ms = kernel_ms(lambda: absorb(st, buf), 20)
    ab_floor = n_perm * POSEIDON_CHAIN_MULS * CHAIN_FLOOR_MS_PER_MUL
    ab_bound = bound_ms((2 * 96 + 32 * 128) * 32,
                        n_perm * MULS_PER_PERMUTATION * MULADDS_PER_FQ_MUL * 32)[0]
    # The fold's MSM: both sides of the 32 groups (64, 32) and of the top (2, 32).
    msm_ms = {}
    for label, (p, _) in zip(("groups", "top"), levels[:-1]):
        pts = torch.cat([p[:, :, 0], p[:, :, 1]], 0).contiguous()
        scs = powers(rand_lazy_words(rng, (pts.shape[0],), FRW.spec.p, dev), pts.shape[1])
        msm_err = affine_err(cuda_ops.msm_windowed(pts, scs),
                             cuda_ops.msm_windowed_plain(pts, digits4(scs)))
        check(msm_err == 0, f"msm_windowed differs from its plain version at the fold's "
                            f"{tuple(pts.shape[:2])}")
        msm_ms[label] = (tuple(pts.shape[:2]), kernel_ms(lambda: cuda_ops.msm_windowed(pts, scs),
                                                         10))
    log(f"# poseidon_absorb at the fold's (32, 128): {ab_ms:.4f} ms ({n_perm} chained "
        f"permutations; chain floor {ab_floor:.4f} ms, bound {ab_bound:.4f} ms); msm_windowed at "
        + ", ".join(f"{s} {t:.4f} ms" for s, t in msm_ms.values())
        + "; each == its plain version on the same random inputs")
    for row in kernels:
        if row["name"] == "poseidon_absorb":
            row.update(fold_shape=[32, 128], fold_ms=ab_ms, fold_chain_floor_ms=ab_floor,
                       fold_bound_ms=ab_bound, launches_tree=launches["poseidon_absorb"])
        if row["name"] == "msm_windowed":
            row.update(fold_shapes=[list(s) for s, _ in msm_ms.values()],
                       fold_ms=[t for _, t in msm_ms.values()],
                       launches_tree=launches["msm_windowed"])
        if row["name"] in ("fr_tape", "miller_loop", "final_exp", "field_inv", "field_mul",
                           "field_canon", "points_to_fr"):
            row["launches_tree"] = launches[row["name"]]


def fr_powers_bound(B, n):
    """svt_fr_powers' least work: n - 1 products and n from_mont reductions
    a transcript; r read and the powers written once."""
    return bound_ms(B * 32 + B * n * 32,
                    B * ((n - 1) * MULADDS_PER_FQ_MUL + n * MULADDS_FROM_MONT))


def fr_powers_depth(n):
    """The least depth of [1, r, ..., r^(n-1)] in dependent products: a
    scan of ceil(log2 n) rounds, then the from_mont product."""
    return (n - 1).bit_length() + 1


def keccak_permutation_ops():
    from snark_verifier_tpu_torch.hash.keccak import _ROUND_CONSTANTS

    iota = sum((rc & 0xFFFFFFFF != 0) + (rc >> 32 != 0) for rc in _ROUND_CONSTANTS)
    return len(_ROUND_CONSTANTS) * KECCAK_OPS_PER_ROUND + iota


def keccak_squeeze_work(B, tags):
    """(bytes, operations, chain floor ms, blocks) of one squeeze over B
    buffers of len(tags) words on svt_keccak_read's team permutation."""
    from snark_verifier_tpu_torch.hash.keccak_device import pad_lanes

    W = len(tags)
    pad, nblocks = pad_lanes(W)
    tagged = sum(1 for t in tags if t)
    n_bytes = B * (32 * W + 64) + 12 * W + pad.nbytes
    n_ops = B * (nblocks * (keccak_permutation_ops() + 34) + tagged * MULADDS_FROM_MONT + 136)
    floor = nblocks * 24 * KECCAK_TEAM_ROUND_CLOCKS / CLOCK_HZ * 1e3
    return n_bytes, n_ops, floor, nblocks


def gcd_rounds(x, p):
    """The rounds csrc/fe_inv.cuh's binary GCD takes to invert the word x."""
    a, b, rounds = x % p, p, 0
    while a:
        rounds += 1
        n = max(a.bit_length(), b.bit_length(), 2 * INV_STEPS + 2)
        low = (1 << INV_STEPS) - 1
        xa = (a & low) | ((a >> (n - INV_STEPS - 2)) << INV_STEPS)
        xb = (b & low) | ((b >> (n - INV_STEPS - 2)) << INV_STEPS)
        f0, g0, f1, g1 = 1, 0, 0, 1
        for _ in range(INV_STEPS):
            if xa & 1:
                if xa < xb:
                    xa, xb, f0, g0, f1, g1 = xb, xa, f1, g1, f0, g0
                xa, f0, g0 = xa - xb, f0 - f1, g0 - g1
            xa, f1, g1 = xa >> 1, 2 * f1, 2 * g1
        a, b = abs(f0 * a + g0 * b) >> INV_STEPS, abs(f1 * a + g1 * b) >> INV_STEPS
    return rounds


def inv_work(rounds):
    """(bytes, operations, chain floor ms) of one svt_field_inv launch whose
    elements take these rounds (32 lanes a warp)."""
    n_ops = sum(rounds) * (INV_STEPS * INV_STEP_OPS + INV_ROUND_MULADDS)
    floor = max(rounds) * (INV_STEPS * INV_STEP_CLOCKS + INV_UPDATE_CLOCKS) / CLOCK_HZ * 1e3
    return 2 * 32 * len(rounds), n_ops, floor


def evm_phase(dev, kernels):
    """The keccak (EVM) verify path: batch_verify(..., "shplonk", "evm") at
    batch 1,024 over the 16 committed evmsnark fixtures, tiled, each first
    carried through its EVM proof bytes.  Returns (proofs/s, its launch
    counts, the read's (schedule, instances, scalars, points) of one batch,
    the 16 fixtures' challenges from the python-int transcript)."""
    import torch

    from snark_verifier_tpu_torch.hash import keccak_device
    from snark_verifier_tpu_torch.loader.base import NATIVE
    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.parallel import batch_verify
    from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21
    from snark_verifier_tpu_torch.sdk import aggregation as agg
    from snark_verifier_tpu_torch.sdk.proof_io import proof_from_bytes, proof_to_bytes
    from snark_verifier_tpu_torch.transcript import EvmTranscriptPy
    from snark_verifier_tpu_torch.verifier.plonk import verifier as pv

    B = VERIFY_BATCH
    t0 = time.time()
    srs, loaded = load_fixtures("evmsnark")
    base = []
    for s in loaded:
        back = proof_from_bytes(s.protocol, s.instances, proof_to_bytes(s, "shplonk", "evm"),
                                "shplonk", "evm")
        check(back.scalars == s.scalars and back.points == s.points,
              "an evmsnark fixture did not survive its EVM proof bytes")
        base.append(back)
    snarks = [base[i % 16] for i in range(B)]
    oracle = [pv.succinct_verify_native(s, srs, "shplonk", "evm")[0] for s in base]
    challenges = []
    for s in base:
        t = EvmTranscriptPy(s.scalars, s.points)
        pv.PlonkSuccinctVerifier.read_proof(s.protocol, [list(c) for c in s.instances], t,
                                            Bdfg21, NATIVE)
        challenges.append(t.challenges)
    log(f"# evm inputs: SRS + 16 fixtures through proof_to_bytes(fmt='evm') -> "
        f"proof_from_bytes, streams equal + 16 oracle runs: {time.time() - t0:.2f}s")
    reads, real = [], keccak_device.read

    def capture(schedule, inst, scalars, points, lanes=None):
        check(lanes is None, "the evm batch read lane points: its protocol commits none")
        reads.append((schedule, inst, scalars, points))
        return real(schedule, inst, scalars, points)

    keccak_device.read = capture
    try:
        cuda_ops.reset_launches()
        oks = batch_verify(snarks, srs, "shplonk", "evm")
        torch.cuda.synchronize()
        launches = dict(cuda_ops.LAUNCHES)
    finally:
        keccak_device.read = real
    field = {k: v for k, v in launches.items() if k.startswith("field_")}
    path = ("keccak_read", "fr_tape", "msm_windowed", "miller_loop", "final_exp")
    shown = path + ("keccak_squeeze", "poseidon_absorb", "add", "double")
    log(f"# evm path launches per batch of {B}: { {k: launches[k] for k in shown} }; "
        f"single-op field kernels {field} ({sum(field.values())} in all)")
    for k in path:
        check(launches[k] == 1, f"the evm batch launched {k} {launches[k]} times, not once")
    check(launches["keccak_squeeze"] == 0, "the evm batch launched the per-squeeze keccak")
    check(sum(field.values()) == 0 and launches["points_to_fr"] == 0,
          "the evm batch launched a single-op field kernel or points_to_fr")
    check(launches["poseidon_absorb"] == 0, "the evm batch launched poseidon_absorb")
    check(launches["add"] == 0 and launches["double"] == 0, "the evm batch launched add/double")
    check(len(reads) == 1, f"the evm batch ran {len(reads)} keccak reads, not one")
    check(oks.dtype == torch.bool and tuple(oks.shape) == (B,), "batch_verify's result shape")
    check(bool(oks.all()), f"{int((~oks).sum())} of {B} valid evm proofs rejected")
    (lhs, rhs), = agg.batch_succinct_verify(snarks, srs, "shplonk", "evm")
    got = affine_pairs(lhs, rhs)
    bad = [b for b in range(B) if got[b] != oracle[b % 16]]
    check(not bad, f"{len(bad)} evm lanes differ from the native oracle, first {bad[:5]}")
    oks_t = batch_verify([tampered(base[0])] + snarks[1:], srs, "shplonk", "evm")
    check(not bool(oks_t[0]) and bool(oks_t[1:].all()),
          f"evm tampered lane 0: rejected lanes {torch.nonzero(~oks_t).flatten()[:5].tolist()}")
    oks_p = batch_verify(snarks, srs, "shplonk", "poseidon")
    check(not bool(oks_p.any()), f"a Poseidon read accepted {int(oks_p.sum())} evmsnark lanes")
    log(f"# evm gates: all {B} lanes accept, their accumulators == the native oracle of their "
        f"fixture; the tampered instance rejects lane 0 alone; read through Poseidon every "
        f"lane rejects; one keccak_read launch, no per-squeeze launch")
    best, runs = best_of_3(lambda: batch_verify(snarks, srs, "shplonk", "evm"))
    log(f"# evm verify at batch {B}: best-of-3 {best * 1e3:.2f} ms = {B / best:.1f} keccak "
        f"verify proofs/s (runs {[round(t * 1e3, 2) for t in runs]} ms) on {smi_line()}")
    steps = ("stack_s", "plan_s", "read_s", "gather_s", "fr_tape_s", "msm_s", "succinct_s",
             "decide_s")
    phases = []
    for _ in range(3):
        tm = {}
        batch_verify(snarks, srs, "shplonk", "evm", timings=tm)
        phases.append(tm)
    log("# evm steps (ms, the three runs): " + ", ".join(
        f"{k[:-2]} {[round(tm[k] * 1e3, 3) for tm in phases]}" for k in steps))
    busy, wall, events = traced(lambda: batch_verify(snarks, srs, "shplonk", "evm"))
    if busy:
        kec = [(ms, c) for k, ms, c in events if "keccak" in k]
        log(f"# evm device time (torch.profiler, one traced batch): {busy:.2f} ms busy of "
            f"{wall:.2f} ms wall = {busy / wall:.1%} busy; keccak_read "
            f"{sum(ms for ms, _ in kec):.4f} ms in {sum(c for _, c in kec)} launches; top: "
            + ", ".join(f"{k[:40]} {ms:.3f} ms x{c}" for k, ms, c in events[:8]))
    else:
        log("# evm device time: not measured (the profiler recorded no device events)")
    return B / best, launches, reads[0], challenges


def keccak_kernel_checks(dev):
    """The single squeeze (svt_keccak_read with a schedule of one squeeze)
    against squeeze_plain and the python oracle at B = 1,024 for W = 1 ...
    30 on random words of all three tags (raw words of hash size, >= 5r).
    Returns (the largest word difference, its launches)."""
    import torch

    from snark_verifier_tpu_torch.ff import FQ, FR
    from snark_verifier_tpu_torch.hash.keccak import keccak256
    from snark_verifier_tpu_torch.hash.keccak_device import TAG_FR, TAG_RAW, squeeze, squeeze_plain
    from snark_verifier_tpu_torch.msm import cuda_ops

    B = VERIFY_BATCH
    rng = np.random.default_rng(17)
    R = 1 << 256
    err, past_2r, past_5r = 0, 0, 0
    t0 = time.time()
    cuda_ops.reset_launches()
    for W in range(1, 31):
        tags = [int(t) for t in rng.integers(0, 3, size=W)]
        tags[0] = W % 3
        cols = []
        for t in tags:
            if t == TAG_RAW:
                vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(B)]
                vals[0] = R - 1 - int(rng.integers(0, 1 << 30))  # a hash >= 5r
            else:
                p = FR.p if t == TAG_FR else FQ.p
                vals = [int.from_bytes(rng.bytes(32), "little") % (2 * p + 1) for _ in range(B)]
                vals[:2] = [p, 2 * p]
            raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), "<i4")
            cols.append(torch.from_numpy(raw.reshape(B, 8).copy()))
        words = torch.stack(cols, 1).contiguous().to(dev)
        h, c = squeeze(words, tags)
        hp, cp = squeeze_plain(words, tags)
        torch.cuda.synchronize()
        e = max(word_err(h, hp), word_err(c, cp))
        check(e == 0, f"keccak_squeeze differs from squeeze_plain at W = {W}")
        err = max(err, e)
        # every lane's challenge against python ints, the hashes past 2r
        # and 5r (outside fe_mul's [0, 2r] inputs) counted
        for hv, cv in zip(word_ints(h), word_ints(c)):
            check(cv % FR.p == hv * R % FR.p and cv < 2 * FR.p,
                  f"keccak_squeeze's challenge is not the hash mod r at W = {W}")
            past_2r += hv >= 2 * FR.p
            past_5r += hv >= 5 * FR.p
        host = words[:4].cpu()
        for b in range(host.shape[0]):
            data = b""
            for t, row in zip(tags, host[b]):
                v = sum((int(x) & 0xFFFFFFFF) << (32 * i) for i, x in enumerate(row))
                if t != TAG_RAW:
                    p = FR.p if t == TAG_FR else FQ.p
                    v = v * pow(R, -1, p) % p
                data += v.to_bytes(32, "big")
            want = int.from_bytes(keccak256(data + (b"\x01" if W == 1 else b"")), "big")
            hv = sum((int(x) & 0xFFFFFFFF) << (32 * i) for i, x in enumerate(h[b].cpu()))
            cv = sum((int(x) & 0xFFFFFFFF) << (32 * i) for i, x in enumerate(c[b].cpu()))
            check(hv == want and cv % FR.p == want * R % FR.p and cv < 2 * FR.p,
                  f"keccak_squeeze lane {b} at W = {W} differs from keccak256")
    check(past_5r > 0, "no hash of step 17 reached 5r")
    log(f"# keccak_squeeze == squeeze_plain (words exact) and keccak256 (4 lanes each) at "
        f"B = {B} for W = 1..30, all three tags, hash-sized raw words; every challenge is "
        f"its hash mod r, {past_2r} hashes >= 2r and {past_5r} >= 5r among them: "
        f"{time.time() - t0:.1f}s")
    return err, cuda_ops.LAUNCHES["keccak_squeeze"]


def keccak_read_checks(dev, kernels, launches, read, challenges, squeeze_err, squeeze_kat):
    """svt_keccak_read on the keccak verify batch's own read (B = 1,024)
    against read_plain word for word and every challenge against the
    python-int transcript's; its time beside its bound, chain floor and
    ptxas usage; then the same kernel as nine single squeezes of that
    read's buffers (each against squeeze_plain), timed."""
    import torch

    from snark_verifier_tpu_torch.ff import FR
    from snark_verifier_tpu_torch.hash import keccak_device as kd

    schedule, inst, sc, pts = read
    B, R = sc.shape[0], 1 << 256
    h, c = kd.read(schedule, inst, sc, pts)
    hp, cp = kd.read_plain(schedule, inst, sc, pts)
    torch.cuda.synchronize()
    err = max(word_err(h, hp), word_err(c, cp))
    check(err == 0, "keccak_read differs from read_plain on the verify batch's read")
    got = c.cpu().numpy().astype("<u4")  # (n_sq, B, 8)
    for b in range(B):
        vals = [int.from_bytes(got[q, b].tobytes(), "little") for q in range(got.shape[0])]
        want = challenges[b % len(challenges)]
        check([v % FR.p for v in vals] == [x * R % FR.p for x in want] and
              max(vals) < 2 * FR.p, f"keccak_read lane {b}'s challenges differ from the "
                                    f"python-int transcript's")
    log(f"# keccak_read == read_plain (words exact) on the verify batch's read at B = {B}, "
        f"{len(schedule.squeezes)} squeezes of {schedule.widths} words; all "
        f"{B * len(schedule.squeezes)} challenges == the python-int transcript's")
    ms = kernel_ms(lambda: kd.read(schedule, inst, sc, pts), 20)
    plain = time_ms(lambda: kd.read_plain(schedule, inst, sc, pts), 1, warmup=1)
    work = [keccak_squeeze_work(B, [t for _, _, t in sq]) for sq in schedule.squeezes]
    blocks = sum(w[3] for w in work)  # a proof's
    bms, by = bound_ms(sum(w[0] for w in work), sum(w[1] for w in work))
    floor = sum(w[2] for w in work)
    use = ptxas_usage("keccak_read_kernel")
    # The same kernel, one squeeze a launch, on the read's own buffers.
    singles = []
    for q in range(len(schedule.squeezes)):
        words, tags = kd.squeeze_words(schedule, q, inst, sc, pts, h)
        words = words.contiguous()
        hs, cs = kd.squeeze(words, tags)
        hq, cq = kd.squeeze_plain(words, tags)
        torch.cuda.synchronize()
        squeeze_err = max(squeeze_err, word_err(hs, hq), word_err(cs, cq),
                          word_err(hs, h[q]), word_err(cs, c[q]))
        check(squeeze_err == 0, f"the single squeeze of the read's buffer {q} differs")
        singles.append(dict(W=len(tags), ms=kernel_ms(lambda: kd.squeeze(words, tags), 20),
                            plain_ms=time_ms(lambda: kd.squeeze_plain(words, tags), 1, warmup=1),
                            **dict(zip(("bound_ms", "bound_by"), bound_ms(
                                *keccak_squeeze_work(B, tags)[:2]))),
                            chain_floor_ms=keccak_squeeze_work(B, tags)[2]))
    nine_ms = sum(r["ms"] for r in singles)
    log(f"# keccak_read at ({len(schedule.squeezes)}, {B}, 8), {blocks} blocks a proof: "
        f"{ms:.4f} ms in one launch (bound {bms:.6f} ms, {by}; chain floor {floor:.4f} ms = "
        f"{blocks} blocks x 24 rounds x {KECCAK_TEAM_ROUND_CLOCKS} clocks); plain "
        f"{plain:.1f} ms; ptxas {use['registers']} registers, {use['spill_bytes']} B spill "
        f"stores, {use['stack_bytes']} B stack, {use['smem_bytes']} B smem; the same buffers as "
        f"{len(singles)} single squeezes {nine_ms:.4f} ms ("
        + ", ".join(f"W={r['W']} {r['ms']:.4f}" for r in singles) + ")")
    kernels.append(dict(
        name="keccak_read", route="cuda", source="snark_verifier_tpu_torch/csrc/keccak_kernels.cu",
        replaces="snark_verifier_tpu/hash/keccak_device.py:82",
        also_replaces=["snark_verifier_tpu/hash/keccak_device.py:137",
                       "snark_verifier_tpu/transcript/evm_transcript.py:114"],
        launches=launches["keccak_read"], max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=None, shape=[len(schedule.squeezes), B, 8],
        widths=schedule.widths, blocks_per_proof=blocks, chain_floor_ms=floor,
        team_round_clocks=KECCAK_TEAM_ROUND_CLOCKS, ops_per_permutation=keccak_permutation_ops(),
        nine_single_squeezes_ms=nine_ms, ptxas_registers=use["registers"],
        ptxas_spill_bytes=use["spill_bytes"], ptxas_stack_bytes=use["stack_bytes"],
        ptxas_smem_bytes=use["smem_bytes"], tolerance="exact words; challenges == python ints"))
    main = max(singles, key=lambda r: r["W"])
    kernels.append(dict(
        name="keccak_squeeze", route="cuda",
        source="snark_verifier_tpu_torch/csrc/keccak_kernels.cu",
        replaces="snark_verifier_tpu/hash/keccak_device.py:82",
        also_replaces=["snark_verifier_tpu/hash/keccak_device.py:137"],
        launches=launches["keccak_squeeze"], launches_kat=squeeze_kat, max_abs_err=squeeze_err,
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None, shape=[B, main["W"], 8],
        chain_floor_ms=main["chain_floor_ms"], read=singles, read_ms=nine_ms,
        kernel="svt_keccak_read with a schedule of one squeeze (EvmTranscript's squeeze)",
        tolerance="exact, raw and lazy words"))


def inv_kernel_checks(dev, kernels, tree_launches):
    """svt_field_inv (binary GCD) against the canonical plain Fermat inverse
    and python ints in both fields at (1,024) and the tree's 2,048, 64 and 4
    elements: 0, 1, p - 1, p, 2p - 1, 2p and seeded words in [0, 2p); each
    shape timed beside its bound and chain floor; ptxas usage."""
    import torch

    from snark_verifier_tpu_torch.ff import FQW, FRW

    rng = np.random.default_rng(23)
    R = 1 << 256
    shapes = (1024, 2048, 64, 4)
    rows, err = [], 0
    for name, F in (("fq", FQW), ("fr", FRW)):
        p = F.spec.p
        vals = [0, 1, p - 1, p, p + 1, 2 * p - 1, 2 * p]
        vals += [int.from_bytes(rng.bytes(32), "little") % (2 * p) for _ in range(2048 - 7)]
        raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), "<i4")
        words = torch.from_numpy(raw.reshape(-1, 8).copy()).to(dev)
        rounds = [gcd_rounds(x, p) for x in vals]
        for n in shapes:
            a = words[:n].contiguous()
            got = F.inv(a)
            e = word_err(got, F.plain("canon", F.plain("inv", a)))
            check(e == 0, f"field_inv ({name}) differs from canon(plain) at {n}")
            check(word_ints(got) == [pow(x, p - 2, p) * R * R % p for x in vals[:n]],
                  f"field_inv ({name}) at {n}: not the canonical A^-1 R")
            err = max(err, e)
            ms = kernel_ms(lambda: F.inv(a), 50)
            n_bytes, n_ops, floor = inv_work(rounds[:n])
            bms, by = bound_ms(n_bytes, n_ops)
            rows.append(dict(field=name, n=n, ms=ms, bound_ms=bms, bound_by=by,
                             chain_floor_ms=floor, rounds_max=max(rounds[:n]),
                             rounds_mean=sum(rounds[:n]) / n))
    plain = time_ms(lambda: FQW.plain("inv", words[:2048]), 1, warmup=1)
    use = {f: ptxas_usage(f"field_unary_kernelILi{t}ELi4ELi32E") for f, t in (("fq", 0), ("fr", 1))}
    log("# field_inv (binary GCD) == canon(plain Fermat) and python ints at " + "; ".join(
        f"{r['field']} {r['n']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.6f} ms, chain floor "
        f"{r['chain_floor_ms']:.4f} ms, rounds mean {r['rounds_mean']:.2f} max {r['rounds_max']})"
        for r in rows) + f"; plain (Fq, 2,048) {plain:.1f} ms; ptxas " + ", ".join(
        f"{f} {u['registers']} registers, {u['spill_bytes']} B spill, {u['stack_bytes']} B stack"
        for f, u in use.items()) + f"; launches on the tree {tree_launches['field_inv']}")
    for row in kernels:
        if row["name"] == "field_inv":
            fr = next(r for r in rows if r["field"] == "fr" and r["n"] == 1024)
            # no path launches it (the tree's affine normalisation
            # inverts inside svt_points_to_fr)
            row.update(max_abs_err=max(row["max_abs_err"], err),
                       chain_floor_ms=fr["chain_floor_ms"], shapes=rows,
                       plain_ms_fq_2048=plain, launches_verify=row["launches"],
                       launches=tree_launches["field_inv"],
                       launches_tree=tree_launches["field_inv"],
                       ptxas_registers=use["fr"]["registers"],
                       ptxas_spill_bytes=use["fr"]["spill_bytes"],
                       ptxas_stack_bytes=use["fr"]["stack_bytes"],
                       tolerance="exact, canonical words (the plain Fermat inverse canonicalized)")


def points_to_fr_work(n, rounds=None):
    """(bytes, operations, chain floor ms) of one svt_points_to_fr launch:
    n elements in affine mode (rounds None), or in projective mode points
    whose Z take these GCD rounds.  The map's least work an element is a
    from_mont reduction and one Fr product, its chain two dependent
    products; projective mode adds the inversion (`inv_work`) and the two
    products by Z^-1, its chain the inversion's, then three products."""
    per_map = MULADDS_FROM_MONT + MULADDS_PER_FQ_MUL
    if rounds is None:
        return 64 * n, n * per_map, 2 * CHAIN_FLOOR_MS_PER_MUL
    _, inv_ops, inv_floor = inv_work(rounds)
    m = len(rounds)
    return (160 * m, inv_ops + m * (2 * MULADDS_PER_FQ_MUL + 2 * per_map),
            inv_floor + 3 * CHAIN_FLOOR_MS_PER_MUL)


def rand_projective(rng, pairs, n, dev):
    """(n, 3, 8) projective words: the affine points of the fold level's
    own `pairs`, with Z = 1 on every fourth and a random Z elsewhere, and
    identity lanes (Z = 0, p and 2p as words, random X and Y) every
    sixteenth from lane 1."""
    import torch
    from snark_verifier_tpu_torch.ff import FQ

    q, R = FQ.p, 1 << 256
    aff = [pt for pair in affine_pairs(pairs[..., 0, :, :].reshape(-1, 3, 8)[: n // 2 + 1],
                                       pairs[..., 1, :, :].reshape(-1, 3, 8)[: n // 2 + 1])
           for pt in pair]
    aff = (aff * (n // len(aff) + 1))[:n]
    rows = []
    for k, pt in enumerate(aff):
        if k % 16 in (1, 2, 3) or pt is None:
            rows += [int.from_bytes(rng.bytes(32), "little") % (2 * q + 1) for _ in range(2)]
            rows.append((0, q, 2 * q)[k % 3])
            continue
        lam = 1 if k % 4 == 0 else int.from_bytes(rng.bytes(32), "little") % (q - 1) + 1
        rows += [pt[0] * lam % q * R % q, pt[1] * lam % q * R % q, lam * R % q]
    raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in rows), "<i4")
    return torch.from_numpy(raw.reshape(n, 3, 8).copy()).to(dev)


def points_to_fr_checks(dev, kernels, verify_launches, gwc_launches, tree_launches, levels):
    """svt_points_to_fr against points_to_fr_plain and the launches it
    replaced, word for word: affine mode on the verify batch's own stream
    points and on lazy words, projective mode on each fold level's own
    points and at the tree's 2,048, 64 and 4 points with identity lanes;
    each timed beside its bound, chain floor and the replaced launches."""
    import torch

    from snark_verifier_tpu_torch.ff import FQW, FRW, points_to_fr, points_to_fr_plain
    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.sdk import aggregation as agg

    def replaced(x, projective):
        """The launches points_to_fr replaced: (inv, mul,) mul, canon, mul."""
        return FRW.to_mont(FQW.from_mont(cuda_ops.affine_xy(x) if projective else x))

    rng = np.random.default_rng(29)
    _, base = load_fixtures("snark")
    _, stream = agg._stack_streams([base[i % 16] for i in range(VERIFY_BATCH)], dev)
    cases = [("verify stream points", stream, False),
             ("lazy words", rand_lazy_words(rng, tuple(stream.shape[:-1]), FQW.spec.p, dev),
              False)]
    cases += [(f"fold level {k} {tuple(p.shape[:2])}", p.reshape(-1, 3, 8).contiguous(), True)
              for k, (p, _) in enumerate(levels)]
    cases += [(f"synthetic {n}", rand_projective(rng, levels[0][0], n, dev), True)
              for n in (2048, 64, 4)]
    err, rows = 0, []
    for label, x, proj in cases:
        cuda_ops.reset_launches()
        got = points_to_fr(x, proj)
        torch.cuda.synchronize()
        field = {k: v for k, v in cuda_ops.LAUNCHES.items() if k.startswith("field_") and v}
        check(cuda_ops.LAUNCHES["points_to_fr"] == 1 and not field,
              f"points_to_fr on the {label} launched "
              f"{ {k: v for k, v in cuda_ops.LAUNCHES.items() if v} }")
        e = word_err(got, points_to_fr_plain(x, proj))
        check(e == 0, f"points_to_fr differs from its plain version on the {label}")
        check(word_err(got, replaced(x, proj)) == 0,
              f"points_to_fr differs from the launches it replaced on the {label}")
        err = max(err, e)
        if proj:
            z = x[:, 2].contiguous()
            idle = FQW.is_zero(z)
            check(not bool(got[idle].any()), f"an identity of the {label} did not map to (0, 0)")
            rounds = [gcd_rounds(v, FQW.spec.p) for v in word_ints(z)]
            n_bytes, n_ops, floor = points_to_fr_work(len(rounds), rounds)
            n_old = 5
        else:
            n_bytes, n_ops, floor = points_to_fr_work(x.numel() // 8)
            n_old = 3
        bms, by = bound_ms(n_bytes, n_ops)
        # kernel_ms's spin (~2 ms) must outlast the host's calls for the
        # device's own time: ~0.04 ms a wrapper call, so 20 calls of one
        # launch and 5 of the replaced three or five.
        rows.append(dict(
            label=label, mode="projective" if proj else "affine", shape=list(x.shape),
            ms=kernel_ms(lambda: points_to_fr(x, proj), 20),
            host_ms=time_ms(lambda: points_to_fr(x, proj), 50),
            replaced_launches=n_old,
            replaced_ms=kernel_ms(lambda: replaced(x, proj), 5),
            replaced_host_ms=time_ms(lambda: replaced(x, proj), 50),
            bound_ms=bms, bound_by=by, chain_floor_ms=floor,
            identities=int(idle.sum()) if proj else 0))
    main = rows[0]
    x = cases[0][1]
    plain_ms = time_ms(lambda: points_to_fr_plain(x), 1, warmup=1)
    use = {m: ptxas_usage(f) for m, f in (("affine", "points_to_fr_affine_kernel"),
                                           ("projective", "points_to_fr_projective_kernelILb1E"))}
    log("# points_to_fr == its plain version and the replaced launches, word for word: "
        + "; ".join(f"{r['label']} {tuple(r['shape'])} ({r['mode']}, {r['identities']} "
                    f"identities): {r['ms']:.4f} ms (with the host's time {r['host_ms']:.4f}) "
                    f"against the {r['replaced_launches']} launches it replaced "
                    f"{r['replaced_ms']:.4f} ms (with the host's {r['replaced_host_ms']:.4f}); "
                    f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), chain floor "
                    f"{r['chain_floor_ms']:.4f} ms" for r in rows)
        + f"; plain at {tuple(x.shape)} {plain_ms:.1f} ms; ptxas " + ", ".join(
            f"{m} {u['registers']} registers, {u['spill_bytes']} B spill, {u['stack_bytes']} B "
            f"stack" for m, u in use.items())
        + f"; launches: verify {verify_launches['points_to_fr']}, gwc "
          f"{gwc_launches['points_to_fr']}, tree {tree_launches['points_to_fr']}")
    kernels.append(dict(
        name="points_to_fr", route="cuda", source="snark_verifier_tpu_torch/csrc/field_kernels.cu",
        replaces="snark_verifier_tpu/transcript/poseidon_transcript.py:31",
        also_replaces=["snark_verifier_tpu/ec/curve.py:261",
                       "snark_verifier_tpu/pcs/kzg/accumulation.py:88"],
        launches=verify_launches["points_to_fr"], launches_gwc=gwc_launches["points_to_fr"],
        launches_tree=tree_launches["points_to_fr"], max_abs_err=err, ms=main["ms"],
        plain_ms=plain_ms, bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None, shape=main["shape"], chain_floor_ms=main["chain_floor_ms"],
        replaced_ms=main["replaced_ms"], shapes=rows,
        ptxas_registers={m: u["registers"] for m, u in use.items()},
        ptxas_spill_bytes={m: u["spill_bytes"] for m, u in use.items()},
        ptxas_stack_bytes={m: u["stack_bytes"] for m, u in use.items()},
        tolerance="exact, Fr Montgomery words"))


# ------------------------------------------------------ steps 21-24: the IPA
# family and instance-committing-key protocols

ICK_BASES = 16  # the stub protocol's committing key: 16 bases and a constant
IPA_ZK_BATCH = 256
IPA_DECIDE_LOG2N = LOG2N  # the decide at 2^20 points runs over step 4's [1..2^20]·G
HC_CHUNK_BITS = 5  # csrc/ipa_kernels.cu's chunk tables: 2^5 entries, 5 doubling levels


class IckStub:
    """The stub protocol of tests/test_instance_committing_key.py: just what
    `PlonkProof.read` touches before the PCS, with an instance committing
    key of ICK_BASES bases and a constant point."""

    def __init__(self, bases, constant):
        self.transcript_initial_state = 7
        self.num_instance = [len(bases)]
        self.num_witness, self.num_challenge = [], []
        self.evaluations, self.queries, self.accumulator_indices = [], [], []
        self.instance_committing_key = {"bases": bases, "constant": constant}

        class _Quotient:
            @staticmethod
            def num_chunk():
                return 0

        self.quotient = _Quotient()

    class domain:
        @staticmethod
        def rotate(r):
            return 1


class NullPcs:
    @staticmethod
    def read_proof(queries, transcript):
        return {}


def fr_words(values, mont, device):
    """python ints -> (n, 8) Fr words on `device`: Montgomery or plain."""
    import torch
    from snark_verifier_tpu_torch.ff import FR, int_to_limbs, np_limbs_to_words

    f = (lambda v: v % FR.p * (1 << 256) % FR.p) if mont else (lambda v: v % FR.p)
    arr = np.stack([int_to_limbs(f(v)) for v in values]).astype(np.uint32)
    return torch.from_numpy(np_limbs_to_words(arr)).to(device)


def launch_gate(launches, want, label):
    """Every kernel in `want` launched exactly as many times; no single-op
    field launch and no add or double unless `want` names it."""
    for k, n in want.items():
        check(launches[k] == n, f"{label}: {k} launched {launches[k]} times, not {n}")
    others = {k: v for k, v in launches.items() if v and k not in want
              and (k.startswith("field_") or k in ("add", "double"))}
    check(not others, f"{label}: unexpected launches {others}")


def ick_phase(dev):
    """Step 21: the instance commitment before the read, at batch 1,024."""
    import torch

    from snark_verifier_tpu_torch.ec import py_ec, to_affine_int, words_to_limbs
    from snark_verifier_tpu_torch.ff import FR, FRW
    from snark_verifier_tpu_torch.loader.base import TorchLoader
    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.transcript import PoseidonTranscript, PoseidonTranscriptPy
    from snark_verifier_tpu_torch.verifier.plonk.plan import commit_instances, read_proof

    B = VERIFY_BATCH
    t0 = time.time()
    bases = py_ec.rand_points(ICK_BASES, seed=21)
    const = py_ec.rand_points(1, seed=22)[0]
    stub = IckStub(bases, const)
    rng = np.random.default_rng(21)
    sets = [[int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(ICK_BASES)]
            for _ in range(16)]
    want_pts, want_z, want_next = [], [], []
    for vals in sets:  # the python-int oracle of each distinct lane
        pt = py_ec.add(py_ec.msm(bases, vals), const)
        tr = PoseidonTranscriptPy()
        tr.common_scalar(7)
        tr.common_ec_point(pt)
        want_pts.append(pt)
        want_z.append(tr.squeeze_challenge())
        want_next.append(tr.squeeze_challenge())
    flat = [v for b in range(B) for v in sets[b % 16]]
    mont = fr_words(flat, True, dev).view(B, ICK_BASES, 8)
    plain = fr_words(flat, False, dev).view(B, ICK_BASES, 8)
    cols = [[mont[:, i] for i in range(ICK_BASES)]]
    empty_sc = torch.zeros((B, 0, 8), dtype=torch.int32, device=dev)
    empty_pts = torch.zeros((B, 0, 2, 8), dtype=torch.int32, device=dev)
    log(f"# ick inputs: {ICK_BASES} bases + a constant, 16 instance sets tiled to {B}, "
        f"16 oracle reads: {time.time() - t0:.2f}s")

    def read():
        lanes = commit_instances(stub, plain)
        tr = PoseidonTranscript(empty_sc, empty_pts, dev, lanes=lanes)
        reads = read_proof(stub, NullPcs, cols, tr, TorchLoader(B, dev))
        return lanes, reads.values[0], tr.squeeze_challenge()

    cuda_ops.reset_launches()
    lanes, z, nxt = read()
    torch.cuda.synchronize()
    launches = dict(cuda_ops.LAUNCHES)
    log(f"# ick read launches at batch {B}: "
        f"{ {k: v for k, v in launches.items() if v} }")
    launch_gate(launches, {"msm_windowed": 1, "points_to_fr": 1, "poseidon_absorb": 2}, "ick")
    got = to_affine_int(words_to_limbs(lanes[:, 0]))
    bad = [b for b in range(B) if got[b] != want_pts[b % 16]]
    check(not bad, f"ick: {len(bad)} committed points differ from py_ec.msm + constant, "
                   f"first {bad[:5]}")
    zs, nexts = FRW.to_int(z), FRW.to_int(nxt)
    bad = [b for b in range(B) if int(zs[b]) != want_z[b % 16]
           or int(nexts[b]) != want_next[b % 16]]
    check(not bad, f"ick: {len(bad)} lanes' squeezes differ from PoseidonTranscriptPy's")
    best, times = best_of_3(read)
    commit_ms = time_ms(lambda: commit_instances(stub, plain), 20)
    log(f"# ick gates: every lane's committed point == py_ec.msm + constant, z and the next "
        f"squeeze == PoseidonTranscriptPy's; launches: one msm_windowed (the commitment, "
        f"({B}, {ICK_BASES + 1}) terms), one points_to_fr, two poseidon_absorb; the "
        f"commitment and read {best * 1e3:.3f} ms best of 3 (runs "
        f"{[round(t * 1e3, 3) for t in times]}), the commitment alone {commit_ms:.4f} ms "
        f"(CUDA events) on {smi_line()}")
    return ick_keccak_stub(dev, stub, want_pts, flat, lanes)


def ick_keccak_stub(dev, stub, want_pts, flat, lanes):
    """Step 21, keccak: the same stub and batch read with the keccak
    transcript through the plan's recorded schedule (the read and one
    squeeze after it): the commitment (one msm_windowed), its affine
    normalisation (one points_to_fr, map_fr=False), one keccak_read.
    Returns the launches and the normalisation's row for the kernels line."""
    import torch

    from snark_verifier_tpu_torch.ff import FQW, FRW, points_to_fr, points_to_fr_plain
    from snark_verifier_tpu_torch.loader.base import TorchLoader
    from snark_verifier_tpu_torch.loader.tape_loader import TapeLoader, TapeTranscript
    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.transcript import EvmTranscriptPy, PrecomputedChallengeTranscript
    from snark_verifier_tpu_torch.verifier.plonk.plan import (
        commit_instances, instance_label, keccak_challenges, keccak_schedule, read_proof,
    )
    from snark_verifier_tpu_torch.verifier.plonk.verifier import PlonkProof

    B = VERIFY_BATCH
    L = TapeLoader()
    rec = TapeTranscript(L)
    PlonkProof.read(stub, [[L.input(instance_label(0, i)) for i in range(ICK_BASES)]], rec,
                    NullPcs, L)
    rec.squeeze_challenge()
    sched = keccak_schedule(rec.squeezes, stub)
    want = []
    for pt in want_pts:  # the python-int transcript of each distinct lane
        t = EvmTranscriptPy()
        t.common_scalar(7)
        t.common_ec_point(pt)
        want.append([t.squeeze_challenge(), t.squeeze_challenge()])
    empty_sc = torch.zeros((B, 0, 8), dtype=torch.int32, device=dev)
    empty_pts = torch.zeros((B, 0, 2, 8), dtype=torch.int32, device=dev)

    def read(vals):
        mont = fr_words(vals, True, dev).view(B, ICK_BASES, 8)
        plain = fr_words(vals, False, dev).view(B, ICK_BASES, 8)

        def run():
            lanes = commit_instances(stub, plain)
            chals = keccak_challenges(sched, mont, empty_sc, empty_pts, lanes)
            tr = PrecomputedChallengeTranscript(empty_sc, empty_pts, list(chals))
            reads = read_proof(stub, NullPcs, [[mont[:, i] for i in range(ICK_BASES)]], tr,
                               TorchLoader(B, dev))
            return reads.values[0], chals[1]

        return run

    run = read(flat)
    cuda_ops.reset_launches()
    got = run()
    torch.cuda.synchronize()
    launches = dict(cuda_ops.LAUNCHES)
    got = [FRW.to_int(v) for v in got]
    log(f"# ick keccak read launches at batch {B}: "
        f"{ {k: v for k, v in launches.items() if v} }")
    launch_gate(launches, {"msm_windowed": 1, "points_to_fr": 1, "keccak_read": 1,
                           "poseidon_absorb": 0, "keccak_squeeze": 0}, "ick keccak")
    bad = [b for b in range(B) if [int(got[0][b]), int(got[1][b])] != want[b % 16]]
    check(not bad, f"ick keccak: {len(bad)} lanes' challenges differ from EvmTranscriptPy's, "
                   f"first {bad[:5]}")
    moved = list(flat)
    moved[0] = (moved[0] + 1) % FRW.spec.p  # lane 0's first instance
    got2 = [FRW.to_int(v) for v in read(moved)()]
    diff = [b for b in range(B) if [int(got2[0][b]), int(got2[1][b])] != want[b % 16]]
    check(diff == [0], f"ick keccak: a tampered instance of lane 0 moved lanes {diff[:5]}")
    best, times = best_of_3(run)

    # the normalisation alone: one launch against affine_xy's two (inv, mul)
    xy = points_to_fr(lanes, projective=True, map_fr=False)
    e = word_err(xy, points_to_fr_plain(lanes, projective=True, map_fr=False))
    check(e == 0, "points_to_fr (map_fr=False) differs from its plain version on the lanes")
    check(word_err(xy, FQW.canon(cuda_ops.affine_xy(lanes))) == 0,
          "points_to_fr (map_fr=False) differs from affine_xy on the lanes")
    flat_lanes = lanes.reshape(-1, 3, 8).contiguous()
    rounds = [gcd_rounds(v, FQW.spec.p) for v in word_ints(flat_lanes[:, 2])]
    _, inv_ops, inv_floor = inv_work(rounds)
    m = len(rounds)
    bms, by = bound_ms(160 * m, inv_ops + 2 * m * MULADDS_PER_FQ_MUL)
    row = dict(label=f"ick lanes {tuple(lanes.shape[:2])}", mode="projective to affine Fq",
               shape=list(lanes.shape), ms=kernel_ms(lambda: points_to_fr(
                   lanes, projective=True, map_fr=False), 20),
               host_ms=time_ms(lambda: points_to_fr(lanes, projective=True, map_fr=False), 50),
               replaced_launches=2, replaced_ms=kernel_ms(lambda: cuda_ops.affine_xy(lanes), 10),
               replaced_host_ms=time_ms(lambda: cuda_ops.affine_xy(lanes), 50),
               bound_ms=bms, bound_by=by, chain_floor_ms=inv_floor + CHAIN_FLOOR_MS_PER_MUL,
               identities=0, ptxas=ptxas_usage("points_to_fr_projective_kernelILb0E"))
    log(f"# ick keccak gates: every lane's z and next squeeze == EvmTranscriptPy's, a tampered "
        f"instance moves lane 0 alone; launches: one msm_windowed, one points_to_fr "
        f"(map_fr=False), one keccak_read, no poseidon_absorb, no single-op field launch; the "
        f"commitment and read {best * 1e3:.3f} ms best of 3 (runs "
        f"{[round(t * 1e3, 3) for t in times]}); the normalisation {row['ms']:.4f} ms (with the "
        f"host's time {row['host_ms']:.4f}) against affine_xy's two launches "
        f"{row['replaced_ms']:.4f} ms (with the host's {row['replaced_host_ms']:.4f}), bound "
        f"{bms:.6f} ms ({by}), chain floor {row['chain_floor_ms']:.4f} ms, ptxas "
        f"{row['ptxas']}; on {smi_line()}")
    return launches, row


def ick_keccak_batch(dev):
    """Step 21, a whole protocol: the 16 evmsnark fixtures' protocol given an
    instance committing key over its instance column (16 random bases and a
    constant) and that column queried and evaluated in the proof (an extra
    stream scalar, numpy seed 21), as tests/test_torch_instance_committing_
    key.py does; `batch_succinct_verify(..., "shplonk", "evm")` at 1,024
    tiled.  No prover makes such a proof, so the accumulators are no valid
    ones: every lane's equals the port's python-int verifier's
    (`succinct_verify_native(..., "evm")`), a tampered instance moves lane
    0's alone.  Returns the launches."""
    import copy

    import torch

    from snark_verifier_tpu_torch.ec import py_ec
    from snark_verifier_tpu_torch.ff import FR
    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.sdk.aggregation import batch_succinct_verify
    from snark_verifier_tpu_torch.sdk.snark import Snark
    from snark_verifier_tpu_torch.verifier.plonk import verifier as pv
    from snark_verifier_tpu_torch.verifier.plonk.protocol import Query

    B = VERIFY_BATCH
    t0 = time.time()
    srs, loaded = load_fixtures("evmsnark")
    proto = copy.deepcopy(loaded[0].protocol)
    proto.instance_committing_key = {
        "bases": py_ec.rand_points(proto.num_instance[0], seed=23),
        "constant": py_ec.rand_points(1, seed=24)[0]}
    n_eval = len(proto.evaluations)
    iq = Query(len(proto.preprocessed), 0)
    proto.evaluations.append(iq)
    proto.queries.append(iq)
    rng = np.random.default_rng(21)
    base = [Snark(proto, s.instances, s.scalars[:n_eval]
                  + [int.from_bytes(rng.bytes(32), "little") % FR.p] + s.scalars[n_eval:],
                  s.points) for s in loaded]
    oracle = [pv.succinct_verify_native(s, srs, "shplonk", "evm")[0] for s in base]
    log(f"# ick keccak batch inputs: the evmsnark protocol with an instance committing key of "
        f"{proto.num_instance[0]} bases and a constant, 16 oracle verifies: "
        f"{time.time() - t0:.2f}s")
    snarks = [base[i % 16] for i in range(B)]
    cuda_ops.reset_launches()
    accs = batch_succinct_verify(snarks, srs, "shplonk", "evm")
    torch.cuda.synchronize()
    launches = dict(cuda_ops.LAUNCHES)
    log(f"# ick keccak batch launches at batch {B}: "
        f"{ {k: v for k, v in launches.items() if v} }")
    launch_gate(launches, {"msm_windowed": 2, "points_to_fr": 1, "keccak_read": 1,
                           "fr_tape": 1, "poseidon_absorb": 0, "keccak_squeeze": 0},
                "ick keccak batch")
    got = affine_pairs(*accs[0])
    bad = [b for b in range(B) if got[b] != oracle[b % 16]]
    check(not bad, f"ick keccak batch: {len(bad)} lanes differ from the python-int verifier")
    accs2 = batch_succinct_verify([tampered(snarks[0])] + snarks[1:], srs, "shplonk", "evm")
    got2 = affine_pairs(*accs2[0])
    diff = [b for b in range(B) if got2[b] != got[b]]
    check(diff == [0], f"ick keccak batch: a tampered instance of lane 0 moved lanes {diff[:5]}")
    best, times = best_of_3(lambda: batch_succinct_verify(snarks, srs, "shplonk", "evm"))
    log(f"# ick keccak batch gates: every lane == succinct_verify_native(..., 'evm'), a tampered "
        f"instance moves lane 0 alone; launches: two msm_windowed (the commitment, the "
        f"accumulator), one points_to_fr (map_fr=False), one keccak_read, one fr_tape; "
        f"{best * 1e3:.3f} ms best of 3 (runs {[round(t * 1e3, 3) for t in times]}) = "
        f"{B / best:.1f} succinct proofs/s on {smi_line()}")
    return launches


def ipa_openings_phase(dev, kernels):
    """Step 22: IPA openings at k = 11, batch 1,024 (and zk at 256)."""
    import torch

    from snark_verifier_tpu_torch.ec import to_affine_int, words_to_limbs
    from snark_verifier_tpu_torch.ff import FRW, digits4, fr_tape
    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.pcs.ipa import IpaOpening, batch_ipa_verify, ipa_plan
    from snark_verifier_tpu_torch.pcs.ipa import fixtures as fx

    B = VERIFY_BATCH
    k = fx.K
    t0 = time.time()
    rates = {}
    seen_tape, seen_msm = [], []
    real_tape, real_msm = fr_tape.run, cuda_ops.msm_windowed

    def capture_tape(tape, inputs):
        seen_tape.append((tape, inputs))
        return real_tape(tape, inputs)

    def capture_msm(pts, scs, c=4):
        seen_msm.append((pts, scs))
        return real_msm(pts, scs, c)

    for zk, batch in ((False, B), (True, IPA_ZK_BATCH)):
        ops, accs = fx.ipa_openings(zk)
        lanes = [ops[b % 16] for b in range(batch)]
        log(f"# ipa{' zk' if zk else ''} inputs: 16 fixtures (k = {k}) tiled to {batch}: "
            f"{time.time() - t0:.2f}s")
        fr_tape.run, cuda_ops.msm_windowed = capture_tape, capture_msm
        try:
            cuda_ops.reset_launches()
            out, oks = batch_ipa_verify(lanes)
            torch.cuda.synchronize()
            launches = dict(cuda_ops.LAUNCHES)
        finally:
            fr_tape.run, cuda_ops.msm_windowed = real_tape, real_msm
        log(f"# ipa{' zk' if zk else ''} launches at batch {batch}: "
            f"{ {kk: v for kk, v in launches.items() if v} }")
        launch_gate(launches, {"fr_tape": 1, "msm_windowed": 1, "points_to_fr": 1,
                               "poseidon_absorb": k + 1 + zk}, f"ipa zk={zk}")
        check(oks.dtype == torch.bool and tuple(oks.shape) == (batch,), "ipa: result shape")
        check(bool(oks.all()), f"ipa zk={zk}: {int((~oks).sum())} of {batch} valid lanes rejected")
        xis = FRW.to_int(out.xi.reshape(-1, 8)).reshape(batch, k)
        bad = [b for b in range(batch) if [int(x) for x in xis[b]] != accs[b % 16].xi]
        check(not bad, f"ipa zk={zk}: {len(bad)} lanes' xi differ from the prover's")
        us = to_affine_int(words_to_limbs(out.u))
        check(all(us[b] == accs[b % 16].u for b in range(batch)),
              "ipa: U differs from the prover's")
        o = ops[0]
        tam = [IpaOpening(o.svk, o.c, o.z, (o.v + 1) % FRW.spec.p, o.scalars, o.points)] + lanes[1:]
        _, oks_t = batch_ipa_verify(tam)
        check(not bool(oks_t[0]) and bool(oks_t[1:].all()),
              f"ipa zk={zk}: tampered eval, rejected lanes "
              f"{torch.nonzero(~oks_t).flatten()[:5].tolist()}")
        best, times = best_of_3(lambda: batch_ipa_verify(lanes))
        rates[zk] = batch / best
        steps = ("plan_s", "stack_s", "read_s", "gather_s", "fr_tape_s", "msm_s")
        phases = []
        for _ in range(3):
            tm = {}
            batch_ipa_verify(lanes, timings=tm)
            phases.append(tm)
        log(f"# ipa{' zk' if zk else ''} gates: all {batch} lanes accept, xi and U == the "
            f"prover's; eval + 1 on lane 0 rejects lane 0 alone; one fr_tape, one msm_windowed, "
            f"one points_to_fr, {k + 1 + zk} poseidon_absorb, no single-op field launch")
        log(f"# IPA succinct{' zk' if zk else ''} at batch {batch}, k = {k}: best-of-3 "
            f"{best * 1e3:.3f} ms = {batch / best:.1f} proofs/s (runs "
            f"{[round(t * 1e3, 3) for t in times]} ms) on {smi_line()}; steps (ms, three runs): "
            + ", ".join(f"{s[:-2]} {[round(tm[s] * 1e3, 3) for tm in phases]}" for s in steps))
    plan = ipa_plan("ipa", fx.ipa_keys()[0].svk)
    log(f"# ipa plan: recorded in {plan.record_s * 1e3:.2f} ms; {len(plan.tape.rows)} rows "
        f"{plan.tape.op_counts()}, {plan.tape.n_slots} slots, {len(plan.tape.inputs)} inputs, "
        f"{len(plan.tape.outputs)} outputs; MSM {len(plan.check.scaled)} scaled + "
        f"{len(plan.check.plain)} coefficient-1 terms")

    # The path's fr_tape and msm_windowed against their plain versions on
    # their own inputs (the first batch: k = 11 without zk, 1,024 lanes).
    tape, ins = seen_tape[0]
    got = fr_tape.run(tape, ins)
    torch.cuda.synchronize()
    t0 = time.time()
    want = fr_tape.run_plain(tape, ins)
    torch.cuda.synchronize()
    tape_plain = (time.time() - t0) * 1e3
    tape_err = word_err(got, want)
    check(tape_err == 0, "ipa: fr_tape differs from run_plain on the batch's inputs")
    tape_ms = kernel_ms(lambda: fr_tape.run(tape, ins), 20)
    least = tape.row_muladds(least=True)
    bms, by = bound_ms((ins.shape[0] + len(tape.outputs)) * B * 32, B * int(least.sum()))
    floor = tape.chain(least) * CHAIN_FLOOR_MS_PER_MUL / MULADDS_PER_FQ_MUL
    pts, scs = seen_msm[0]
    got = cuda_ops.msm_windowed(pts, scs)
    torch.cuda.synchronize()
    t0 = time.time()
    want = cuda_ops.msm_windowed_plain(pts, digits4(scs))
    torch.cuda.synchronize()
    msm_plain = (time.time() - t0) * 1e3
    msm_err = affine_err(got, want)
    check(msm_err == 0, "ipa: msm_windowed differs from its plain version")
    msm_ms = kernel_ms(lambda: cuda_ops.msm_windowed(pts, scs), 10)
    n = pts.shape[1]
    mbms, mby = bound_ms(pts.numel() * 4 + scs.numel() * 4 + B * POINT_BYTES,
                         B * msm_windowed_muladds(n))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mfloor = msm_windowed_chain_muls(B, n, sms) * CHAIN_FLOOR_MS_PER_MUL
    log(f"# ipa fr_tape at ({ins.shape[0]}, {B}, 8) -> ({len(tape.outputs)}, {B}, 8): "
        f"{tape_ms:.4f} ms (bound {bms:.6f} ms, {by}; chain floor {floor:.4f} ms); plain "
        f"{tape_plain:.1f} ms; == run_plain word for word")
    log(f"# ipa msm_windowed at {tuple(pts.shape[:2])}: {msm_ms:.4f} ms (bound {mbms:.4f} ms, "
        f"{mby}; chain floor {mfloor:.4f} ms); plain {msm_plain:.1f} ms; affine-equal")
    for row in kernels:
        if row["name"] == "fr_tape":
            row.update(ipa_shape=list(ins.shape), ipa_ms=tape_ms, ipa_bound_ms=bms,
                       ipa_chain_floor_ms=floor, ipa_plain_ms=tape_plain, ipa_max_abs_err=tape_err,
                       ipa_rows=len(tape.rows), launches_ipa=1)
        if row["name"] == "msm_windowed":
            row.update(ipa_shape=list(pts.shape), ipa_ms=msm_ms, ipa_bound_ms=mbms,
                       ipa_chain_floor_ms=mfloor, ipa_plain_ms=msm_plain, ipa_max_abs_err=msm_err,
                       launches_ipa=1)
    return rates


def ipa_family_phase(dev):
    """Step 23: BGH19 and IpaAs at k = 11, and the decide at 2^11 points."""
    import torch

    from snark_verifier_tpu_torch.ec import from_affine_int, limbs_to_words
    from snark_verifier_tpu_torch.ff import FRW
    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.pcs.ipa import (
        Bgh19Opening, IpaAccumulator, batch_bgh19_verify, batch_ipa_as_verify, batch_ipa_verify,
        decide_all,
    )
    from snark_verifier_tpu_torch.pcs.ipa import fixtures as fx

    B = VERIFY_BATCH
    k = fx.K
    ops, accs = fx.bgh19_openings()
    lanes = [ops[b % 4] for b in range(B)]
    cuda_ops.reset_launches()
    out, oks = batch_bgh19_verify(lanes)
    torch.cuda.synchronize()
    launches = dict(cuda_ops.LAUNCHES)
    launch_gate(launches, {"fr_tape": 1, "msm_windowed": 1, "points_to_fr": 1}, "bgh19")
    check(bool(oks.all()), f"bgh19: {int((~oks).sum())} of {B} valid lanes rejected")
    xis = FRW.to_int(out.xi.reshape(-1, 8)).reshape(B, k)
    check(all([int(x) for x in xis[b]] == accs[b % 4].xi for b in range(B)),
          "bgh19: xi differ from the prover's")
    o = ops[0]
    q = list(o.queries)
    q[2] = (q[2][0], q[2][1], (q[2][2] + 1) % FRW.spec.p)
    tam = [Bgh19Opening(o.svk, o.commitments, o.x, q, o.scalars, o.points)] + lanes[1:]
    _, oks_t = batch_bgh19_verify(tam)
    check(not bool(oks_t[0]) and bool(oks_t[1:].all()), "bgh19: the tampered eval's lane")
    best, _ = best_of_3(lambda: batch_bgh19_verify(lanes))
    log(f"# bgh19 at batch {B}, k = {k}: all accept, xi == the prover's, a tampered query eval "
        f"rejects its lane alone; launches {({kk: v for kk, v in launches.items() if v})}; "
        f"best-of-3 {best * 1e3:.3f} ms = {B / best:.1f} proofs/s")

    folds, faccs = fx.ipa_folds()
    folded = []
    for fold, acc_p in zip(folds, faccs):
        tm = {}
        cuda_ops.reset_launches()
        out, oks = batch_ipa_as_verify([fold], timings=tm)
        torch.cuda.synchronize()
        launches = dict(cuda_ops.LAUNCHES)
        check(bool(oks.all()), f"ipa_as: the fold of {len(fold.accs)} rejected")
        check([int(x) for x in FRW.to_int(out.xi[0])] == acc_p.xi, "ipa_as: xi differ")
        launch_gate(launches, {"fr_tape": 1, "msm_windowed": 1, "points_to_fr": 2}, "ipa_as")
        tm2 = {}
        batch_ipa_as_verify([fold], timings=tm2)
        folded.append(out.lane(0))
        log(f"# ipa_as fold of {len(fold.accs)} (zk {fold.svk.zk}): accepts, xi == the "
            f"prover's; launches {({kk: v for kk, v in launches.items() if v})}; steps (ms, "
            f"second run): " + ", ".join(f"{s[:-2]} {tm2[s] * 1e3:.3f}" for s in tm2)
            + f"; the read (the absorb of {len(fold.accs)}·{k} scalars and {len(fold.accs)} "
            f"points before alpha, then the IPA's) {tm2['read_s'] * 1e3:.3f} ms")

    dk, dk_zk = fx.ipa_keys()
    ops, _ = fx.ipa_openings(False)
    out, oks = batch_ipa_verify(ops)
    check(bool(oks.all()), "decide inputs: the 16 openings")
    todo = [out.lane(b) for b in range(16)]
    cuda_ops.reset_launches()
    ok = decide_all(dk, todo)
    ok_folds = [decide_all(d, [a])[0] for d, a in zip((dk, dk_zk), folded)]
    torch.cuda.synchronize()
    launches = dict(cuda_ops.LAUNCHES)
    check(bool(ok.all()) and all(bool(x) for x in ok_folds),
          f"decide at 2^{k}: {int((~ok).sum())} openings and "
          f"{sum(not bool(x) for x in ok_folds)} folds rejected")
    check(launches["ipa_h_coeffs"] == 18, f"decide: {launches['ipa_h_coeffs']} h launches, not 18")
    h_words = limbs_to_words(from_affine_int([dk.svk.h], device=dev))[0]
    check(not bool(decide_all(dk, [IpaAccumulator(todo[0].xi, h_words)])[0]),
          "decide: U = H accepted")
    t0 = time.time()
    decide_all(dk, todo)
    torch.cuda.synchronize()
    log(f"# decide at 2^{k}: the 16 opening accumulators and both folded ones accept, U = H "
        f"rejects; launches {({kk: v for kk, v in launches.items() if v})}; 16 decides "
        f"{(time.time() - t0) * 1e3:.2f} ms")


def h_coeffs_work(k):
    """(bytes, least multiply-adds) of the 2^k coefficients: each written
    once as 16 int64 limbs; one product and one reduction a coefficient."""
    n = 1 << k
    return n * 128 + k * 32, n * (MULADDS_PER_FQ_MUL + MULADDS_FROM_MONT)


def ipa_decide_phase(dev, kernels, points):
    """Step 24: the decide at 2^20 points over step 4's [1..2^20]·G."""
    import torch

    from snark_verifier_tpu_torch.ec import (
        from_affine_int, limbs_to_words, py_ec,
    )
    from snark_verifier_tpu_torch.ff import FR, FRW, limbs_to_int
    from snark_verifier_tpu_torch.msm import cuda_ops, msm
    from snark_verifier_tpu_torch.pcs.ipa import (
        IpaAccumulator, IpaDecidingKey, IpaSuccinctVerifyingKey, decide, h_coeffs_int,
    )

    k = IPA_DECIDE_LOG2N
    n = 1 << k
    check(points.shape[0] == n, "decide: step 4's points are gone")
    errs = {}
    # the kernel against its plain version at k = 5, 11 and 20
    rng = np.random.default_rng(24)
    xi = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(k)]
    for kk in (5, 11, k):
        xw = FRW.from_int(xi[:kk], dev)
        got, want = cuda_ops.h_coeffs(xw), cuda_ops.h_coeffs_plain(xw)
        torch.cuda.synchronize()
        errs[kk] = int((got - want).abs().max())
        check(errs[kk] == 0 and torch.equal(got, want), f"h_coeffs differs from its plain "
                                                        f"version at k = {kk}")
        if kk < k:
            check([limbs_to_int(r) for r in got.cpu().numpy()] == h_coeffs_int(xi[:kk]),
                  f"h_coeffs differs from python ints at k = {kk}")
    t0 = time.time()
    h = h_coeffs_int(xi)
    total = sum(c * (j + 1) for j, c in enumerate(h)) % FR.p
    U = py_ec.scalar_mul(py_ec.G1_GEN, total)
    sample = list(range(0, n, 997))
    hk = cuda_ops.h_coeffs(FRW.from_int(xi, dev))[sample].cpu().numpy()
    check([limbs_to_int(r) for r in hk] == [h[j] for j in sample],
          "h_coeffs at 2^20 differs from python ints")
    log(f"# decide inputs: xi from default_rng(24), h's 2^{k} coefficients, U = (sum_j h_j (j+1))"
        f"·G and {len(sample)} sampled coefficients against python ints: {time.time() - t0:.2f}s")

    # G = [1..2^20]·G; the verifying key's H is not read by the decide
    svk = IpaSuccinctVerifyingKey(k, py_ec.G1_GEN, py_ec.G1_GEN)
    dk = IpaDecidingKey(svk, points)
    u_words = limbs_to_words(from_affine_int([U], device=dev))[0]
    acc = IpaAccumulator(FRW.from_int(xi, dev), u_words)
    cuda_ops.reset_launches()
    ok = decide(dk, acc)
    torch.cuda.synchronize()
    launches = dict(cuda_ops.LAUNCHES)
    log(f"# decide at 2^{k} launches: {({kk: v for kk, v in launches.items() if v})}")
    check(bool(ok), "decide at 2^20 rejects the honest U")
    check(launches["ipa_h_coeffs"] == 1 and launches["bucket_reduce"] == 1
          and launches["fold_segments"] == 1 and launches["fold_buckets"] <= 3,
          "decide at 2^20: launches")
    check(launches["add"] == 0 and launches["double"] == 0, "decide: add or double launched")
    bad = limbs_to_words(from_affine_int([py_ec.add(U, py_ec.G1_GEN)], device=dev))[0]
    check(not bool(decide(dk, IpaAccumulator(acc.xi, bad))), "decide at 2^20 accepts U + G")
    best, times = best_of_3(lambda: decide(dk, acc))
    coeffs = cuda_ops.h_coeffs(acc.xi)
    msm_best, _ = best_of_3(lambda: msm(dk.g_dev(dev), coeffs, device=dev))
    log(f"# IPA decide at k = {k}: best-of-3 {best * 1e3:.3f} ms (runs "
        f"{[round(t * 1e3, 3) for t in times]} ms; its msm alone {msm_best * 1e3:.3f} ms) on "
        f"{smi_line()}; accepts U, rejects U + G")

    ms = kernel_ms(lambda: cuda_ops.h_coeffs(acc.xi), 20)
    torch.cuda.synchronize()
    t0 = time.time()
    cuda_ops.h_coeffs_plain(acc.xi)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    nbytes, nops = h_coeffs_work(k)
    bms, by = bound_ms(nbytes, nops)
    # the chain: the chunk tables' doubling levels, a tile table entry, the
    # tile's factor and one coefficient's product
    floor = (HC_CHUNK_BITS + 3) * CHAIN_FLOOR_MS_PER_MUL
    small = {}
    for kk in (5, 11):
        xs = FRW.from_int(xi[:kk], dev)
        small[kk] = kernel_ms(lambda: cuda_ops.h_coeffs(xs), 20)
    use = ptxas_usage("ipa_h_coeffs_kernel")
    share, gbps = bms / ms, nbytes / (ms * 1e-3) / 1e9
    log(f"# ipa_h_coeffs at k = {k}: {ms:.4f} ms (bound {bms:.4f} ms, {by}: {nbytes / 1e6:.1f} MB "
        f"out, {nops:.3g} least multiply-adds; {share:.1%} of the bound, {gbps:.0f} GB/s stored; "
        f"chain floor {floor:.4f} ms); k = 5 {small[5]:.4f} ms, k = 11 {small[11]:.4f} ms; plain "
        f"{plain_ms:.1f} ms; ptxas {use['registers']} registers, {use['stack_bytes']} B stack, "
        f"{use['spill_bytes']} B spill stores; == h_coeffs_plain word for word at k = 5, 11, {k}")
    kernels.append(dict(
        name="ipa_h_coeffs", route="cuda", source="snark_verifier_tpu_torch/csrc/ipa_kernels.cu",
        replaces="snark_verifier_tpu/pcs/ipa/ipa.py:95",
        also_replaces=["snark_verifier_tpu/pcs/ipa/ipa.py:346"], launches=launches["ipa_h_coeffs"],
        max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=None, shape=[n, 16], chain_floor_ms=floor, ms_k5=small[5], ms_k11=small[11],
        bound_share=share, stored_gb_per_s=gbps, ptxas_registers=use["registers"],
        ptxas_stack_bytes=use["stack_bytes"], ptxas_spill_bytes=use["spill_bytes"],
        tolerance="exact, canonical limbs"))
    return best


MESH_D = 4  # the card listed MESH_D times: the dryrun's point axis
MESH_BATCH_N = 1 << 18  # batch_msm_sharded at B = 4, n = 2^18: step 4's points in four
WARM_START_TIMEOUT_S = 300

# The warm start (bench.py:243-280): a fresh process loads the SRS and the
# fixtures, tiles them to VERIFY_BATCH and verifies them through
# batch_verify_sharded on a one-device mesh, timing each part of the way.
WARM_START = r"""
import json, os, sys, time
t0 = time.perf_counter()
import torch
from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.parallel import Mesh, batch_verify_sharded
from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21
from snark_verifier_tpu_torch.sdk import aot
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import load_params
from snark_verifier_tpu_torch.verifier.plonk.plan import succinct_plan
split = {"import": time.perf_counter() - t0}


def part(name, fn):
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    split[name] = time.perf_counter() - t
    return r


dev = part("cuda_init", lambda: torch.zeros(1, device="cuda").device)
part("library_load", _build.load_library)
d = os.path.join("benchmarks", "fixtures", "vanilla_k10")
srs = part("srs_parse", lambda: load_params(os.path.join(d, "srs.bin")))
base = part("fixtures", lambda: [Snark.load(os.path.join(d, f"snark_{i:02d}.json"))
                                 for i in range(16)])
snarks = [base[i % 16] for i in range(int(sys.argv[1]))]
# the hash of the package's sources that keys every cache entry, computed
# once a process (here, so that "plan" is the lookup alone)
part("code_fingerprint", aot._code_fingerprint)
plan = part("plan", lambda: succinct_plan(base[0].protocol, Bdfg21, "shplonk", "poseidon",
                                          device=dev))
part("g2_lines", lambda: srs.decider_coeffs(dev))
oks = part("first_batch", lambda: batch_verify_sharded(snarks, srs, Mesh([dev], ("batch",))))
assert bool(oks.all()), "the warm-start batch rejected"
split["wall"] = time.perf_counter() - t0
print("WARM_START " + json.dumps({"split_s": split, "plan_from_cache": plan.from_cache,
                                  "plan_s": plan.record_s}))
"""


def warm_start_run(aot_dir):
    """One fresh process of WARM_START over `aot_dir` -> (its report, the
    wall time of the whole subprocess in s)."""
    import os
    from pathlib import Path

    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo), SNARK_AOT_DIR=str(aot_dir))
    env.pop("SNARK_AOT", None)  # the default: on for a CUDA device
    t0 = time.time()
    out = subprocess.run([sys.executable, "-c", WARM_START, str(VERIFY_BATCH)], cwd=repo,
                         env=env, capture_output=True, text=True, timeout=WARM_START_TIMEOUT_S)
    wall = time.time() - t0
    check(out.returncode == 0, f"the warm-start process failed ({out.returncode}): "
                               f"{out.stderr[-2000:]}")
    line = next((ln for ln in out.stdout.splitlines() if ln.startswith("WARM_START ")), None)
    check(line is not None, "the warm-start process printed no report")
    return json.loads(line[len("WARM_START "):]), wall


def warm_start_phase():
    """Step 25f: the warm start run twice in fresh processes, once over an
    empty cache directory and once over what the first left."""
    import shutil
    from pathlib import Path

    aot_dir = Path(__file__).resolve().parent / "snark_verifier_tpu_torch" / "build" / "aot_warm"
    shutil.rmtree(aot_dir, ignore_errors=True)
    aot_dir.mkdir(parents=True)
    cold, cold_wall = warm_start_run(aot_dir)
    entries = sorted(p.name for p in aot_dir.glob("*.npz"))
    warm, warm_wall = warm_start_run(aot_dir)
    check(not cold["plan_from_cache"], "the cold warm-start process found a cached plan")
    check(len(entries) == 2, f"the cold process left {entries}, not the plan and the G2 lines")
    check(warm["plan_from_cache"], "the warm process recorded the plan again")
    check(sorted(p.name for p in aot_dir.glob("*.npz")) == entries,
          "the warm process wrote the cache again")
    for label, rep, wall in (("cold", cold, cold_wall), ("warm", warm, warm_wall)):
        log(f"# warm start, {label} (a fresh process, {VERIFY_BATCH} proofs, a one-device "
            f"mesh): process wall {wall:.3f} s; in-process " + ", ".join(
                f"{k} {v * 1e3:.1f} ms" for k, v in rep["split_s"].items())
            + f"; plan {'loaded' if rep['plan_from_cache'] else 'recorded'} in "
              f"{rep['plan_s'] * 1e3:.3f} ms")
    return {"cold": dict(cold, process_wall_s=cold_wall),
            "warm": dict(warm, process_wall_s=warm_wall)}


def mesh_phase(dev, kernels, points, scalars, ks, want, msm_best_s, verify_rate, tree_rate):
    """Step 25: the sharded paths of `parallel/` and `sdk/tree_aggregation.py`
    on a mesh of this one card listed MESH_D times (`dryrun_multichip`'s
    sizes: the 2^20 MSM, the verify and the tree at 1,024); no scaling is
    claimed, since every shard runs on the same card."""
    import torch

    from snark_verifier_tpu_torch.ec import from_affine_int, limbs_to_words, py_ec
    from snark_verifier_tpu_torch.ec import to_affine_int
    from snark_verifier_tpu_torch.ff import FR
    from snark_verifier_tpu_torch.msm import cuda_ops, msm, scalars_from_int
    from snark_verifier_tpu_torch.parallel import (
        Mesh, batch_msm_sharded, batch_verify_sharded, msm_sharded,
    )
    from snark_verifier_tpu_torch.parallel.batch_verify import batch_succinct_verify_sharded
    from snark_verifier_tpu_torch.parallel.comm_model import (
        NVLINK_BYTES_PER_S, PARTIAL_BYTES, collective_inventory, predict_efficiency,
    )
    from snark_verifier_tpu_torch.parallel.mesh import all_gather, recording
    from snark_verifier_tpu_torch.pcs.kzg.accumulation import KzgAs
    from snark_verifier_tpu_torch.sdk.aggregation import batch_succinct_verify
    from snark_verifier_tpu_torch.sdk.tree_aggregation import (
        tree_aggregate_sharded, tree_comm_inventory,
    )
    from snark_verifier_tpu_torch.transcript.poseidon_transcript import PoseidonTranscriptPy

    D = MESH_D
    mesh = Mesh([dev] * D, ("points",))
    log(f"# mesh: {mesh} (count {torch.cuda.device_count()}: one card listed {D} times; the "
        f"shards run one after another on it, so no scaling is claimed)")
    out = {}

    # 25a: msm_sharded at n = 2^20, every add of the partials' fold captured
    n = points.shape[0]
    adds, real_add = [], cuda_ops.add

    def add(a, b):
        r = real_add(a, b)
        adds.append((a, b, r))
        return r

    cuda_ops.add = add
    try:
        cuda_ops.reset_launches()
        with recording() as ops:
            res, ovf = msm_sharded(points, scalars, mesh)
        torch.cuda.synchronize()
        launches = dict(cuda_ops.LAUNCHES)
    finally:
        cuda_ops.add = real_add
    log(f"# msm_sharded 2^{LOG2N} over {D}: launches { {k: v for k, v in launches.items() if v} }"
        f"; gathers {ops}")
    check(not bool(ovf), "msm_sharded: bucket overflow")
    check(to_affine_int(res) == want, "msm_sharded result != k_total·G")
    levels = (D - 1).bit_length()  # ceil(log2 D) fold levels, an add each
    check(launches["add"] == levels and len(adds) == levels,
          f"msm_sharded launched add {launches['add']} times, not {levels} (the partials' "
          f"fold)")
    check(launches["bucket_reduce"] == D and launches["fold_segments"] == D,
          "msm_sharded did not run one MSM a shard")
    check(D <= launches["fold_buckets"] <= 3 * D, "msm_sharded's fold_buckets launches")
    check(launches["double"] == 0, "msm_sharded launched double")
    want_ops = [{"op": "all-gather", "type": f"s32[{D},3,8]", "bytes": D * 96},
                {"op": "all-gather", "type": f"pred[{D}]", "bytes": D}]
    check(ops == want_ops, f"msm_sharded's gathers {ops}, not {want_ops}")
    add_err = 0
    for a, b, r in adds:  # the path's own adds against the plain version
        add_err = max(add_err, word_err(canon_point_words(r), canon_point_words(cuda_ops.add_plain(a, b))))
    check(add_err == 0, "add on the partials' fold differs from its plain version")
    best, runs = best_of_3(lambda: msm_sharded(points, scalars, mesh))
    log(f"# msm_sharded 2^{LOG2N} c={C_BITS} over {D} shards of one card: best-of-3 "
        f"{best * 1e3:.2f} ms = {n / best:.1f} points/s (runs {[round(t * 1e3, 2) for t in runs]} "
        f"ms); step 4's one-device msm {msm_best_s * 1e3:.2f} ms in this process")
    n4 = n // D
    best_q, runs_q = best_of_3(lambda: msm(points[:n4], scalars[:n4], device=dev))
    log(f"# msm 2^{LOG2N - 2} (one shard's size) on the card: best-of-3 {best_q * 1e3:.2f} ms "
        f"(runs {[round(t * 1e3, 2) for t in runs_q]} ms); {D} of them {D * best_q * 1e3:.2f} ms")
    a2, b2, _ = adds[0]
    add_ms = kernel_ms(lambda: real_add(a2, b2), 50)
    parts = [limbs_to_words(res).clone() for _ in range(D)]
    gather_ms = time_ms(lambda: all_gather(parts, mesh, "points"), 50)
    log(f"# the fold's first level: add at {tuple(a2.shape)} {add_ms:.4f} ms (kernel time); a "
        f"gather of {D} partials {gather_ms:.4f} ms (a same-card copy and stack, not an NVLink "
        f"hop)")
    rate = n / msm_best_s
    pred = {f"D={d}": predict_efficiency(n, d, rate, alpha_link_s=gather_ms * 1e-3,
                                         ecadd_row_s=add_ms * 1e-3)["efficiency"]
            for d in (2, 4, 8)}
    log(f"# predict_efficiency (weak scaling, 2^{LOG2N} points a device): chip rate "
        f"{rate:.1f} points/s (step 4, this run), alpha {gather_ms * 1e-3:.3e} s (this run's "
        f"gather on one card), fold level {add_ms * 1e-3:.3e} s (this run's add), bandwidth "
        f"{NVLINK_BYTES_PER_S:.3e} B/s (NVLink, H100 data sheet, each way), {PARTIAL_BYTES} B a "
        f"device: {json.dumps(pred)} (a model, not a measurement)")
    inv = collective_inventory(msm_sharded, points[:1024], scalars[:1024], mesh)
    check(inv["count"] == 2 and inv["total_bytes"] == D * 97, f"msm inventory {inv}")
    out["msm"] = dict(ms=best * 1e3, one_device_ms=msm_best_s * 1e3, shard_ms=best_q * 1e3,
                      launches=launches, gathers=ops, add_ms=add_ms, gather_ms=gather_ms,
                      predicted_efficiency=pred)

    # 25b: batch_msm_sharded on a (2, 2) mesh: dryrun's shape, then B = 4, n = 2^18
    grid = Mesh([[dev, dev], [dev, dev]], ("batch", "points"))
    base4 = py_ec.rand_points(4, seed=3)
    Bd, nd = 4, 32
    pts_d = [base4[i % 4] for i in range(Bd * nd)]
    ks_d = [(i * 7919 + 13) % (1 << 128) for i in range(Bd * nd)]
    P_d = from_affine_int(pts_d, device=dev).reshape(Bd, nd, 3, 16)
    S_d = scalars_from_int(ks_d).to(dev).reshape(Bd, nd, 16)
    got, ovf_d = batch_msm_sharded(P_d, S_d, grid, capacity=16)
    check(not bool(ovf_d.any()), "batch_msm_sharded (dryrun shape): overflow")
    for b in range(Bd):
        one, _ = msm(P_d[b], S_d[b], device=dev)
        w = py_ec.msm(pts_d[b * nd:(b + 1) * nd], ks_d[b * nd:(b + 1) * nd])
        check(to_affine_int(got[b]) == to_affine_int(one) == w,
              f"batch_msm_sharded (dryrun shape) element {b} differs")
    Bq = n // MESH_BATCH_N
    Pb = points.view(Bq, MESH_BATCH_N, 3, 16)
    Sb = scalars.view(Bq, MESH_BATCH_N, 16)
    cuda_ops.reset_launches()
    got, ovf_b = batch_msm_sharded(Pb, Sb, grid)
    torch.cuda.synchronize()
    b_launches = {k: v for k, v in cuda_ops.LAUNCHES.items() if v}
    check(not bool(ovf_b.any()), "batch_msm_sharded at 2^18: overflow")
    for b in range(Bq):
        lo = b * MESH_BATCH_N
        k_b = sum(ks[i] * (i + 1) for i in range(lo, lo + MESH_BATCH_N)) % FR.p
        one, _ = msm(Pb[b], Sb[b], device=dev)
        check(to_affine_int(got[b]) == to_affine_int(one)
              == py_ec.scalar_mul(py_ec.G1_GEN, k_b),
              f"batch_msm_sharded at 2^18: element {b} differs")
    best_b, _ = best_of_3(lambda: batch_msm_sharded(Pb, Sb, grid))
    log(f"# batch_msm_sharded on a (2, 2) mesh of one card: the dryrun shape (4, 32) and (4, "
        f"2^18) equal the one-device msm and python ints element by element; (4, 2^18) "
        f"best-of-3 {best_b * 1e3:.2f} ms; launches {b_launches}")
    out["batch_msm_ms"] = best_b * 1e3

    # 25c: batch_verify_sharded at 1,024 over the card listed D times
    vmesh = Mesh([dev] * D, ("batch",))
    srs, base = load_fixtures("snark")
    snarks = [base[i % 16] for i in range(VERIFY_BATCH)]
    cuda_ops.reset_launches()
    with recording() as v_ops:
        oks = batch_verify_sharded(snarks, srs, vmesh)
    torch.cuda.synchronize()
    v_launches = dict(cuda_ops.LAUNCHES)
    check(oks.shape == (VERIFY_BATCH,) and bool(oks.all()), "the sharded verify rejected")
    check(v_ops == [], f"the sharded verify gathered {v_ops}")
    for k in ("fr_tape", "msm_windowed", "miller_loop", "final_exp", "points_to_fr"):
        check(v_launches[k] == D, f"the sharded verify launched {k} {v_launches[k]} times, "
                                  f"not once a shard")
    check(v_launches["add"] == 0 and v_launches["double"] == 0, "the sharded verify's add")
    sharded = batch_succinct_verify_sharded(snarks, srs, vmesh)
    whole = batch_succinct_verify(snarks, srs, device=dev)
    lhs = torch.cat([acc[0][0] for acc in sharded], 0)
    rhs = torch.cat([acc[0][1] for acc in sharded], 0)
    check(bool(proj_equal(lhs, whole[0][0]).all() & proj_equal(rhs, whole[0][1]).all()),
          "a shard's accumulators differ from the one-device batch's")
    bad = [tampered(base[0])] + snarks[1:]
    oks_t = batch_verify_sharded(bad, srs, vmesh).tolist()
    check(oks_t[0] is False and all(oks_t[1:]), "the sharded verify: lane 0's tamper")
    mixed = [tampered(base[i]) if i % 2 else base[i] for i in range(D)]
    got_m = batch_verify_sharded(mixed, srs, vmesh).tolist()
    check(got_m == [i % 2 == 0 for i in range(D)], f"the mixed lanes came back {got_m}")
    best_v, runs_v = best_of_3(lambda: batch_verify_sharded(snarks, srs, vmesh))
    tm = {}
    batch_verify_sharded(snarks, srs, vmesh, timings=tm)
    log(f"# batch_verify_sharded at {VERIFY_BATCH} over {D} shards of one card: every lane "
        f"accepts, the shards' accumulators equal the one-device batch's, lane 0's tamper "
        f"rejects it alone, the mixed lanes {got_m}; launches "
        f"{ {k: v for k, v in v_launches.items() if v} }; best-of-3 {best_v * 1e3:.2f} ms = "
        f"{VERIFY_BATCH / best_v:.1f} proofs/s (runs {[round(t * 1e3, 2) for t in runs_v]} ms; "
        f"step 9's one-device {verify_rate:.1f}); phases succinct {tm['succinct_s'] * 1e3:.2f}, "
        f"decide {tm['decide_s'] * 1e3:.2f} ms")
    out["verify"] = dict(ms=best_v * 1e3, proofs_per_s=VERIFY_BATCH / best_v,
                         one_device_proofs_per_s=verify_rate)

    # 25d: tree_aggregate_sharded at TREE_LEAVES leaves, every fold level captured
    B = TREE_LEAVES
    leaves = [base[i % 16] for i in range(B)]
    levels, real_fold = [], KzgAs._fold_once

    def capture(pairs):
        r = real_fold(pairs)
        levels.append((pairs, r))
        return r

    KzgAs._fold_once = capture
    try:
        cuda_ops.reset_launches()
        with recording() as t_ops:
            lhs, rhs, ok = tree_aggregate_sharded(leaves, srs, vmesh)
        torch.cuda.synchronize()
        t_launches = dict(cuda_ops.LAUNCHES)
    finally:
        KzgAs._fold_once = real_fold
    shapes = [tuple(p.shape[:2]) for p, _ in levels]
    per = B // D
    g = KzgAs.group_size(per)
    want_shapes = ([(per // g, g), (1, per // g)] if g else [(1, per)]) * D + [(1, D)]
    check(bool(ok), "the sharded tree's root rejected")
    check(shapes == want_shapes, f"the sharded tree's fold levels {shapes}, not {want_shapes}")
    check(t_launches["fr_powers"] == len(shapes), "the sharded tree's fr_powers launches")
    check(t_launches["points_to_fr"] == D + len(shapes), "the sharded tree's points_to_fr")
    check(t_launches["miller_loop"] == 1 and t_launches["final_exp"] == 1, "one decide")
    check(t_launches["add"] == 0, "the sharded tree launched add")
    tree_want = [{"op": "all-gather", "type": f"s32[{D},3,8]", "bytes": D * 96}] * 2
    check(t_ops == tree_want, f"the sharded tree's gathers {t_ops}")
    check(tree_comm_inventory(leaves, srs, vmesh)["ops"] == t_ops,
          "tree_comm_inventory differs from the run's gathers")
    t0 = time.time()
    oracle = {}  # create_proof of each distinct group (the tiled leaves repeat)
    n_groups = 0
    for k, (pairs, (l_out, r_out)) in enumerate(levels):
        got = affine_pairs(l_out, r_out)
        for gi in range(pairs.shape[0]):
            pts = tuple(affine_pairs(pairs[gi, :, 0], pairs[gi, :, 1]))
            if pts not in oracle:
                oracle[pts] = KzgAs.create_proof(None, list(pts), PoseidonTranscriptPy())
            check(got[gi] == oracle[pts],
                  f"sharded tree fold level {k} {shapes[k]} group {gi} differs from create_proof")
            n_groups += 1
    check(proj_equal(levels[-1][1][0][0], lhs) and proj_equal(levels[-1][1][1][0], rhs),
          "the sharded root is not the last fold level's")
    log(f"# tree_aggregate_sharded gates: the root accepts; every group of every fold level "
        f"{shapes} ({n_groups} groups, {len(oracle)} distinct inputs) == create_proof on its "
        f"own inputs ({time.time() - t0:.2f}s); gathers {t_ops}")
    _, _, ok_t = tree_aggregate_sharded([tampered(base[0])] + leaves[1:], srs, vmesh)
    check(not bool(ok_t), "the sharded tree with a tampered leaf 0 accepted")
    best_t, runs_t = best_of_3(lambda: tree_aggregate_sharded(leaves, srs, vmesh))
    tm = {}
    tree_aggregate_sharded(leaves, srs, vmesh, timings=tm)
    log(f"# tree_aggregate_sharded at {B} leaves over {D} shards of one card: the tampered "
        f"leaf rejects; best-of-3 {best_t * 1e3:.2f} ms = {B / best_t:.1f} leaves/s (runs "
        f"{[round(t * 1e3, 2) for t in runs_t]} ms; step 13's one-device {tree_rate:.1f}); "
        f"phases (ms) " + ", ".join(f"{k[:-2]} {v * 1e3:.2f}" for k, v in tm.items()))
    out["tree"] = dict(ms=best_t * 1e3, leaves_per_s=B / best_t, one_device_leaves_per_s=tree_rate,
                       launches={k: v for k, v in t_launches.items() if v})

    # 25e: the inventories are O(D)
    log(f"# inventories: msm {len(ops)} gathers, {sum(o['bytes'] for o in ops)} B "
        f"(= {D}·96 + {D}); tree {len(t_ops)} gathers, {sum(o['bytes'] for o in t_ops)} B "
        f"(= 2·{D}·96); verify none")

    # 25f: the warm start
    out["warm_start"] = warm_start_phase()
    # The add's row: its path is the partials' fold, so its launches, time
    # and bound are that fold's first level; the suffix-scan shape it is
    # also timed at stays beside them as scan_*.
    row = next(r for r in kernels if r["name"] == "add")
    plain_ms = time_ms(lambda: cuda_ops.add_plain(a2, b2), 3, warmup=1)
    bms, by = bound_ms(3 * POINT_BYTES * a2.shape[0], MULADDS_PER_ADD * a2.shape[0])
    row.update({f"scan_{k}": row[k] for k in ("shape", "ms", "plain_ms", "bound_ms")
                if k in row})
    row.update(launches=launches["add"], launches_mesh_msm=launches["add"],
               shape_note="ms, shape and bound_ms: the sharded MSM's first fold level; "
                          "scan_*: the suffix-scan shape this row reported before",
               shape=list(a2.shape),
               ms=add_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               max_abs_err=max(row["max_abs_err"], add_err))
    return out


# --------------------------------------------------- step 26: host proving

HOST_PROVING_BATCH = 16  # lanes of each rebuilt proof through batch_verify
COMMIT_GATE_N = (1, 4, 5, 1023, 1024)  # Srs.commit on the card against py_ec.msm
COMMIT_TIMED_N = (1, 64, 1024, 8192)


class CommitClock:
    """Wraps a prover's commitment function: each call's n and its seconds
    on the host clock (the call ends on the host: the card's point comes
    back as python ints), and the MSM kernels' launches by proof."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, coeffs, *args, **kw):
        import torch

        t0 = time.perf_counter()
        out = self.fn(coeffs, *args, **kw)
        torch.cuda.synchronize()
        self.calls.append((len(coeffs), time.perf_counter() - t0))
        return out

    def proof(self, label, fn, smi):
        """Run one proof -> (its result, its report line's numbers)."""
        import torch
        from snark_verifier_tpu_torch.msm import cuda_ops

        self.calls = []
        cuda_ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: cuda_ops.LAUNCHES[k] for k in ("fold_buckets", "fold_segments",
                                                      "bucket_reduce")}
        commit_s = sum(s for _, s in self.calls)
        rep = {"wall_s": wall, "commit_s": commit_s, "host_s": wall - commit_s,
               "commitments": len(self.calls), "msm": launches["bucket_reduce"],
               "launches": launches, "n": sorted({n for n, _ in self.calls})}
        log(f"# {label}: wall {wall:.3f} s = commitments on the card {commit_s:.3f} s "
            f"(synchronized) + host {wall - commit_s:.3f} s; {len(self.calls)} commitments, "
            f"{launches['bucket_reduce']} msm calls, launches {launches}; sizes {rep['n']} "
            f"({smi})")
        return out, rep


def host_proving_phase(dev, smi):
    """Step 26: the repo's own proofs made again by the port's host provers,
    every commitment an `msm` on the card: the vanilla_k10 protocol and
    snark_00 / gwcsnark_00 / evmsnark_00, IPA opening 0 (without and with
    zk), BGH19 opening 0 and the IpaAs fold of the 16 openings, each equal
    to its committed file; the rebuilt proofs through `batch_verify`;
    `Srs.commit` against `py_ec.msm`; the commitment's ms by n."""
    import json
    from pathlib import Path

    import torch
    from snark_verifier_tpu_torch.ec import py_ec
    from snark_verifier_tpu_torch.ff import FR
    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.parallel import batch_verify
    from snark_verifier_tpu_torch.pcs.ipa import Bgh19, Ipa, IpaAs, IpaProvingKey
    from snark_verifier_tpu_torch.pcs.ipa import fixtures as fx
    from snark_verifier_tpu_torch.pcs.kzg.multiopen import Query
    from snark_verifier_tpu_torch.sdk.srs import load_params
    from snark_verifier_tpu_torch.system.vanilla_fixtures import demo_assignment, demo_spec
    from snark_verifier_tpu_torch.system.vanilla_plonk import compile_protocol, gen_snark
    from snark_verifier_tpu_torch.transcript import PoseidonTranscriptPy
    from snark_verifier_tpu_torch.utils.py_poly import peval
    from snark_verifier_tpu_torch.verifier.plonk.verifier import verify_snark_native

    R = FR.p
    d = Path(__file__).resolve().parent / "benchmarks" / "fixtures" / "vanilla_k10"
    t0 = time.perf_counter()
    srs = load_params(str(d / "srs.bin"))
    log(f"# host proving: srs.bin ({len(srs.g1_powers)} powers) parsed in "
        f"{time.perf_counter() - t0:.2f} s")
    clock = CommitClock(srs.commit)
    srs.commit = clock  # the instance's commit: every prover call goes through the clock
    report = {"proofs": {}}

    # gate 6 first: the card's commitment against py_ec.msm
    rng = np.random.default_rng(26)
    for n in COMMIT_GATE_N:
        c = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
        got = srs.commit(c)
        check(got == py_ec.msm(srs.g1_powers[:n], c), f"Srs.commit on the card at n = {n} "
                                                       f"differs from py_ec.msm")
        check(all(type(v) is int for v in got), "Srs.commit returned no python ints")
    check(srs.commit([0] * 1024) is None, "an all-zero polynomial did not commit to None")
    timed = {}
    for n in COMMIT_TIMED_N:
        c = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
        srs.commit(c)  # warm
        clock.calls = []
        for _ in range(5):
            srs.commit(c)
        timed[n] = min(s for _, s in clock.calls) * 1e3
    report["commit_ms"] = timed
    log(f"# Srs.commit on the card equals py_ec.msm at n = {COMMIT_GATE_N} and is None on "
        f"zeros; ms a commitment (best of 5, host clock, the point back as python ints): "
        + ", ".join(f"n = {n}: {ms:.3f}" for n, ms in timed.items()) + f" ({smi})")

    # gates 1-2: the protocol and the three proofs
    spec = demo_spec(10)
    asg = demo_assignment(spec, seed=0)
    protocol, rep = clock.proof("compile_protocol (vanilla k = 10)", lambda: compile_protocol(
        spec, asg.fixed, asg.copies, srs), smi)
    report["proofs"]["compile_protocol"] = rep
    check(protocol.to_json() == json.loads((d / "protocol.json").read_text()),
          "compile_protocol on the card != protocol.json")
    rebuilt = {}
    for name, scheme, tr in (("snark_00", "shplonk", "poseidon"),
                             ("gwcsnark_00", "gwc", "poseidon"),
                             ("evmsnark_00", "shplonk", "evm")):
        sn, rep = clock.proof(f"gen_snark {name} ({scheme}, {tr})", lambda: gen_snark(
            asg, protocol, srs, scheme, seed=0, transcript=tr), smi)
        report["proofs"][name] = rep
        check(sn.to_json() == json.loads((d / f"{name}.json").read_text()),
              f"gen_snark on the card != {name}.json")
        rebuilt[name] = (sn, scheme, tr)
    log("# protocol.json, snark_00, gwcsnark_00 and evmsnark_00 rebuilt exactly, every "
        "commitment on the card")
    srs.commit = clock.fn

    # gates 3-4: the rebuilt proofs verify
    check(verify_snark_native(rebuilt["snark_00"][0], srs), "verify_snark_native rejects snark_00")
    B = HOST_PROVING_BATCH
    for name, (sn, scheme, tr) in rebuilt.items():
        oks = batch_verify([sn] * B, srs, scheme, tr)
        check(bool(oks.all()), f"batch_verify rejects the rebuilt {name}")
        oks = batch_verify([tampered(sn)] + [sn] * (B - 1), srs, scheme, tr)
        check(not bool(oks[0]) and bool(oks[1:].all()), f"{name}: the tampered lane")
    log(f"# the rebuilt proofs through batch_verify at {B} lanes each (their scheme and "
        f"transcript): all accept, a tampered instance rejects lane 0 alone; "
        f"verify_snark_native accepts snark_00")

    # gate 5: the IPA proofs at k = 11
    zk_key = fx.ipa_proving_key()
    keys = {True: zk_key, False: IpaProvingKey(zk_key.k, zk_key.g, zk_key.h)}
    for key in keys.values():
        key._msm = CommitClock(key._msm)

    def rand(rng, n):
        return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]

    files = {name: json.loads((fx.FIXTURES / f"ipa_{name}_k{fx.K}.json").read_text())
             for name in ("openings", "bgh19", "as")}
    for zk in (False, True):  # tests/test_torch_ipa.py::_make_opening(pk, zk, 0)
        key = keys[zk]
        rng = np.random.default_rng(1000 * zk)
        p = rand(rng, key.n)
        omega = rand(rng, 1)[0] if zk else None
        c = key.commit(p, omega)
        z = rand(rng, 1)[0]
        tr = PoseidonTranscriptPy()
        acc, rep = key._msm.proof(f"Ipa.create_proof (k = {fx.K}, zk {zk})", lambda: Ipa.
                                  create_proof(key, p, z, omega, tr, seed=2000 + 100 * zk), smi)
        report["proofs"][f"ipa_zk{int(zk)}"] = rep
        got = {"c": fx.pt_hex(c), "z": fx.fr_hex(z), "v": fx.fr_hex(peval(p, z)),
               **fx.streams_to_json(*tr.streams()), "acc": fx.acc_to_json(acc)}
        check(got == files["openings"]["zk" if zk else "plain"][0],
              f"IPA opening 0 (zk {zk}) != ipa_openings_k{fx.K}.json")
    key = keys[False]
    rng = np.random.default_rng(3000)  # _make_bgh19(pk, 0)
    polys = [rand(rng, key.n) for _ in range(3)]
    x = rand(rng, 1)[0]
    queries = [(0, 1, peval(polys[0], x)), (0, 7, peval(polys[0], 7 * x % R)),
               (1, 1, peval(polys[1], x)), (2, 1, peval(polys[2], x))]
    tr = PoseidonTranscriptPy()
    acc, rep = key._msm.proof(f"Bgh19.open (k = {fx.K})", lambda: Bgh19.open(
        key, polys, [Query(*q) for q in queries], x, tr, seed=4000), smi)
    report["proofs"]["bgh19"] = rep
    got = {"commitments": [fx.pt_hex(key.commit(p)) for p in polys], "x": fx.fr_hex(x),
           "queries": [[p, sh, fx.fr_hex(ev)] for p, sh, ev in queries],
           **fx.streams_to_json(*tr.streams()), "acc": fx.acc_to_json(acc)}
    check(got == files["bgh19"]["openings"][0], f"BGH19 opening 0 != ipa_bgh19_k{fx.K}.json")
    fold = files["as"]["folds"][0]  # _make_fold(pk, False, the 16 accumulators, 5000)
    accs = [fx.acc_from_json(a) for a in fold["accs"]]
    tr = PoseidonTranscriptPy()
    acc, rep = key._msm.proof(f"IpaAs.create_proof (16 accumulators, k = {fx.K})",
                              lambda: IpaAs.create_proof(key, accs, tr, seed=5000), smi)
    report["proofs"]["ipa_as"] = rep
    got = {"zk": 0, "accs": fold["accs"], **fx.streams_to_json(*tr.streams()),
           "acc": fx.acc_to_json(acc)}
    check(got == fold, f"the IpaAs fold != ipa_as_k{fx.K}.json")
    log("# IPA opening 0 (without and with zk), BGH19 opening 0 and the IpaAs fold of 16 "
        "rebuilt exactly, every MSM on the card")
    report["launches"] = {k: sum(r["launches"][k] for r in report["proofs"].values())
                          for k in ("fold_buckets", "fold_segments", "bucket_reduce")}
    return report


# ------------------------------ step 27: the EVM verifier, the CLI, the oracle

EIP170_LIMIT = 24576
CLI_COMMANDS = (
    ("verify shplonk", ["verify", "--scheme", "shplonk"]),
    ("verify gwc", ["verify", "--scheme", "gwc"]),
    ("aggregate", ["aggregate", "--n", "4"]),
    ("aggregate-mixed", ["aggregate-mixed"]),
    ("tree", ["tree", "--n", "16", "--fanout", "4"]),
    ("bench-msm", ["bench-msm", "--log2n", str(LOG2N)]),
    ("gen-evm-verifier", ["gen-evm-verifier", "--k", "3", "--out", None]),
)
# two trees (honest, then leaf 0 tampered) of 16 leaves at fanout 4: four
# group folds of N = 4 and a root fold of N = 4 each, then one decide each
TREE_METER = {"msm": 2 * 5 * 2, "msm_terms": 2 * 5 * 2 * 4, "pairing": 2 * 2}
NATIVE_N = 1024


def evm_verifier_phase(dev, smi):
    """Step 27a: the generated EVM verifier of the evmsnark protocol, run by
    the port's Yul interpreter on the 16 committed proofs and a tampered
    one, each verdict held to the card's keccak `batch_verify`."""
    import torch
    from snark_verifier_tpu_torch.loader.yul_interp import execute_yul
    from snark_verifier_tpu_torch.parallel import batch_verify
    from snark_verifier_tpu_torch.sdk.evm import encode_calldata, gen_evm_verifier_report
    from snark_verifier_tpu_torch.sdk.proof_io import proof_to_bytes

    srs, snarks = load_fixtures("evmsnark")
    t0 = time.perf_counter()
    yul, rep = gen_evm_verifier_report(snarks[0].protocol, srs, "shplonk")
    gen_s = time.perf_counter() - t0
    check(rep["estimated_code_size"] < EIP170_LIMIT,
          f"estimated code size {rep['estimated_code_size']} >= {EIP170_LIMIT}")
    log(f"# 27a gen_evm_verifier (evmsnark protocol, vanilla k = 10, shplonk, srs.bin): "
        f"{len(yul)} B of Yul in {gen_s:.3f} s; estimated gas {rep['estimated_gas']}, "
        f"estimated code size {rep['estimated_code_size']} (host CPU of {smi})")
    lanes = list(snarks) + [tampered(snarks[0])]
    verdicts, gas, secs = [], [], []
    for s in lanes:
        cd = encode_calldata(s.instances, proof_to_bytes(s, "shplonk", fmt="evm"))
        t0 = time.perf_counter()
        ok, g, _ = execute_yul(yul, cd)
        secs.append(time.perf_counter() - t0)
        verdicts.append(ok)
        gas.append(g)
    check(verdicts == [True] * len(snarks) + [False],
          f"the EVM verifier's verdicts {verdicts}: the 16 must accept, the tampered revert")
    bits = [bool(v) for v in batch_verify(lanes, srs, "shplonk", "evm", device=dev)]
    torch.cuda.synchronize()
    check(bits == verdicts, f"the EVM verdicts {verdicts} != the card's batch_verify {bits}")
    honest = gas[:-1]
    log(f"# 27a evm_verify: the 16 evmsnark proofs accepted, gas_used {min(honest)}..."
        f"{max(honest)}; lane 0 tampered reverted at gas {gas[-1]}; "
        f"{sum(secs) / len(secs):.3f} s an execution ({min(secs):.3f}...{max(secs):.3f}, "
        f"host CPU of {smi}); every verdict equals the card's batch_verify(..., \"shplonk\", "
        f"\"evm\") lane by lane")
    return {"yul_bytes": len(yul), "gen_s": gen_s, **rep, "gas_used": [min(honest),
            max(honest)], "tampered_gas": gas[-1], "exec_s": sum(secs) / len(secs)}


def cli_phase(kernels, msm_best_s, smi):
    """Step 27b: the CLI's commands in this process on the card, each with
    its PASS, wall, cost-meter span and kernel launches."""
    import contextlib
    import io
    import tempfile

    import torch
    from snark_verifier_tpu_torch.__main__ import main as cli_main
    from snark_verifier_tpu_torch.msm import cuda_ops
    from snark_verifier_tpu_torch.utils.timing import METER

    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, argv in CLI_COMMANDS:
            argv = [a if a is not None else str(Path(tmp) / "verifier.yul") for a in argv]
            METER.spans.pop(argv[0], None)
            out, err = io.StringIO(), io.StringIO()
            cuda_ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                cli_main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in cuda_ops.LAUNCHES.items() if v}
            text = out.getvalue()
            for line in text.splitlines():
                log(f"#   {label}: {line}")
            check("PASS" in text.splitlines(), f"CLI {label}: no PASS")
            check("# cost-meter" in err.getvalue(), f"CLI {label}: no cost-meter report")
            span = dict(METER.spans.get(argv[0], {}))
            report[label] = {"wall_s": wall, "meter": span, "launches": launches}
            log(f"# 27b CLI {' '.join(argv)}: PASS in {wall:.2f} s (wall, {smi}); "
                f"cost-meter {span}; launches {launches}")
            if label == "bench-msm":
                m = re.search(r"best of 3 ([0-9.]+) ms = ([0-9.]+) points/s", text)
                check(m is not None, "bench-msm printed no points/s")
                report[label].update(ms=float(m.group(1)), points_per_s=float(m.group(2)))
    check(report["tree"]["meter"] == TREE_METER,
          f"tree's cost meter {report['tree']['meter']} != {TREE_METER}")
    check(not report["gen-evm-verifier"]["launches"], "gen-evm-verifier launched kernels")
    n = 1 << LOG2N
    b = report["bench-msm"]
    log(f"# 27b bench-msm 2^{LOG2N}: {b['ms']:.2f} ms = {b['points_per_s']:.1f} points/s beside "
        f"step 4's best {msm_best_s * 1e3:.2f} ms = {n / msm_best_s:.1f} points/s "
        f"(ratio {b['ms'] / (msm_best_s * 1e3):.3f})")
    for row in kernels:
        counts = {label: r["launches"][row["name"]] for label, r in report.items()
                  if row["name"] in r["launches"]}
        row["launches_cli"] = counts
    return report


def native_phase(dev, smi):
    """Step 27c: the g++-built host core against the card's msm."""
    import torch
    from snark_verifier_tpu_torch.ec import py_ec, to_affine_int
    from snark_verifier_tpu_torch.ff import FR
    from snark_verifier_tpu_torch.msm import msm, scalars_from_int
    from snark_verifier_tpu_torch.utils import native

    t0 = time.perf_counter()
    check(native.available(), "utils.native is not available on the card host (no g++?)")
    build_s = time.perf_counter() - t0
    limbs = native.enumerate_points_dev(NATIVE_N)  # [1..n]·G, the layout msm takes
    pts = to_affine_int(torch.from_numpy(limbs.astype(np.int64)))
    rng = np.random.default_rng(27)
    ks = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(NATIVE_N)]
    t0 = time.perf_counter()
    host = native.msm(pts, ks)
    host_s = time.perf_counter() - t0
    out, ovf = msm(limbs, scalars_from_int(ks), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, ovf = msm(limbs, scalars_from_int(ks), device=dev)
    card = to_affine_int(out)
    card_s = time.perf_counter() - t0
    want = py_ec.scalar_mul(py_ec.G1_GEN, sum(k * (i + 1) for i, k in enumerate(ks)) % FR.p)
    check(not bool(ovf) and card == host == want,
          "native.msm, the card's msm and k_total·G disagree at n = 1,024")
    log(f"# 27c native: available (g++ build and load {build_s:.2f} s); native.msm at n = "
        f"{NATIVE_N} == the card's msm == k_total·G; native {host_s * 1e3:.2f} ms, the card's "
        f"msm call {card_s * 1e3:.2f} ms (host clock, {smi})")
    return {"build_s": build_s, "native_ms": host_s * 1e3, "card_ms": card_s * 1e3}


def canon_point_words(w):
    """(..., 3, 8) point words -> their canonical Fq limbs, coordinate by
    coordinate (two lazy forms of one projective triple compare equal)."""
    from snark_verifier_tpu_torch.ec import words_to_limbs
    from snark_verifier_tpu_torch.ff import FQ_FIELD

    return FQ_FIELD.canon(words_to_limbs(w))


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
    check(launches["fold_segments"] == 1, "the msm did not launch fold_segments exactly once "
                                          "(the top window's second pass)")
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

    best, times = best_of_3(lambda: msm(points, scalars, c=C_BITS))
    msm_best = best
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
    use = ptxas_usage("bucket_reduce_kernel")
    log(f"# bucket_reduce at {tuple(stacked.shape[:2])}: {ms:.4f} ms (bound {bms:.6f} ms, "
        f"{by}; chain floor {floor:.4f} ms = {BUCKET_REDUCE_CHAIN_MULS} multiplies on teams of "
        f"{BUCKET_REDUCE_TEAM}, the least {BUCKET_REDUCE_LEAST_CHAIN_MULS}); ptxas {use}; plain "
        f"{red_plain_ms:.1f} ms; affine-equal to the plain version")
    kernels.append(dict(
        name="bucket_reduce", route="cuda", source="snark_verifier_tpu_torch/csrc/msm_loops.cuh",
        replaces="snark_verifier_tpu/msm/pippenger.py:276",
        also_replaces=["snark_verifier_tpu/msm/pippenger.py:284"],
        launches=launches["bucket_reduce"], max_abs_err=errs["bucket_reduce"], ms=ms,
        plain_ms=red_plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
        shape=list(stacked.shape), chain_floor_ms=floor, chain_muls=BUCKET_REDUCE_CHAIN_MULS,
        least_chain_muls=BUCKET_REDUCE_LEAST_CHAIN_MULS, team=BUCKET_REDUCE_TEAM,
        ptxas_registers=use["registers"], ptxas_spill_bytes=use["spill_bytes"],
        tolerance="exact, affine"))

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
    # The split at other segment counts: SPLIT_ROWS is the most rows the
    # first pass may have, so the top window's 49 rows get SPLIT_ROWS // 49
    # segments each.  Each result against the whole window's fold.
    whole_top = cuda_ops.fold_buckets(points_ext, idx_top)
    split_in_use, split_sweep = cuda_ops.SPLIT_ROWS, {}
    try:
        for segs in SPLIT_SEGMENTS:
            cuda_ops.SPLIT_ROWS = segs * idx_top.shape[0]
            eq = proj_equal(cuda_ops.fold_buckets_split(points_ext, idx_top), whole_top)
            check(bool(eq.all()), f"fold_buckets_split at {segs} segments a row differs from "
                                  f"the whole fold in {int((~eq).sum())} buckets")
            split_sweep[cuda_ops.SPLIT_ROWS] = time_ms(
                lambda: cuda_ops.fold_buckets_split(points_ext, idx_top), 10)
    finally:
        cuda_ops.SPLIT_ROWS = split_in_use
    del whole_top
    plain = time_ms(lambda: cuda_ops.fold_buckets_plain(points_ext, idx_main), 1, warmup=1)
    bms, by = fold_bounds["main"]
    log(f"# fold_buckets: one main window {tuple(idx_main.shape)} {ms:.4f} ms (bound {bms:.4f}); "
        f"all main windows {tuple(idx_rows.shape)} in one launch {ms_all:.4f} ms (bound "
        f"{fold_bounds['all'][0]:.4f}); top window {tuple(idx_top.shape)} whole {ms_top:.4f} ms, "
        f"split (fold_buckets_split, with its fold_segments pass) {ms_split:.4f} ms at "
        f"SPLIT_ROWS {split_in_use} (bound {fold_bounds['top'][0]:.4f})")
    log("# fold_buckets_split at the top window, by SPLIT_ROWS (segments a row = SPLIT_ROWS // "
        f"{idx_top.shape[0]}): " + ", ".join(f"{r}: {t:.4f} ms" for r, t in split_sweep.items()))
    kernels.append(dict(
        name="fold_buckets", route="cuda", source="snark_verifier_tpu_torch/csrc/msm_kernels.cu",
        replaces="snark_verifier_tpu/msm/pallas_ops.py:490", launches=launches["fold_buckets"],
        max_abs_err=errs["fold_buckets"], ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=None, shape=list(idx_main.shape), tolerance="exact, affine",
        all_shape=list(idx_rows.shape), all_ms=ms_all, all_bound_ms=fold_bounds["all"][0],
        top_shape=list(idx_top.shape), top_ms=ms_top, top_split_ms=ms_split,
        top_bound_ms=fold_bounds["top"][0], launches_fold_segments_msm=launches["fold_segments"],
        split_rows=split_in_use, top_split_sweep_ms=split_sweep))

    # add throughput at a large batch (the ladder's last step), for PERF.md
    big = 1 << 19
    ba, bb2 = pts_w[:big].contiguous(), pts_w[big:].contiguous()
    ms_big = time_ms(lambda: cuda_ops.add(ba, bb2), 10)
    ms_dbig = time_ms(lambda: cuda_ops.double(ba), 10)
    log(f"# add at B=2^19: {ms_big:.4f} ms ({big / ms_big / 1e6:.3f} G adds/s, bound "
        f"{bound_ms(3 * POINT_BYTES * big, MULADDS_PER_ADD * big)[0]:.4f} ms); "
        f"double at B=2^19: {ms_dbig:.4f} ms (bound "
        f"{bound_ms(2 * POINT_BYTES * big, MULADDS_PER_DOUBLE * big)[0]:.4f} ms)")
    del pts_w, points_ext, digits, sa, sb, saw, sbw, ba, bb2, stacked  # points, scalars: steps 24-25
    del idx_all, idx_rows, idx_main, idx_top, idx_t, pe, d_all
    torch.cuda.empty_cache()

    # ------------------------- the dense folds, the probe, the succinct verify
    t0 = time.time()
    us_per_add = probe_phase(dev, kernels)
    log(f"# probe phase: {time.time() - t0:.1f}s")
    t0 = time.time()
    dense_fold_phase(dev, kernels, us_per_add)
    log(f"# dense fold phase: {time.time() - t0:.1f}s")
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
    t0 = time.time()
    gwc_rate, gwc_launches = gwc_phase(dev, kernels)
    log(f"# gwc phase: {time.time() - t0:.1f}s; {gwc_rate:.1f} gwc verify proofs/s")
    t0 = time.time()
    leaves, tree_launches, levels = tree_phase(dev)
    log(f"# tree phase: {time.time() - t0:.1f}s; {leaves:.1f} leaves/s")
    t0 = time.time()
    accumulation_kernel_checks(dev, kernels, tree_launches, levels)
    log(f"# accumulation kernel checks: {time.time() - t0:.1f}s")
    t0 = time.time()
    old_acc_phase(dev)
    log(f"# old accumulator phase: {time.time() - t0:.1f}s")
    t0 = time.time()
    evm_rate, evm_launches, read, challenges = evm_phase(dev, kernels)
    log(f"# evm phase: {time.time() - t0:.1f}s; {evm_rate:.1f} keccak verify proofs/s")
    t0 = time.time()
    squeeze_err, squeeze_kat = keccak_kernel_checks(dev)
    keccak_read_checks(dev, kernels, evm_launches, read, challenges, squeeze_err, squeeze_kat)
    log(f"# keccak kernel checks: {time.time() - t0:.1f}s")
    t0 = time.time()
    inv_kernel_checks(dev, kernels, tree_launches)
    log(f"# field_inv checks: {time.time() - t0:.1f}s")
    t0 = time.time()
    points_to_fr_checks(dev, kernels, verify_launches, gwc_launches, tree_launches, levels)
    log(f"# points_to_fr checks: {time.time() - t0:.1f}s")

    t0 = time.time()
    ick_launches, ick_row = ick_phase(dev)
    ick_batch_launches = ick_keccak_batch(dev)
    row = next(r for r in kernels if r["name"] == "points_to_fr")
    row.update(launches_ick_keccak=ick_launches["points_to_fr"],
               launches_ick_keccak_batch=ick_batch_launches["points_to_fr"], to_affine=ick_row)
    row["also_replaces"].append("snark_verifier_tpu/transcript/evm_transcript.py:119")
    row = next(r for r in kernels if r["name"] == "keccak_read")
    row.update(launches_ick_keccak=ick_launches["keccak_read"],
               launches_ick_keccak_batch=ick_batch_launches["keccak_read"])
    log(f"# ick phase (Poseidon and keccak): {time.time() - t0:.1f}s")
    t0 = time.time()
    ipa_rates = ipa_openings_phase(dev, kernels)
    log(f"# ipa phase: {time.time() - t0:.1f}s; {ipa_rates[False]:.1f} IPA succinct proofs/s")
    t0 = time.time()
    ipa_family_phase(dev)
    log(f"# bgh19 / ipa_as / decide at 2^11 phase: {time.time() - t0:.1f}s")
    t0 = time.time()
    decide_s = ipa_decide_phase(dev, kernels, points)
    log(f"# decide at 2^20 phase: {time.time() - t0:.1f}s; {decide_s * 1e3:.3f} ms")
    t0 = time.time()
    mesh = mesh_phase(dev, kernels, points, scalars, ks, want, msm_best, rate, leaves)
    log(f"# mesh phase: {time.time() - t0:.1f}s; msm_sharded {mesh['msm']['ms']:.2f} ms, "
        f"verify {mesh['verify']['proofs_per_s']:.1f} proofs/s, tree "
        f"{mesh['tree']['leaves_per_s']:.1f} leaves/s, warm start cold "
        f"{mesh['warm_start']['cold']['process_wall_s']:.2f} s, warm "
        f"{mesh['warm_start']['warm']['process_wall_s']:.2f} s")
    del points, scalars
    t0 = time.time()
    hp = host_proving_phase(dev, smi)
    for row in kernels:
        if row["name"] in hp["launches"]:
            row["launches_host_proving"] = hp["launches"][row["name"]]
    log(f"# host proving phase: {time.time() - t0:.1f}s; launches over its proofs "
        f"{hp['launches']}")

    t0 = time.time()
    evm = evm_verifier_phase(dev, smi)
    log(f"# 27a EVM verifier phase: {time.time() - t0:.1f}s; gas_used {evm['gas_used']}")
    t0 = time.time()
    cli = cli_phase(kernels, msm_best, smi)
    log(f"# 27b CLI phase: {time.time() - t0:.1f}s; walls (s) "
        f"{ {k: round(v['wall_s'], 2) for k, v in cli.items()} }")
    t0 = time.time()
    native_phase(dev, smi)
    log(f"# 27c native phase: {time.time() - t0:.1f}s")

    check("jax" not in sys.modules and "snark_verifier_tpu" not in sys.modules,
          "the port pulled in jax or the JAX package")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
