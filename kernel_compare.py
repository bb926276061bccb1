#!/usr/bin/env python3
"""Time this checkout's kernels beside another checkout's, in one process on
one card: the only fair comparison of two versions of a kernel.

    python3 kernel_compare.py --parent DIR [--log2n 20] [--out FILE] [--only PARTS]

`DIR` is the csrc/ directory of the other checkout (for example one unpacked
with `git archive <commit> snark_verifier_tpu_torch/csrc`).  Its
`fold_kernels.cu`, `msm_kernels.cu`, `msm_loops.cu` and `poseidon_kernels.cu` (and, where
it has them, `field_kernels.cu`, `keccak_kernels.cu`,
`accumulation_kernels.cu` and `ipa_kernels.cu`) are built side by side
with nvcc, each against the headers beside it, and its entry points are
called as the port has declared them since the fold took a team size (the
other checkout must be one whose `svt_fold_buckets` takes it):

* `svt_fq_mul_chain(a, b, out, n, ch, stream)` (a parent whose entry takes
  a route gets route 0): chains of dependent Fq multiplies and squares at
  B = 2^17, CH = 16, 0 and 256, and at 2^20, CH = 16, beside this
  checkout's both routes (0: fq.cuh's integer words, 1: fq_f64.cuh's FP64
  limbs) and the variants of `csrc/probe/chain_variants.cu` (the FP64
  square as x·x; route 2, even warps integer and odd warps FP64), each
  held to the plain version after `canon`, with the integer and FP64
  pipes' floors and each side's share, ptxas's registers and spills and
  each chain kernel's SASS opcode counts and its loop's instructions by
  class (cuobjdump); each route sustained at 2^20, CH = 256 with the SM
  clock and power `nvidia-smi` reads meanwhile, and the card's own FP64
  FMA rate (the probe's `svt_f64_peak`);
* `svt_g1_add_chain(a, b, out, n, ch, stream)` (`--only add_chain`) at B =
  256 and 2^17, CH = 16, beside this checkout's (the least group law,
  canonical words) and each blocks-an-SM variant of
  `csrc/probe/chain_variants.cu`, held to the plain version after `canon`,
  with the bound (1,416 multiply-adds an add) and each one's share;
* `svt_fold_buckets(points, idx, nb, cap, sentinel, out, team, stream)`: one
  main window (256, cap) and the whole top window of the 2^`log2n` MSM's
  slot indices (points [1..n]·G, scalars from numpy seed 42), each with the
  team this checkout picks for its row count;
* `svt_fold_segments`: the three dense walks (`fold_buckets_chunked` K = 8,
  `fold_buckets_halving` 4 layers, `fold_buckets_grid_dense` 512 / 4) over
  the micro-benchmarks' (256, 4,624) matrix of G or the identity, each level
  alone (timed queued behind a spin of the card, so the host's time per call
  is not counted), and the MSM's top window split into segments
  (`fold_buckets_split` at the parent's 384 rows against this checkout's
  SPLIT_ROWS).  A parent whose entry point takes no team, `(mat, nb, w,
  wout, G, CW, S, count, out, stream)`, gets each level's matrix padded
  with identity rows to the grouping's width, as its walks padded it; one
  that takes `(..., count, team, out, stream)` reads the matrix in place
  with this checkout's team;
* `svt_poseidon_permute(in, out, n, stream)` at B = 1,024 and 65,536;
* where the other checkout has them: `svt_field_inv(field, a, out, n,
  stream)` in both fields at the tree's 2,048, 64 and 4 elements and at
  1,024 (held to the plain version after `canon`: a Fermat inverse is
  lazy, the binary GCD's canonical), and `svt_keccak_squeeze(words, tags,
  W, pad, L, scratch, hash, chal, n, stream)`, a launch a squeeze, over the
  keccak verify read of the 16 `evmsnark` fixtures tiled to 1,024 (the
  buffers gathered before the timing) beside this checkout's one
  `svt_keccak_read` launch of the same read;
* where the other checkout has them: `svt_fr_powers(r, n, out, B, stream)`
  at the tree's (32, 32), (1, 32), (1, 1) and at (1,024, 33) beside this
  checkout's (held to `powers_plain`); and the Poseidon transcript's Fq ->
  Fr map as the launches the other checkout made -- `svt_field_mul` by
  plain 1, `svt_field_canon`, `svt_field_mul` by R^2 (Fr), after
  `svt_field_inv` of Z and `svt_field_mul` of (X, Y) by Z^-1 (its wrapper's
  copy of Z^-1 beside each coordinate included) in projective mode -- beside
  this checkout's one `svt_points_to_fr` launch: projective at the tree's
  2,048, 64 and 4 points (identity lanes among them), affine at the verify
  batch's (1,024, 16, 2) (held to `points_to_fr_plain`), each timed once
  queued behind a spin of the card (`kernel_ms`: the kernels' own time) and
  once as called (`time_ms`: the host's time per launch included);
* `svt_msm_windowed` and `svt_bucket_reduce` (`msm_loops.cuh`), the point
  loops: the verify MSM at (1,024, 26), (1,024, 34), (1,024, 4), (1,024,
  17), (64, 32), (2, 32) and (1, 26) (bases tiled, numpy-seeded scalars),
  the parent called with its own arguments (with the layout this checkout
  picks where it takes one), beside this checkout's wrapper and beside each
  team size at its own blocks (rows `msm_windowed_team`, `chosen` where it
  is the wrapper's); and the weighted bucket sums plus window combine over
  the 2^`log2n` MSM's own (32, 256) bucket sums, beside this checkout's
  `svt_bucket_reduce`; all queued behind a spin of the card.  With
  `--only loop_variants` (not in the default run: its library takes many
  minutes to build) also the variants of `csrc/probe/point_loop_variants.cu`,
  built as its own library: for teams of 2 or more the products exchanged
  by shuffles (`msm_windowed_shuffle`), and `svt_bucket_reduce` at every
  team size with either exchange (`bucket_reduce_team`);
* where the other checkout has it: `svt_ipa_h_coeffs(xi, k, s, out,
  stream)` at k = 5, 11 and 20 (ξ from numpy seed 24, s = 1 and a random
  s), each version held to `h_coeffs_plain` and to the other word for
  word, with the bytes it stores a second and its share of the bytes'
  bound; and beside them this checkout's other store route,
  `csrc/probe/ipa_h_coeffs_vec.cu` (`svt_ipa_h_coeffs_vec`: the same
  tables, a tile's canonical words staged in shared memory and stored 16
  bytes a thread), built as its own library (rows of kind
  `ipa_h_coeffs_vec`, whose "parent" columns are that route's);
* where the other checkout has it: `svt_fr_tape`, the recorded Fr program,
  called as the other checkout declares it (the tape's rows in order, or
  a team schedule where its entry point takes a team), beside this
  checkout's wrapper at every team size (rows `fr_tape_team`, `chosen`
  where the team is the wrapper's), each held to `run_plain` word for
  word: the SHPLONK tape on the 16 vanilla fixtures' gathered inputs at
  (35, 1,024) and (35, 1), the GWC19 tape on the `gwcsnark` fixtures' at
  1,024, the IPA k = 11 and ick keccak tapes on random lazy words at
  1,024 (`fr_tape_cases`); kernel time, queued behind a spin of the card;
* `to_affine` (this checkout alone): the keccak read's normalisation of
  instance commitments, one `svt_points_to_fr` launch with `map_fr=False`,
  beside the two launches of `cuda_ops.affine_xy` (`svt_field_inv`,
  `svt_field_mul`) it replaced, at (1,024, 1) and (1,024, 4) projective
  points (identity lanes among them), both held to the plain version
  (`affine_xy`'s lazy words after `canon`); the "parent" columns are
  `affine_xy`'s.

* `svt_g1_add(a, b, out, n, stream)` and `svt_g1_double(a, out, n,
  stream)` (alone: `--only g1_batch`) at n = 2^(`log2n` - 1) (the ladder's points
  [1..n]·G against [n+1..2n]·G), 1,000 and 2 (the sharded MSM's first fold
  level), the parent's lazy words and this checkout's canonical ones each
  held to the plain version after `canon`; beside this checkout's wrapper,
  each variant of `csrc/probe/g1_batch_variants.cu` in `G1_VARIANTS` (the
  shared reduction on or off, bulk or direct loads, 3 to 6 blocks an SM;
  rows `g1_add_variant` and
  `g1_double_variant`, whose "parent" columns are the variant's), built as
  its own library; kernel time, queued behind a spin of the card, with the
  bound (the least multiply-adds, 1,416 an add and 960 a double, against
  the bytes) and each side's share of it;

This checkout's kernels run through their wrappers on the same tensors.
Each pair is timed with CUDA events in the order parent, this, this, parent,
and both outputs are held against the plain PyTorch version: multiplies and
permutations bit for bit, folds, MSMs and reductions as affine points.  Prints the card's name
and power limit and one JSON object per line (also written to `--out`);
exits 1 if any output disagrees.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
PARENT_UNITS = {
    "fold_kernels": {"svt_fq_mul_chain": [_P, _P, _P, _LL, _I, _P],
                     "svt_g1_add_chain": [_P, _P, _P, _LL, _I, _P],
                     "svt_fold_segments": [_P, _LL, _LL, _LL, _LL, _LL, _LL, _I, _P, _P]},
    "msm_kernels": {"svt_fold_buckets": [_P, _P, _LL, _LL, _I, _P, _I, _P],
                    "svt_g1_add": [_P, _P, _P, _LL, _P], "svt_g1_double": [_P, _P, _LL, _P]},
    "msm_loops": {"svt_msm_windowed": [_P, _P, _LL, _I, _P, _P],
                  "svt_bucket_reduce": [_P, _P, _P, _P]},
    "poseidon_kernels": {"svt_poseidon_load_constants": [_P, _P],
                         "svt_poseidon_permute": [_P, _P, _LL, _P]},
    # optional: compared where the other checkout exports them
    "field_kernels": {"svt_field_inv": [_I, _P, _P, _LL, _P],
                      "svt_field_mul": [_I, _P, _LL, _P, _LL, _P, _LL, _P],
                      "svt_field_canon": [_I, _P, _P, _LL, _P]},
    "keccak_kernels": {"svt_keccak_squeeze": [_P, _P, _I, _P, _I, _P, _P, _P, _LL, _P]},
    "accumulation_kernels": {"svt_fr_powers": [_P, _I, _P, _LL, _P]},
    "ipa_kernels": {"svt_ipa_h_coeffs": [_P, _I, _P, _P, _P]},
    "fr_tape": {"svt_fr_tape": [_P, _I, _P, _P, _P, _LL, _I, _P]},
}
# The batch kernels' variants timed beside the library (sum, bulk, blocks an
# SM): csrc/probe/g1_batch_variants.cu.
G1_VARIANTS = {
    "g1_add": [(s, b, 3) for s in (1, 0) for b in (1, 0)] + [(1, b, 4) for b in (1, 0)],
    "g1_double": [(s, b, 3) for s in (1, 0) for b in (1, 0)]
                 + [(1, b, k) for k in (4, 5, 6) for b in (1, 0)],
}
OPTIONAL_UNITS = ("field_kernels", "keccak_kernels", "accumulation_kernels", "ipa_kernels",
                  "fr_tape")


def build_parent(csrc: Path, out_dir: Path):
    """{entry point: ctypes function} of the parent's units, one nvcc
    process each, all started together (an optional unit or entry point the
    parent lacks is left out)."""
    from snark_verifier_tpu_torch import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    flags = _build.ARCH_FLAGS + ["-O3", "-shared", "-Xcompiler", "-fPIC"]
    procs = {}
    for unit in PARENT_UNITS:
        if unit in OPTIONAL_UNITS and not (csrc / f"{unit}.cu").exists():
            continue
        lib = out_dir / f"libparent_{unit}.so"
        cmd = [_build._nvcc(), *flags, "-o", str(lib), str(csrc / f"{unit}.cu")]
        procs[unit] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    fns = {}
    for unit, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {unit}.cu:\n{out}")
        loaded = ctypes.CDLL(str(lib))
        for name, argtypes in PARENT_UNITS[unit].items():
            if unit in OPTIONAL_UNITS and not hasattr(loaded, name):
                continue
            fn = getattr(loaded, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[name] = fn
    return fns


def time_ms(fn, reps, warmup=2):
    """Mean ms per call over `reps` calls, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps, warmup=2):
    """`time_ms` with the calls queued behind a ~2 ms spin of the card, so
    that the host has launched them all before the first one runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(4_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sustained_clock(fn, seconds=2.0):
    """(median SM clock in MHz, median power draw in W) that nvidia-smi reads
    every 100 ms while `fn` runs back to back for `seconds` (the first three
    samples dropped)."""
    import torch

    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, text=True)
    t0 = time.time()
    while time.time() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    proc.terminate()
    lines = [ln.split(",") for ln in proc.communicate()[0].splitlines() if "," in ln][3:]
    mhz = sorted(float(a) for a, _ in lines)
    watts = sorted(float(b) for _, b in lines)
    return (mhz[len(mhz) // 2], watts[len(watts) // 2]) if lines else (None, None)


def word_err(got, want):
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def affine_err(a, b):
    """0 when two (..., 3, 8) point tensors hold the same points."""
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
    return limbs_to_words(torch.from_numpy(raw.astype(np.int64).reshape(*shape, 16))).to(device)


def fr_tape_cases(dev):
    """[(name, tape, inputs)]: the recorded SHPLONK (vanilla k=10) tape on
    the 16 fixtures' gathered inputs tiled to 1,024 and on its first lane;
    the GWC19 tape on the 16 `gwcsnark` fixtures' at 1,024; the IPA k = 11
    tape and the ick keccak tape (the evmsnark protocol with an instance
    committing key and its instance column queried, chip_smoke.py step 21)
    on random lazy words at 1,024 (numpy seed 19)."""
    import copy

    import torch
    from snark_verifier_tpu_torch.ec import py_ec
    from snark_verifier_tpu_torch.ff import FR
    from snark_verifier_tpu_torch.loader.base import TorchLoader
    from snark_verifier_tpu_torch.pcs.ipa import fixtures as ipa_fx
    from snark_verifier_tpu_torch.pcs.ipa import ipa_plan
    from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21, Gwc19
    from snark_verifier_tpu_torch.sdk import aggregation as agg
    from snark_verifier_tpu_torch.sdk.snark import Snark
    from snark_verifier_tpu_torch.transcript import PoseidonTranscript
    from snark_verifier_tpu_torch.verifier.plonk.plan import succinct_plan
    from snark_verifier_tpu_torch.verifier.plonk.protocol import Query

    fx = Path(__file__).resolve().parent / "benchmarks" / "fixtures" / "vanilla_k10"
    B = 1024
    cases = []
    for name, prefix, multiopen, scheme in (("shplonk", "snark", Bdfg21, "shplonk"),
                                           ("gwc19", "gwcsnark", Gwc19, "gwc")):
        base = [Snark.load(str(fx / f"{prefix}_{i:02d}.json")) for i in range(16)]
        snarks = [base[i % 16] for i in range(B)]
        plan = succinct_plan(base[0].protocol, multiopen, scheme, "poseidon")
        sc, pts = agg._stack_streams(snarks, dev)
        inst = agg._stack_instances(snarks, dev)
        reads = plan.read(inst, PoseidonTranscript(sc, pts, dev), TorchLoader(B, dev))
        ins = plan.gather(inst, reads, B).contiguous()
        cases.append((name, plan.tape, ins))
        if name == "shplonk":
            cases.append((name, plan.tape, ins[:, :1].contiguous()))
    proto = copy.deepcopy(Snark.load(str(fx / "evmsnark_00.json")).protocol)
    proto.instance_committing_key = {
        "bases": py_ec.rand_points(proto.num_instance[0], seed=23),
        "constant": py_ec.rand_points(1, seed=24)[0]}
    iq = Query(len(proto.preprocessed), 0)
    proto.evaluations.append(iq)
    proto.queries.append(iq)
    rng = np.random.default_rng(19)
    for name, tape in (("ipa_k11", ipa_plan("ipa", ipa_fx.ipa_keys()[0].svk, device=dev).tape),
                       ("ick_keccak", succinct_plan(proto, Bdfg21, "shplonk", "evm").tape)):
        cases.append((name, tape, rand_lazy_words(rng, (len(tape.inputs), B), FR.p, dev)))
    return cases


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="csrc/ of the other checkout")
    ap.add_argument("--log2n", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None, help="also write the rows to this file")
    ap.add_argument("--only", default=None,
                    help="comma-separated parts to run: g1_batch (svt_g1_add, "
                         "svt_g1_double and the probe's variants), fq_mul_chain (both routes), "
                         "add_chain, msm (the folds), "
                         "msm_loops (the point loops), loop_variants (msm_loops and the "
                         "probe's variants), poseidon_permute, field_inv, keccak_read, fr_powers, "
                         "points_to_fr, h_coeffs, to_affine, fr_tape (default all)")
    args = ap.parse_args()
    only = set(args.only.split(",")) if args.only else None

    def selected(part):
        return only is None or part in only
    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 2

    from snark_verifier_tpu_torch import _build
    from snark_verifier_tpu_torch.ec import from_affine_int, limbs_to_words, py_ec
    from snark_verifier_tpu_torch.ff import FQ, FR, FRW, digits4
    from snark_verifier_tpu_torch.hash import permute, permute_plain, poseidon
    from snark_verifier_tpu_torch.msm import cuda_ops, scalars_from_int
    from snark_verifier_tpu_torch.msm import pippenger as pip

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.time()
    variants_build = None
    loop_variants = only is not None and "loop_variants" in only
    if loop_variants:  # the point loops' other variants, this checkout's probe
        (_build.BUILD_DIR / "compare").mkdir(parents=True, exist_ok=True)
        variants_build = subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
             str(_build.BUILD_DIR / "compare" / "libpoint_loop_variants.so"),
             str(_build.SRC_DIR / "probe" / "point_loop_variants.cu")])
    g1_build = None
    if selected("g1_batch"):  # the batch kernels' other variants, this checkout's probe
        (_build.BUILD_DIR / "compare").mkdir(parents=True, exist_ok=True)
        g1_build = subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", str(_build.BUILD_DIR / "compare" / "libg1_batch_variants.so"),
             str(_build.SRC_DIR / "probe" / "g1_batch_variants.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    chain_build = None
    if selected("fq_mul_chain") or selected("add_chain"):  # the chain probe's other variants
        (_build.BUILD_DIR / "compare").mkdir(parents=True, exist_ok=True)
        chain_build = subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", str(_build.BUILD_DIR / "compare" / "libchain_variants.so"),
             str(_build.SRC_DIR / "probe" / "chain_variants.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    parent = build_parent(args.parent, _build.BUILD_DIR / "compare")
    other = None
    if selected("h_coeffs"):  # the other store route, this checkout's probe
        lib = _build.BUILD_DIR / "compare" / "libh_coeffs_vec.so"
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-O3", "-shared", "-Xcompiler",
                        "-fPIC", "-o", str(lib),
                        str(_build.SRC_DIR / "probe" / "ipa_h_coeffs_vec.cu")], check=True)
        other = ctypes.CDLL(str(lib)).svt_ipa_h_coeffs_vec
        other.argtypes, other.restype = [_P, _I, _P, _P, _P], ctypes.c_int
    _build.load_library()
    if variants_build is not None and variants_build.wait():
        raise RuntimeError("nvcc failed for csrc/probe/point_loop_variants.cu")
    variants, variants_log = {}, ""
    if g1_build is not None:
        variants_log = g1_build.communicate()[0]
        if g1_build.returncode:
            raise RuntimeError(f"nvcc failed for csrc/probe/g1_batch_variants.cu:\n{variants_log}")
        lib = ctypes.CDLL(str(_build.BUILD_DIR / "compare" / "libg1_batch_variants.so"))
        variants = {"g1_add": lib.svt_g1_add_variant, "g1_double": lib.svt_g1_double_variant}
        variants["g1_add"].argtypes = [_I, _I, _I, _P, _P, _P, _LL, _P]
        variants["g1_double"].argtypes = [_I, _I, _I, _P, _P, _LL, _P]
        for f in variants.values():
            f.restype = ctypes.c_int
    chain_lib, chain_log = None, ""
    if chain_build is not None:
        chain_log = chain_build.communicate()[0]
        if chain_build.returncode:
            raise RuntimeError(f"nvcc failed for csrc/probe/chain_variants.cu:\n{chain_log}")
        chain_lib = ctypes.CDLL(str(_build.BUILD_DIR / "compare" / "libchain_variants.so"))
        chain_lib.svt_g1_add_chain_variant.argtypes = [_I, _P, _P, _P, _LL, _I, _P]
        chain_lib.svt_fq_mul_chain_variant.argtypes = [_I, _P, _P, _P, _LL, _I, _I, _P]
        for f in (chain_lib.svt_g1_add_chain_variant, chain_lib.svt_fq_mul_chain_variant):
            f.restype = ctypes.c_int
    print(f"# card: {card}; builds {time.time() - t0:.1f}s", flush=True)
    rows = []

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def call(fn, *a):
        err = fn(*a, stream())
        if err:
            raise RuntimeError(f"launch refused: cudaError {err}")

    def compare(kind, run_parent, run_this, out_parent, err_fn, want, reps, timer=time_ms,
                **row):
        """One row: times in the order parent, this, this, parent, and each
        version's distance from the plain version's `want`."""
        ms = [timer(run_parent, reps), timer(run_this, reps), timer(run_this, reps),
              timer(run_parent, reps)]
        row.update(kind=kind, parent_ms=[ms[0], ms[3]], this_ms=[ms[1], ms[2]],
                   speedup=(ms[0] + ms[3]) / (ms[1] + ms[2]),
                   parent_err=err_fn(out_parent, want), this_err=err_fn(run_this(), want),
                   card=card)
        if "muls" in row:
            row.update(parent_g_muls_per_s=row["muls"] / max(ms[0], ms[3]) / 1e6,
                       this_g_muls_per_s=row["muls"] / max(ms[1], ms[2]) / 1e6)
        rows.append(row)
        print(json.dumps(row), flush=True)

    def ptxas_lines(log, fragment):
        """ptxas's registers, stack and spills of each kernel whose mangled
        name holds `fragment`, printed and returned {name: usage}."""
        lines, found = log.splitlines(), {}
        for i, line in enumerate(lines):
            if "entry function" in line and fragment in line:
                name = re.search(r"'(\S+)'", line).group(1)
                found[name] = " ".join(x.strip() for x in lines[i + 1:i + 4]
                                       if "Function" not in x)
                print(f"# ptxas {name}: {found[name]}", flush=True)
        return found

    def sass_counts(lib, fragment):
        """{kernel: ({opcode: count}, {class: count} of its loop)} from the
        SASS (cuobjdump) of each kernel in `lib` whose mangled name holds
        `fragment`; the loop is the span of its first backward branch, its
        classes FP64 (D*), ALU (IADD3, LOP3, SHF, ISETP, SEL, LEA) and IMAD
        (IMAD*); {} without cuobjdump."""
        tool = Path(_build._nvcc()).with_name("cuobjdump")
        if not tool.exists():
            return {}
        text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                              text=True).stdout
        funcs, cur = {}, None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = funcs.setdefault(m.group(1), []) if fragment in m.group(1) else None
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                         r"\s*([^;]*)", line)
            if cur is not None and m:
                cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
        out = {}
        for name, ins in funcs.items():
            ops, loop = {}, {}
            for _, op, _ in ins:
                ops[op] = ops.get(op, 0) + 1
            back = [(addr, int(t.group(1), 16)) for addr, op, rest in ins if op == "BRA"
                    for t in [re.search(r"0x([0-9a-f]+)", rest)] if t
                    and int(t.group(1), 16) < addr]
            if back:
                end, start = back[0]
                for addr, op, _ in ins:
                    if start <= addr <= end:
                        base = op.split(".")[0]
                        cls = ("FP64" if base.startswith("D") else "IMAD" if base == "IMAD"
                               else "ALU" if base in ("IADD3", "LOP3", "SHF", "ISETP", "SEL",
                                                      "LEA") else "other")
                        loop[cls] = loop.get(cls, 0) + 1
            out[name] = (ops, loop)
        return out

    if selected("fq_mul_chain"):
        # ------------------------------------------------------- multiply chain
        # Both routes of this checkout beside the parent's chain, the FP64
        # square in both forms (csrc/probe/chain_variants.cu), each held to
        # the plain version after canon (route 1 writes canonical words).
        from snark_verifier_tpu_torch.ec import words_to_limbs
        from snark_verifier_tpu_torch.ff import FQ_FIELD

        def canon_err(got, want):
            return word_err(FQ_FIELD.canon(words_to_limbs(got)),
                            FQ_FIELD.canon(words_to_limbs(want)))

        fold_src = (args.parent / "fold_kernels.cu").read_text()
        parent_route = "int route" in re.search(r"int svt_fq_mul_chain\((.*?)\)", fold_src,
                                                re.S).group(1)
        if parent_route:
            parent["svt_fq_mul_chain"].argtypes = [_P, _P, _P, _LL, _I, _I, _P]
        ptxas_lines(_build.build_log, "fq_mul_chain_kernel")
        ptxas_lines(chain_log, "fq_mul_chain")
        for name, (ops, loop) in sass_counts(_build.library_path(),
                                             "fq_mul_chain_kernel").items():
            print(f"# sass {name}: {json.dumps(dict(sorted(ops.items())))}; the chain loop's "
                  f"instructions by class {json.dumps(loop)}", flush=True)
        rng = np.random.default_rng(3)
        xs = rand_lazy_words(rng, (1 << 20,), FQ.p, dev)
        ys = rand_lazy_words(rng, (1 << 20,), FQ.p, dev)
        xo = torch.empty_like(xs)
        runs = {r: (lambda r=r: cuda_ops.fq_mul_chain(xs, ys, 256, route=r))
                for r in cuda_ops.FQ_CHAIN_ROUTES}
        if chain_lib is not None:  # route 2, the probe's: both routes side by side
            runs[2] = lambda: call(chain_lib.svt_fq_mul_chain_variant, 1, xs.data_ptr(),
                                   ys.data_ptr(), xo.data_ptr(), 1 << 20, 256, 2)
        for route, run in runs.items():  # the clocks a sustained chain runs at
            mhz, watts = sustained_clock(run)
            ms = kernel_ms(run, 5)
            row = dict(kind="fq_mul_chain_clock", B=1 << 20, ch=256, route=route, ms=ms,
                       sm_mhz_median=mhz, power_w_median=watts,
                       g_muls_per_s=(1 << 20) * 256 / ms / 1e6,
                       muls_per_sm_clock=(1 << 20) * 256 / (ms * 1e-3) / (
                           torch.cuda.get_device_properties(dev).multi_processor_count * mhz * 1e6)
                       if mhz else None,
                       card=card)
            print(json.dumps(row), flush=True)
            rows.append(dict(row, parent_err=0, this_err=0))
        del xs, ys, xo
        if chain_lib is not None:  # the card's own FP64 FMA rate (the probe's peak kernel)
            chain_lib.svt_f64_peak.argtypes = [_P, _LL, _I, _I, _P]
            chain_lib.svt_f64_peak.restype = ctypes.c_int
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            n_peak, iters = 1 << 20, 1024
            buf = torch.empty(n_peak, dtype=torch.float64, device=dev)
            for rz in (0, 1):
                run = lambda rz=rz: call(chain_lib.svt_f64_peak, buf.data_ptr(), n_peak, iters,
                                         rz)
                mhz, watts = sustained_clock(run)
                ms = kernel_ms(run, 5)
                fmas = n_peak * iters * 8
                row = dict(kind="f64_peak", n=n_peak, iters=iters, rz=rz, ms=ms, sm_mhz_median=mhz,
                           power_w_median=watts, fma_per_s=fmas / (ms * 1e-3),
                           fma_per_sm_clock=fmas / (ms * 1e-3) / (sms * mhz * 1e6) if mhz
                           else None, card=card)
                print(json.dumps(row), flush=True)
                rows.append(dict(row, parent_err=0, this_err=0))
            del buf
        for B in (1 << 17, 1 << 20):
            a = rand_lazy_words(rng, (B,), FQ.p, dev)
            b = rand_lazy_words(rng, (B,), FQ.p, dev)
            for ch in ((16, 0, 256) if B == 1 << 17 else (16,)):
                for square in (False, True):
                    out = torch.empty_like(a)
                    bp = None if square else b.data_ptr()
                    want = (cuda_ops.fq_sqr_chain_plain(a, ch) if square
                            else cuda_ops.fq_mul_chain_plain(a, b, ch))
                    muls = B * ch
                    int_floor = muls * (108 if square else 136) / (64 * 132 * 1.98e9) * 1e3
                    f64_floor = muls * (120 if square else 150) / (64 * 132 * 1.98e9) * 1e3

                    def run_parent(bp=bp, out=out, ch=ch):
                        call(parent["svt_fq_mul_chain"], a.data_ptr(), bp, out.data_ptr(), B, ch,
                             *((0,) if parent_route else ()))

                    run_parent()
                    for route in cuda_ops.FQ_CHAIN_ROUTES:
                        def run_this(route=route, square=square, ch=ch):
                            return (cuda_ops.fq_sqr_chain(a, ch, route=route) if square
                                    else cuda_ops.fq_mul_chain(a, b, ch, route=route))

                        compare("fq_sqr_chain" if square else "fq_mul_chain", run_parent,
                                run_this, out, canon_err, want, 10, timer=kernel_ms, B=B, ch=ch,
                                route=route, muls=muls, int_floor_ms=int_floor,
                                fp64_floor_ms=f64_floor, bound_ms=min(int_floor, f64_floor))
                        r = rows[-1]
                        if ch:
                            r.update(this_int_floor_share=int_floor / max(r["this_ms"]),
                                     this_fp64_floor_share=f64_floor / max(r["this_ms"]),
                                     parent_int_floor_share=int_floor / max(r["parent_ms"]))
                    # the probe's variants (route, dedicated square) beside route 1
                    for route, dedicated in ((1, 0), (2, 1)):
                        if not square and dedicated == 0:
                            continue
                        vout = torch.empty_like(a)

                        def run_v(vout=vout, bp=bp, ch=ch, dedicated=dedicated, route=route):
                            call(chain_lib.svt_fq_mul_chain_variant, dedicated, a.data_ptr(), bp,
                                 vout.data_ptr(), B, ch, route)

                        run_v()
                        compare(("fq_sqr" if square else "fq_mul") + "_chain_variant", run_v,
                                lambda ch=ch, square=square: (
                                    cuda_ops.fq_sqr_chain(a, ch, route=1) if square
                                    else cuda_ops.fq_mul_chain(a, b, ch, route=1)),
                                vout, canon_err, want, 10, timer=kernel_ms, B=B, ch=ch,
                                route=route, dedicated=dedicated, muls=muls,
                                parent="csrc/probe/chain_variants.cu (route={}, dedicated={}); "
                                       "this: route 1".format(route, dedicated))
            del a, b

    if selected("add_chain"):
        # ----------------------------------------------------------- add chain
        # This checkout's chain (g1_add_sum, canonical words, persistent
        # blocks) beside the parent's, and each blocks-an-SM variant of
        # csrc/probe/chain_variants.cu beside the library's, held to the
        # plain version after canon.
        from snark_verifier_tpu_torch.ec import words_to_limbs
        from snark_verifier_tpu_torch.ff import FQ_FIELD

        def canon_err(got, want):
            return word_err(FQ_FIELD.canon(words_to_limbs(got)),
                            FQ_FIELD.canon(words_to_limbs(want)))

        ptxas_lines(_build.build_log, "g1_add_chain_kernel")
        ptxas_lines(chain_log, "g1_add_chain_kernel")
        rng = np.random.default_rng(3)
        ch = 16
        for B in (256, 1 << 17):
            a = rand_lazy_words(rng, (B, 3), FQ.p, dev)
            b = rand_lazy_words(rng, (B, 3), FQ.p, dev)
            want = cuda_ops.g1_add_chain_plain(a, b, ch)
            out = torch.empty_like(a)
            bound = max(B * ch * 1416 / (64 * 132 * 1.98e9), 3 * 96 * B / 3.35e12) * 1e3

            def run_parent(out=out, a=a, b=b, B=B):
                call(parent["svt_g1_add_chain"], a.data_ptr(), b.data_ptr(), out.data_ptr(), B,
                     ch)

            run_parent()
            compare("g1_add_chain", run_parent, lambda a=a, b=b: cuda_ops.g1_add_chain(a, b, ch),
                    out, canon_err, want, 10, timer=kernel_ms, B=B, ch=ch, bound_ms=bound)
            r = rows[-1]
            r.update(parent_bound_share=bound / max(r["parent_ms"]),
                     this_bound_share=bound / max(r["this_ms"]))
            for blocks in (3, 4, 5, 6):
                vout = torch.empty_like(a)

                def run_v(vout=vout, a=a, b=b, B=B, blocks=blocks):
                    call(chain_lib.svt_g1_add_chain_variant, blocks, a.data_ptr(), b.data_ptr(),
                         vout.data_ptr(), B, ch)

                run_v()
                compare("g1_add_chain_variant", run_v,
                        lambda a=a, b=b: cuda_ops.g1_add_chain(a, b, ch), vout, canon_err, want,
                        10, timer=kernel_ms, B=B, ch=ch, blocks=blocks, bound_ms=bound,
                        parent=f"csrc/probe/chain_variants.cu (blocks={blocks})")
                r = rows[-1]
                r.update(variant_bound_share=bound / max(r["parent_ms"]))
            del a, b, want

    def ladder_points():
        """The 2^log2n MSM's points [1..n]·G, (n, 3, 8) words."""
        pts = limbs_to_words(from_affine_int([py_ec.G1_GEN], device=dev))
        pt = py_ec.G1_GEN
        for _ in range(args.log2n):  # pts[i] = (i+1)·G by a doubling ladder
            step = limbs_to_words(from_affine_int([pt], device=dev)).expand_as(pts).contiguous()
            pts = torch.cat([pts, cuda_ops.add(pts, step)], 0)
            pt = py_ec.double(pt)
        return pts

    def msm_slots():
        """The 2^log2n MSM's points [1..n]·G (and the identity after them),
        numpy-seeded scalars, and its slot indices: every main window's and
        the top window's."""
        n = 1 << args.log2n
        pts = ladder_points()
        points_ext = torch.cat([pts, pip._identity(1, dev)], 0)
        rng_k = np.random.default_rng(42)
        ks = [int.from_bytes(rng_k.bytes(32), "little") % FR.p for _ in range(n)]
        digits = pip.extract_digits(scalars_from_int(ks).to(dev), 8)
        cap = pip.default_capacity(n, 256)
        tcap = max(cap, pip.top_capacity(n, 8))
        idx_all, _ = pip._slot_indices(digits[:-1], 256, cap)
        idx_top, _ = pip._slot_indices(digits[-1:], pip.top_range(8), tcap)
        return n, points_ext, idx_all, idx_top

    if selected("g1_batch"):
        # ------------------------------------------ the batch add and double
        from snark_verifier_tpu_torch.ec import words_to_limbs
        from snark_verifier_tpu_torch.ff import FQ_FIELD

        lines = (_build.build_log + variants_log).splitlines()
        for i, line in enumerate(lines):  # each variant's registers, stack and spills
            if "entry function" in line and "g1_batch_kernel" in line:
                name = re.search(r"'(\S+)'", line).group(1)
                usage = " ".join(x.strip() for x in lines[i + 1:i + 4] if "Function" not in x)
                print(f"# ptxas {name}: {usage}", flush=True)

        def canon_err(got, want):
            """Words apart after canon: the parent's kernels write lazy
            words, this checkout's canonical ones."""
            return word_err(FQ_FIELD.canon(words_to_limbs(got)),
                            FQ_FIELD.canon(words_to_limbs(want)))

        pts = ladder_points()
        half = pts.shape[0] // 2
        for n in (half, 1000, 2):
            a, b = pts[:n].contiguous(), pts[half:half + n].contiguous()
            reps = 50 if n > 1000 else 40
            for op, fn, plain, ins, muladds, n_bytes in (
                    ("g1_add", cuda_ops.add, cuda_ops.add_plain, (a, b), 1416, 288),
                    ("g1_double", cuda_ops.double, cuda_ops.double_plain, (a,), 960, 192)):
                want = plain(*ins)
                ptrs = [x.data_ptr() for x in ins]
                bound = max(n * n_bytes / 3.35e12, n * muladds / (64 * 132 * 1.98e9)) * 1e3
                out = torch.empty_like(a)

                def run_parent(op=op, ptrs=ptrs, out=out, n=n):
                    call(parent["svt_" + op], *ptrs, out.data_ptr(), n)

                run_parent()
                compare(op, run_parent, lambda: fn(*ins), out, canon_err, want, reps,
                        timer=kernel_ms, n=n, bound_ms=bound)
                r = rows[-1]
                r.update(parent_bound_share=bound / max(r["parent_ms"]),
                         this_bound_share=bound / max(r["this_ms"]))
                for sum_, bulk, blocks in G1_VARIANTS[op]:
                    vout = torch.empty_like(a)

                    def run_v(op=op, ptrs=ptrs, vout=vout, n=n, v=(sum_, bulk, blocks)):
                        call(variants[op], *v, *ptrs, vout.data_ptr(), n)

                    run_v()
                    compare(op + "_variant", run_v, lambda: fn(*ins), vout, canon_err, want,
                            reps, timer=kernel_ms, n=n, bound_ms=bound, sum=sum_, bulk=bulk,
                            blocks=blocks, parent="csrc/probe/g1_batch_variants.cu "
                                                  f"(sum={sum_}, bulk={bulk}, blocks={blocks})")
        del pts

    if selected("msm"):
        # ----------------------------------------------------------- bucket fold
        n, points_ext, idx_all, idx_top = msm_slots()
        idx_main = idx_all[:1]
        for label, ix in (("one main window", idx_main[0].contiguous()),
                          ("top window, whole", idx_top[0].contiguous())):
            out = torch.empty((ix.shape[0], 3, 8), dtype=torch.int32, device=dev)
            compare("fold_buckets",
                    lambda: call(parent["svt_fold_buckets"], points_ext.data_ptr(), ix.data_ptr(),
                                 ix.shape[0], ix.shape[1], n, out.data_ptr(),
                                 cuda_ops._fold_team(ix.shape[0], dev)),
                    lambda: cuda_ops.fold_buckets(points_ext, ix), out, affine_err,
                    cuda_ops.fold_buckets_plain(points_ext, ix), 5, shape=label,
                    rows=ix.shape[0], cap=ix.shape[1])
        # ------------------------------------------------------------ dense folds
        fold_src = (args.parent / "fold_kernels.cu").read_text()
        parent_teams = "int team" in re.search(r"int svt_fold_segments\((.*?)\)", fold_src,
                                               re.S).group(1)
        if parent_teams:
            parent["svt_fold_segments"].argtypes = [_P, _LL, _LL, _LL, _LL, _LL, _LL, _I, _I,
                                                    _P, _P]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count

        def p_fold(mat, grp):
            """The parent's kernel on one level of grouping `grp`."""
            G, CW, S, count, width = grp
            nb, w = mat.shape[:2]
            team = ()
            if parent_teams:
                team = (cuda_ops.grouping_team(nb, w, grp, sms),)
            elif width > w:
                mat = torch.cat([mat, cuda_ops.identity((nb, width - w), dev)], 1)
                w = width
            out = torch.empty((nb, width // count, 3, 8), dtype=torch.int32, device=dev)
            call(parent["svt_fold_segments"], mat.data_ptr(), nb, w, width // count, G, CW, S,
                 count, *team, out.data_ptr())
            return out

        def p_walk(mat, levels):
            for grp in levels:
                mat = p_fold(mat, grp)
            return mat[:, 0]

        def p_split(ix, split_rows=384):
            """The parent's fold_buckets_split: its fold over the rows cut into
            segments, then its fold_segments over each row's partial sums."""
            nb, cap_x = ix.shape
            segs = max(1, min(split_rows // nb, cap_x))
            seg_len = -(-cap_x // segs)
            ix = torch.cat([ix, ix.new_full((nb, segs * seg_len - cap_x), n)], 1)
            ix = ix.view(nb * segs, seg_len)
            parts = torch.empty((nb * segs, 3, 8), dtype=torch.int32, device=dev)
            call(parent["svt_fold_buckets"], points_ext.data_ptr(), ix.data_ptr(), nb * segs,
                 seg_len, n, parts.data_ptr(), cuda_ops._fold_team(nb * segs, dev))
            return p_fold(parts.view(nb, segs, 3, 8), cuda_ops.level_grouping(segs, segs))[:, 0]

        top = idx_top[0].contiguous()
        compare("fold_buckets_split", lambda: p_split(top),
                lambda: cuda_ops.fold_buckets_split(points_ext, top), p_split(top), affine_err,
                cuda_ops.fold_buckets_plain(points_ext, top), 10, shape=list(top.shape),
                parent_split_rows=384, this_split_rows=cuda_ops.SPLIT_ROWS)
        NB, wd = 256, 4624
        fill = np.random.default_rng(1).integers(0, 2, size=(NB, wd)).astype(bool)
        g = limbs_to_words(from_affine_int([py_ec.G1_GEN], device=dev))[0]
        mat = torch.where(torch.from_numpy(fill).to(dev)[..., None, None], g,
                          cuda_ops.identity((), dev)).contiguous()
        sums = limbs_to_words(from_affine_int(
            [py_ec.scalar_mul(py_ec.G1_GEN, int(c)) for c in fill.sum(1)], device=dev))
        for name, drive, levels in (
                ("fold_buckets_chunked", lambda m: cuda_ops.fold_buckets_chunked(m, K=8),
                 cuda_ops.chunked_levels(wd, 8)),
                ("fold_buckets_halving", lambda m: cuda_ops.fold_buckets_halving(m, 4),
                 cuda_ops.halving_levels(wd, 4)),
                ("fold_buckets_grid_dense", lambda m: cuda_ops.fold_buckets_grid_dense(m, 512, 4),
                 cuda_ops.grid_levels(wd, 512, 4))):
            compare(name, lambda: p_walk(mat, levels), lambda: drive(mat), p_walk(mat, levels),
                    affine_err, sums, 5, shape=[NB, wd], levels=len(levels))
            prev = mat
            for i, grp in enumerate(levels):
                compare("fold_segments", lambda: p_fold(prev, grp),
                        lambda: cuda_ops.fold_segments(prev, *grp), p_fold(prev, grp), affine_err,
                        cuda_ops.fold_segments_plain(prev, *grp), 10, timer=kernel_ms, walk=name,
                        level=i, shape=list(prev.shape[:2]), grouping=list(grp),
                        this_team=cuda_ops.grouping_team(NB, prev.shape[1], grp, sms))
                prev = cuda_ops.fold_segments(prev, *grp)
        del mat, points_ext, idx_all, idx_top
        torch.cuda.empty_cache()

    if selected("msm_loops") or loop_variants:
        # ------------------------ the point loops: the parent's kernels beside
        loops_src = (args.parent / "msm_loops.cu").read_text()
        parent_layout = "int team" in re.search(r"int svt_msm_windowed\((.*?)\)", loops_src,
                                                re.S).group(1)
        if parent_layout:
            parent["svt_msm_windowed"].argtypes = [_P, _P, _LL, _I, _I, _I, _P, _P]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count

        def p_msm_windowed(bases, scalars, out):
            B, nb = bases.shape[:2]
            layout = cuda_ops.msm_windowed_layout(B, nb, sms) if parent_layout else ()
            call(parent["svt_msm_windowed"], bases.data_ptr(), scalars.data_ptr(), B, nb,
                 *layout, out.data_ptr())

        if loop_variants:
            variants = ctypes.CDLL(str(_build.BUILD_DIR / "compare" /
                                       "libpoint_loop_variants.so"))
            msm_shuffle = variants.svt_msm_windowed_shuffle
            msm_shuffle.argtypes = [_P, _P, _LL, _I, _I, _I, _P, _P]
            reduce_variant = variants.svt_bucket_reduce_variant
            reduce_variant.argtypes = [_P, _P, _P, _I, _I, _P]
        rng = np.random.default_rng(6)
        for B, nb in ((1024, 26), (1024, 34), (1024, 4), (1024, 17), (64, 32), (2, 32),
                      (1, 26)):
            bases = limbs_to_words(from_affine_int(py_ec.rand_points(nb, seed=6), device=dev))
            bases = bases.expand(B, nb, 3, 8).contiguous()
            ks = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(B * nb)]
            raw = np.frombuffer(b"".join(k.to_bytes(32, "little") for k in ks), dtype="<i4")
            scs = torch.from_numpy(raw.reshape(B, nb, 8).copy()).to(dev)
            want = cuda_ops.msm_windowed_plain(bases, digits4(scs))
            out = torch.empty((B, 3, 8), dtype=torch.int32, device=dev)
            p_msm_windowed(bases, scs, out)
            layout = cuda_ops.msm_windowed_layout(B, nb, sms)
            compare("msm_windowed", lambda: p_msm_windowed(bases, scs, out),
                    lambda: cuda_ops.msm_windowed(bases, scs), out, affine_err, want, 10,
                    timer=kernel_ms, shape=[B, nb], layout=list(layout))
            for team in cuda_ops.MSMW_TEAMS:  # every team size, beside the parent
                lay = (team, cuda_ops.msm_windowed_per_block(B, nb, team, sms))
                compare("msm_windowed_team", lambda: p_msm_windowed(bases, scs, out),
                        lambda: cuda_ops._msm_windowed_at(bases, scs, *lay), out, affine_err,
                        want, 10, timer=kernel_ms, shape=[B, nb], layout=list(lay),
                        chosen=lay == layout)
                if loop_variants and team > 1:  # the products exchanged by shuffles
                    out_s = torch.empty_like(out)
                    compare("msm_windowed_shuffle", lambda: p_msm_windowed(bases, scs, out),
                            lambda: call(msm_shuffle, bases.data_ptr(), scs.data_ptr(), B, nb,
                                         *lay, out_s.data_ptr()) or out_s,
                            out, affine_err, want, 10, timer=kernel_ms, shape=[B, nb],
                            layout=list(lay))
            del bases, scs, want

        n, points_ext, idx_all, idx_top = msm_slots()
        buckets = pip.bucket_sums(points_ext, idx_all, idx_top[0])  # the MSM's (32, 256)
        del points_ext, idx_all, idx_top
        want = pip.bucket_reduce_plain(buckets, 8)
        part = torch.empty(32 * 24 + 1, dtype=torch.int32, device=dev)
        out = torch.empty((1, 3, 8), dtype=torch.int32, device=dev)

        def p_bucket_reduce():
            call(parent["svt_bucket_reduce"], buckets.data_ptr(), part.data_ptr(),
                 out.data_ptr())

        p_bucket_reduce()
        compare("bucket_reduce", p_bucket_reduce, lambda: pip.bucket_reduce(buckets, 8), out,
                affine_err, want, 20, timer=kernel_ms, shape=list(buckets.shape[:2]))
        for team in (1, 2, 4, 6) if loop_variants else ():
            for shuffle in (0, 1) if team > 1 else (0,):
                out_t = torch.empty((1, 3, 8), dtype=torch.int32, device=dev)
                compare("bucket_reduce_team", p_bucket_reduce,
                        lambda: call(reduce_variant, buckets.data_ptr(), part.data_ptr(),
                                     out_t.data_ptr(), team, shuffle) or out_t,
                        out, affine_err, want, 20, timer=kernel_ms,
                        shape=list(buckets.shape[:2]), team=team, shuffle=bool(shuffle))
        del buckets

    if selected("poseidon_permute"):
        # --------------------------------------------------------------- Poseidon
        rc, md = poseidon._host_constants()
        err = parent["svt_poseidon_load_constants"](rc.ctypes.data, md.ctypes.data)
        if err:
            raise RuntimeError(f"the parent's constants did not load: cudaError {err}")
        rng = np.random.default_rng(5)
        for B in (1024, 1 << 16):
            st = rand_lazy_words(rng, (B, 3), FRW.spec.p, dev)
            out = torch.empty_like(st)
            compare("poseidon_permute",
                    lambda: call(parent["svt_poseidon_permute"], st.data_ptr(), out.data_ptr(), B),
                    lambda: permute(st), out, word_err, permute_plain(st), 10, B=B)

    # ---------------------------------------------------- the field inverse
    from snark_verifier_tpu_torch.ff import FQW

    if "svt_field_inv" in parent and selected("field_inv"):
        rng = np.random.default_rng(23)
        for tag, F in ((0, FQW), (1, FRW)):
            for n in (2048, 64, 4, 1024):
                x = rand_lazy_words(rng, (n,), F.spec.p, dev)
                out = torch.empty_like(x)
                compare("field_inv",
                        lambda: call(parent["svt_field_inv"], tag, x.data_ptr(), out.data_ptr(), n),
                        lambda: F.inv(x), out, lambda got, want: word_err(F.canon(got), want),
                        F.plain("canon", F.plain("inv", x)), 20, timer=kernel_ms,
                        field=F.spec.name, n=n)

    # ------------------------------------------------------------ keccak read
    if "svt_keccak_squeeze" in parent and selected("keccak_read"):
        from snark_verifier_tpu_torch.hash import keccak_device as kd
        from snark_verifier_tpu_torch.pcs.kzg.multiopen import Bdfg21
        from snark_verifier_tpu_torch.sdk import aggregation as agg
        from snark_verifier_tpu_torch.sdk.snark import Snark
        from snark_verifier_tpu_torch.verifier.plonk.plan import succinct_plan

        fx = Path(__file__).resolve().parent / "benchmarks" / "fixtures" / "vanilla_k10"
        base = [Snark.load(str(fx / f"evmsnark_{i:02d}.json")) for i in range(16)]
        snarks = [base[i % 16] for i in range(1024)]
        sched = succinct_plan(base[0].protocol, Bdfg21, "shplonk", "evm").keccak
        inst = agg._instance_block(snarks, dev)
        sc, pts = agg._stack_streams(snarks, dev)
        hp, cp = kd.read_plain(sched, inst, sc, pts)
        bufs = []
        for q in range(len(sched.squeezes)):
            words, tags = kd.squeeze_words(sched, q, inst, sc, pts, hp)
            pad = torch.from_numpy(kd.pad_lanes(len(tags))[0].copy()).to(dev)
            bufs.append((words.contiguous(), torch.tensor(tags, dtype=torch.int32, device=dev),
                         len(tags), pad,
                         torch.empty((4 * len(tags), 1024), dtype=torch.int64, device=dev)))
        hash_p = torch.empty_like(hp)
        chal_p = torch.empty_like(cp)

        def p_read():
            for q, (words, tags, W, pad, scratch) in enumerate(bufs):
                call(parent["svt_keccak_squeeze"], words.data_ptr(), tags.data_ptr(), W,
                     pad.data_ptr(), pad.shape[0], scratch.data_ptr(), hash_p[q].data_ptr(),
                     chal_p[q].data_ptr(), 1024)
            return chal_p

        compare("keccak_read", p_read, lambda: kd.read(sched, inst, sc, pts)[1], p_read(),
                word_err, cp, 20, timer=kernel_ms, B=1024, widths=sched.widths,
                parent_launches=len(bufs), this_launches=1)

    # ------------------------------------------------------------ fold powers
    if "svt_fr_powers" in parent and selected("fr_powers"):
        from snark_verifier_tpu_torch.pcs.kzg.accumulation import powers, powers_plain

        rng = np.random.default_rng(11)
        for B, n in ((32, 32), (1, 32), (1, 1), (1024, 33)):
            r = rand_lazy_words(rng, (B,), FR.p, dev)
            out = torch.empty((B, n, 8), dtype=torch.int32, device=dev)
            compare("fr_powers",
                    lambda: call(parent["svt_fr_powers"], r.data_ptr(), n, out.data_ptr(), B),
                    lambda: powers(r, n), out, word_err, powers_plain(r, n), 50,
                    timer=kernel_ms, B=B, n=n)

    # ----------------------------------------------- the Fq -> Fr map, fused
    if {"svt_field_mul", "svt_field_canon", "svt_field_inv"} <= set(parent) and \
            selected("points_to_fr"):
        from snark_verifier_tpu_torch.ff import points_to_fr, points_to_fr_plain

        one_plain, r2 = FQW.const("ONE_PLAIN", dev), FRW.const("R2", dev)

        def parent_map(x, proj, bufs):
            """The other checkout's launches: (inv, mul,) mul, canon, mul."""
            zinv, zrep, xy, t, c, out = bufs
            if proj:
                n = x.shape[0]
                call(parent["svt_field_inv"], 0, x[:, 2].contiguous().data_ptr(),
                     zinv.data_ptr(), n)
                zrep.copy_(zinv[:, None].expand(n, 2, 8))  # its wrapper's broadcast copy
                call(parent["svt_field_mul"], 0, x[:, :2].contiguous().data_ptr(), 8,
                     zrep.data_ptr(), 8, xy.data_ptr(), 2 * n)
                x = xy
            m = x.numel() // 8
            call(parent["svt_field_mul"], 0, x.data_ptr(), 8, one_plain.data_ptr(), 0,
                 t.data_ptr(), m)
            call(parent["svt_field_canon"], 0, t.data_ptr(), c.data_ptr(), m)
            call(parent["svt_field_mul"], 1, c.data_ptr(), 8, r2.data_ptr(), 0, out.data_ptr(), m)
            return out

        rng = np.random.default_rng(29)
        cases = []
        for n in (2048, 64, 4):
            pts = rand_lazy_words(rng, (n, 3), FQ.p, dev)  # random X, Y, Z: Z = 0, p, 2p first
            pts[:, 2] = rand_lazy_words(rng, (n,), FQ.p, dev)
            cases.append((pts, True))
        cases.append((rand_lazy_words(rng, (1024, 16, 2), FQ.p, dev), False))
        for x, proj in cases:
            n = x.shape[0]
            m = 2 * n if proj else x.numel() // 8
            bufs = (torch.empty((n, 8), dtype=torch.int32, device=dev),
                    torch.empty((n, 2, 8), dtype=torch.int32, device=dev),
                    torch.empty((n, 2, 8), dtype=torch.int32, device=dev),
                    *(torch.empty(((n, 2, 8) if proj else x.shape), dtype=torch.int32,
                                  device=dev) for _ in range(3)))
            want = points_to_fr_plain(x, proj)
            for timer, label in ((kernel_ms, "kernel"), (time_ms, "as called")):
                # 10 calls: kernel_ms's ~2 ms spin outlasts the host's calls
                compare("points_to_fr", lambda: parent_map(x, proj, bufs),
                        lambda: points_to_fr(x, proj), parent_map(x, proj, bufs), word_err,
                        want, 10, timer=timer, mode="projective" if proj else "affine",
                        shape=list(x.shape), timed=label, parent_launches=5 if proj else 3,
                        this_launches=1, elements=m)

    # ------------------------------------------------- the IPA decider's h(X)
    if "svt_ipa_h_coeffs" in parent and selected("h_coeffs"):
        rng = np.random.default_rng(24)
        xi_all = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(20)]
        s_rand = FRW.from_int(int.from_bytes(rng.bytes(32), "little") % FR.p, dev)
        for k in (5, 11, 20):
            xi = FRW.from_int(xi_all[:k], dev)
            for label, sw in (("s = 1", FRW.const("ONE", dev)), ("random s", s_rand)):
                out = torch.empty((1 << k, 16), dtype=torch.int64, device=dev)

                def p_h(xi=xi, sw=sw, out=out, k=k):
                    call(parent["svt_ipa_h_coeffs"], xi.data_ptr(), k, sw.data_ptr(),
                         out.data_ptr())
                    return out

                this = cuda_ops.h_coeffs(xi, sw)
                p_h()
                torch.cuda.synchronize()
                n_bytes = (1 << k) * 128
                bound = n_bytes / 3.35e12 * 1e3
                compare("ipa_h_coeffs", p_h, lambda: cuda_ops.h_coeffs(xi, sw), out, word_err,
                        cuda_ops.h_coeffs_plain(xi, sw), 20, timer=kernel_ms, k=k, scalar=label,
                        equal_to_each_other=bool(torch.equal(this, out)), bytes=n_bytes,
                        bound_ms=bound)
                r = rows[-1]
                if not r["equal_to_each_other"]:
                    r["this_err"] = max(r["this_err"], 1)
                r.update(parent_gb_per_s=n_bytes / max(r["parent_ms"]) / 1e6,
                         this_gb_per_s=n_bytes / max(r["this_ms"]) / 1e6,
                         parent_bound_share=bound / max(r["parent_ms"]),
                         this_bound_share=bound / max(r["this_ms"]))
                print(json.dumps({k2: r[k2] for k2 in ("k", "scalar", "parent_gb_per_s",
                                                       "this_gb_per_s", "parent_bound_share",
                                                       "this_bound_share")}), flush=True)
                out_v = torch.empty_like(out)

                def v_h(xi=xi, sw=sw, out_v=out_v, k=k):
                    call(other, xi.data_ptr(), k, sw.data_ptr(), out_v.data_ptr())
                    return out_v

                compare("ipa_h_coeffs_vec", v_h, lambda: cuda_ops.h_coeffs(xi, sw), v_h(),
                        word_err, cuda_ops.h_coeffs_plain(xi, sw), 20, timer=kernel_ms, k=k,
                        scalar=label,
                        parent="csrc/probe/ipa_h_coeffs_vec.cu (16-byte stores a thread)",
                        bytes=n_bytes, bound_ms=bound)
                r = rows[-1]
                r.update(parent_gb_per_s=n_bytes / max(r["parent_ms"]) / 1e6,
                         this_gb_per_s=n_bytes / max(r["this_ms"]) / 1e6)

    # ---------------------------------------------- the recorded Fr programs
    if "svt_fr_tape" in parent and selected("fr_tape"):
        from snark_verifier_tpu_torch.ff import fr_tape

        sig = re.search(r"int svt_fr_tape\((.*?)\)", (args.parent / "fr_tape.cu").read_text(),
                        re.S).group(1)
        parent_teams = "int team" in sig
        if parent_teams:
            parent["svt_fr_tape"].argtypes = [_P, _I, _I, _P, _I, _P, _I, _P, _LL, _I, _P]

        def p_tape(tape, ins, out):
            """The parent's kernel: the tape's rows in order, or (a parent
            that takes a team) this checkout's schedule at the wrapper's team."""
            B = ins.shape[1]
            consts = tape.device_arrays(dev)[1]
            if parent_teams:
                sched = tape.schedule(fr_tape.TEAM)
                call(parent["svt_fr_tape"], sched.device_steps(dev).data_ptr(), sched.n_steps,
                     sched.team, consts.data_ptr(), consts.shape[0], ins.data_ptr(),
                     ins.shape[0], out.data_ptr(), B, sched.n_slots)
            else:
                call(parent["svt_fr_tape"], tape.device_arrays(dev)[0].data_ptr(),
                     len(tape.rows), consts.data_ptr(), ins.data_ptr(), out.data_ptr(), B,
                     tape.n_slots)
            return out

        for name, tape, ins in fr_tape_cases(dev):
            B = ins.shape[1]
            out = torch.empty((len(tape.outputs), B, 8), dtype=torch.int32, device=dev)
            want = fr_tape.run_plain(tape, ins)
            p_tape(tape, ins, out)
            chosen = fr_tape.TEAM
            for team in fr_tape.TEAMS:
                compare("fr_tape_team", lambda: p_tape(tape, ins, out),
                        lambda: fr_tape.run(tape, ins, team=team), out, word_err, want, 20,
                        timer=kernel_ms, tape=name, shape=list(ins.shape), rows=len(tape.rows),
                        team=team, chosen=team == chosen,
                        **{k: v for k, v in tape.schedule(team).counts().items()},
                        slots=tape.schedule(team).n_slots)

    # -------------------------- the keccak read's normalisation, one launch
    if selected("to_affine"):
        from snark_verifier_tpu_torch.ff import points_to_fr, points_to_fr_plain

        rng = np.random.default_rng(31)
        for shape in ((1024, 1), (1024, 4)):
            x = rand_lazy_words(rng, (*shape, 3), FQ.p, dev)  # Z = 0, p, 2p first
            want = points_to_fr_plain(x, projective=True, map_fr=False)
            for timer, label in ((kernel_ms, "kernel"), (time_ms, "as called")):
                compare("to_affine", lambda: cuda_ops.affine_xy(x),
                        lambda: points_to_fr(x, projective=True, map_fr=False),
                        FQW.canon(cuda_ops.affine_xy(x)), word_err, want, 10, timer=timer,
                        shape=list(x.shape), timed=label,
                        parent="cuda_ops.affine_xy (svt_field_inv, svt_field_mul)",
                        parent_launches=2, this_launches=1)

    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    bad = [r for r in rows if r["parent_err"] or r["this_err"]]
    if bad:
        print(f"kernel_compare: {len(bad)} rows disagree with the plain version", file=sys.stderr)
        return 1
    print(f"# kernel_compare: {len(rows)} rows, every output equals its plain version; "
          f"{time.time() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
