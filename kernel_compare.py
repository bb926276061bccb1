#!/usr/bin/env python3
"""Time this checkout's kernels beside another checkout's, in one process on
one card: the only fair comparison of two versions of a kernel.

    python3 kernel_compare.py --parent DIR [--log2n 20] [--out FILE]

`DIR` is the csrc/ directory of the other checkout (for example one unpacked
with `git archive <commit> snark_verifier_tpu_torch/csrc`).  Its
`fold_kernels.cu`, `msm_kernels.cu` and `poseidon_kernels.cu` are built side
by side with nvcc, each against the headers beside it, and its entry points
are called as the port has declared them since the fold took a team size
(the other checkout must be one whose `svt_fold_buckets` takes it):

* `svt_fq_mul_chain(a, b, out, n, ch, stream)`: chains of dependent Fq
  multiplies at B = 2^17, CH = 16 and 256;
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
* `svt_g1_add(a, b, out, n, stream)` and `svt_g1_double(a, out, n, stream)`
  driven by the loops that launched them one group operation at a time
  before `svt_msm_windowed` and `svt_bucket_reduce` replaced them: the verify
  MSM at (1,024, 26) (26 bases tiled, numpy-seeded scalars; `digits4` and a
  table of 14 add launches, then per window 4 double launches, a gather, a
  tree of add launches and one more add), and the weighted bucket sums plus
  Horner over the MSM's own (32, 256) bucket sums (a suffix scan and a tree
  of add launches, then 8 double launches and one add launch per window).

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
                     "svt_fold_segments": [_P, _LL, _LL, _LL, _LL, _LL, _LL, _I, _P, _P]},
    "msm_kernels": {"svt_fold_buckets": [_P, _P, _LL, _LL, _I, _P, _I, _P],
                    "svt_g1_add": [_P, _P, _P, _LL, _P],
                    "svt_g1_double": [_P, _P, _LL, _P]},
    "poseidon_kernels": {"svt_poseidon_load_constants": [_P, _P],
                         "svt_poseidon_permute": [_P, _P, _LL, _P]},
}


def build_parent(csrc: Path, out_dir: Path):
    """{entry point: ctypes function} of the parent's three units, one nvcc
    process each, all started together."""
    from snark_verifier_tpu_torch import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    flags = _build.ARCH_FLAGS + ["-O3", "-shared", "-Xcompiler", "-fPIC"]
    procs = {}
    for unit in PARENT_UNITS:
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
    vals[:3] = [0, p, 2 * p]
    raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), dtype="<u2")
    return limbs_to_words(torch.from_numpy(raw.astype(np.int64).reshape(*shape, 16))).to(device)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="csrc/ of the other checkout")
    ap.add_argument("--log2n", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None, help="also write the rows to this file")
    args = ap.parse_args()
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
    parent = build_parent(args.parent, _build.BUILD_DIR / "compare")
    _build.load_library()
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

    # ------------------------------------------------------- multiply chain
    rng = np.random.default_rng(3)
    B = 1 << 17
    a = rand_lazy_words(rng, (B,), FQ.p, dev)
    b = rand_lazy_words(rng, (B,), FQ.p, dev)
    for ch in (16, 256):
        out = torch.empty_like(a)
        compare("fq_mul_chain",
                lambda: call(parent["svt_fq_mul_chain"], a.data_ptr(), b.data_ptr(),
                             out.data_ptr(), B, ch),
                lambda: cuda_ops.fq_mul_chain(a, b, ch), out, word_err,
                cuda_ops.fq_mul_chain_plain(a, b, ch), 10, B=B, ch=ch,
                muls=B * ch)

    # ----------------------------------------------------------- bucket fold
    n = 1 << args.log2n
    pts = limbs_to_words(from_affine_int([py_ec.G1_GEN], device=dev))
    pt = py_ec.G1_GEN
    for _ in range(args.log2n):  # pts[i] = (i+1)·G by a doubling ladder
        step = limbs_to_words(from_affine_int([pt], device=dev)).expand_as(pts).contiguous()
        pts = torch.cat([pts, cuda_ops.add(pts, step)], 0)
        pt = py_ec.double(pt)
    points_ext = torch.cat([pts, pip._identity(1, dev)], 0)
    rng_k = np.random.default_rng(42)
    ks = [int.from_bytes(rng_k.bytes(32), "little") % FR.p for _ in range(n)]
    digits = pip.extract_digits(scalars_from_int(ks).to(dev), 8)
    cap = pip.default_capacity(n, 256)
    tcap = max(cap, pip.top_capacity(n, 8))
    idx_all, _ = pip._slot_indices(digits[:-1], 256, cap)
    idx_top, _ = pip._slot_indices(digits[-1:], pip.top_range(8), tcap)
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
        parent["svt_fold_segments"].argtypes = [_P, _LL, _LL, _LL, _LL, _LL, _LL, _I, _I, _P, _P]
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
    del mat

    buckets = pip.bucket_sums(points_ext, idx_all, idx_top[0])  # the MSM's (32, 256)
    del points_ext, pts, digits, idx_all
    torch.cuda.empty_cache()

    # ------------------------------- the point loops against their kernels
    def p_add(x, y):
        shape = x.shape
        x, y = x.reshape(-1, 3, 8).contiguous(), y.reshape(-1, 3, 8).contiguous()
        out = torch.empty_like(x)
        call(parent["svt_g1_add"], x.data_ptr(), y.data_ptr(), out.data_ptr(), x.shape[0])
        return out.view(shape)

    def p_double(x):
        shape = x.shape
        x = x.reshape(-1, 3, 8).contiguous()
        out = torch.empty_like(x)
        call(parent["svt_g1_double"], x.data_ptr(), out.data_ptr(), x.shape[0])
        return out.view(shape)

    def p_tree_sum(x):  # along axis 1
        x = x.movedim(1, 0)
        while x.shape[0] > 1:
            half = x.shape[0] // 2
            x = torch.cat([p_add(x[:half], x[half : 2 * half]), x[2 * half :]], 0)
        return x[0]

    def p_msm_windowed(bases, scalars):
        """The parent's verify MSM: its loop over its add/double kernels."""
        digs = digits4(scalars)
        tab, acc = [cuda_ops.identity(bases.shape[:2], dev), bases], bases
        for _ in range(14):
            acc = p_add(acc, bases)
            tab.append(acc)
        tab = torch.stack(tab, dim=2)
        acc = cuda_ops.identity(bases.shape[:1], dev)
        for w in range(digs.shape[-1] - 1, -1, -1):
            for _ in range(4):
                acc = p_double(acc)
            idx = digs[..., w][..., None, None, None]
            sel = torch.take_along_dim(tab, idx, dim=2).squeeze(2)
            acc = p_add(acc, p_tree_sum(sel))
        return acc

    def p_bucket_reduce(b):
        """The parent's weighted bucket sums and Horner loop."""
        s = b[:, 1:].flip(1)
        width, d = s.shape[1], 1
        while d < width:
            s = torch.cat([s[:, :d], p_add(s[:, d:], s[:, : width - d])], dim=1)
            d *= 2
        while s.shape[1] > 1:
            half = s.shape[1] // 2
            s = torch.cat([p_add(s[:, :half], s[:, half : 2 * half]), s[:, 2 * half :]], dim=1)
        acc = cuda_ops.identity((1,), dev)
        for w in range(s.shape[0] - 1, -1, -1):
            for _ in range(8):
                acc = p_double(acc)
            acc = p_add(acc, s[w : w + 1, 0])
        return acc

    rng = np.random.default_rng(6)
    B, nb = 1024, 26
    bases = limbs_to_words(from_affine_int(py_ec.rand_points(nb, seed=6), device=dev))
    bases = bases.expand(B, nb, 3, 8).contiguous()
    ks = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(B * nb)]
    raw = np.frombuffer(b"".join(k.to_bytes(32, "little") for k in ks), dtype="<i4")
    scs = torch.from_numpy(raw.reshape(B, nb, 8).copy()).to(dev)
    compare("msm_windowed", lambda: p_msm_windowed(bases, scs),
            lambda: cuda_ops.msm_windowed(bases, scs), p_msm_windowed(bases, scs), affine_err,
            cuda_ops.msm_windowed_plain(bases, digits4(scs)), 5, shape=[B, nb])
    compare("bucket_reduce", lambda: p_bucket_reduce(buckets),
            lambda: pip.bucket_reduce(buckets, 8), p_bucket_reduce(buckets), affine_err,
            pip.bucket_reduce_plain(buckets, 8), 5, shape=list(buckets.shape[:2]))
    del buckets, bases, scs

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
