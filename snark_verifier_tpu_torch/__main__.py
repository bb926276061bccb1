"""The port's command-line interface: the counterpart of the JAX package's
`__main__.py`, with its commands, arguments and defaults.

    python -m snark_verifier_tpu_torch verify           [--scheme shplonk|gwc] [--k 3]
    python -m snark_verifier_tpu_torch aggregate        [--n 4]
    python -m snark_verifier_tpu_torch aggregate-mixed
    python -m snark_verifier_tpu_torch tree             [--n 16] [--fanout 4]
    python -m snark_verifier_tpu_torch bench-msm        [--log2n 16]
    python -m snark_verifier_tpu_torch gen-evm-verifier [--scheme shplonk|gwc] [--k 3]
                                                        [--out verifier.yul] [--no-check]

Every command runs on the CUDA card unless given --cpu, and raises where
there is no card; gen-evm-verifier is host code (the JAX package pins it to
its CPU) and touches no card either way.  verify, aggregate and
aggregate-mixed run the port's examples (`snark_verifier_tpu_torch.examples`)
with argument lists.  bench-msm times the port's `msm` (which stands for the
JAX package's `msm_rns`, so there is no --backend) on bench.py's inputs.
On exit the command's cost-meter span (`utils.timing.METER`) goes to
stderr.
"""

from __future__ import annotations

import argparse
import sys
import time


def _cpu(args):
    return ["--cpu"] if args.cpu else []


def cmd_verify(args):
    from .examples import verify_standard_plonk

    verify_standard_plonk.main(["--scheme", args.scheme, "--k", str(args.k)] + _cpu(args))


def cmd_aggregate(args):
    from .examples import aggregate_proofs

    aggregate_proofs.main(["--n", str(args.n)] + _cpu(args))


def cmd_aggregate_mixed(args):
    from .examples import aggregate_mixed

    aggregate_mixed.main(_cpu(args))


def cmd_tree(args):
    """Two-layer recursive aggregation of n copies of one StandardPlonk proof
    (`sdk.tree_aggregation.tree_aggregate`), then the root's one pairing;
    a tree with leaf 0's public input moved must reject."""
    from .device import resolve_device
    from .ff.spec import FR
    from .pcs.kzg.decider import decide
    from .sdk.snark import Snark
    from .sdk.srs import toy_srs
    from .sdk.tree_aggregation import tree_aggregate
    from .system.standard_plonk import StandardPlonk, build_protocol, gen_snark

    dev = resolve_device("cpu" if args.cpu else None)
    srs = toy_srs(32)
    circuit = StandardPlonk.rand(k=3, seed=7)
    protocol = build_protocol(circuit, srs, device=dev)
    snark = gen_snark(circuit, protocol, srs, scheme="shplonk", device=dev)
    snarks = [snark] * args.n
    t0 = time.time()
    lhs, rhs = tree_aggregate(snarks, srs, "shplonk", fanout=args.fanout, device=dev)
    ok = bool(decide(srs, lhs, rhs))
    print(f"tree-aggregated {args.n} leaves (fanout {args.fanout}) on {dev} in "
          f"{time.time() - t0:.1f}s -> accepted={ok}")
    bad = Snark(protocol, [[(snark.instances[0][0] + 1) % FR.p]], snark.scalars, snark.points)
    lhs2, rhs2 = tree_aggregate([bad] + snarks[1:], srs, "shplonk", fanout=args.fanout,
                                device=dev)
    ok2 = bool(decide(srs, lhs2, rhs2))
    print(f"tampered leaf 0 -> accepted={ok2}")
    if not ok or ok2:
        raise SystemExit("FAIL")
    print("PASS")


def cmd_gen_evm_verifier(args):
    """Emit a standalone Yul verifier contract for a protocol and (unless
    --no-check) prove and execute it in the in-process interpreter (the
    reference's gen_evm_verifier_* + evm_verify, evm.rs:122-192)."""
    from .examples import gen_evm_verifier

    gen_evm_verifier.run(args.scheme, args.k, seed=11, out=args.out, check=not args.no_check)
    if not args.no_check:
        print("PASS")


def cmd_bench_msm(args):
    """bench.py's MSM benchmark on the port: [1..n]·G (a doubling ladder of
    `add` launches on the device) and numpy seed 42's scalars, c = 8; the
    first call, then the best of 3 (host clock around synchronized calls);
    the result held to k_total·G."""
    import numpy as np
    import torch

    from .device import resolve_device
    from .ec import from_affine_int, limbs_to_words, py_ec, to_affine_int, words_to_limbs
    from .ff.spec import FR
    from .msm import cuda_ops, msm, scalars_from_int

    dev = resolve_device("cpu" if args.cpu else None)
    n, c = 1 << args.log2n, 8

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.time()
    offs, pt = [], py_ec.G1_GEN
    for _ in range(args.log2n):
        offs.append(pt)
        pt = py_ec.double(pt)
    offs_w = limbs_to_words(from_affine_int(offs, device=dev))
    pts_w = limbs_to_words(from_affine_int([py_ec.G1_GEN], device=dev))
    for k in range(args.log2n):  # bench.py's doubling ladder: arr[i] = (i+1)·G
        step = cuda_ops.add(pts_w, offs_w[k : k + 1].expand_as(pts_w).contiguous())
        pts_w = torch.cat([pts_w, step], 0)
    points = words_to_limbs(pts_w)
    sync()
    print(f"point gen [1..2^{args.log2n}]·G on {dev}: {time.time() - t0:.1f}s")

    rng = np.random.default_rng(42)  # bench.py's scalars
    ks = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)]
    scalars = scalars_from_int(ks).to(dev)

    t0 = time.time()
    out, ovf = msm(points, scalars, c=c, device=dev)
    sync()
    print(f"msm first call: {time.time() - t0:.3f}s")
    times = []
    for _ in range(3):
        t0 = time.time()
        out, ovf = msm(points, scalars, c=c, device=dev)
        sync()
        times.append(time.time() - t0)
    dt = min(times)
    k_total = sum(s * (i + 1) for i, s in enumerate(ks)) % FR.p
    ok = to_affine_int(out) == py_ec.scalar_mul(py_ec.G1_GEN, k_total) and not bool(ovf)
    print(f"msm 2^{args.log2n} c={c} on {dev}: best of 3 {dt * 1e3:.2f} ms = "
          f"{n / dt:.1f} points/s (runs {[round(t * 1e3, 2) for t in times]} ms); "
          f"correct={ok} overflow={bool(ovf)}")
    if not ok:
        raise SystemExit("FAIL")
    print("PASS")


COMMANDS = {
    "verify": cmd_verify,
    "aggregate": cmd_aggregate,
    "aggregate-mixed": cmd_aggregate_mixed,
    "tree": cmd_tree,
    "bench-msm": cmd_bench_msm,
    "gen-evm-verifier": cmd_gen_evm_verifier,
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="snark_verifier_tpu_torch")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions), not the CUDA card")
    sub = ap.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("verify", parents=[common],
                       help="prove + verify one StandardPlonk proof")
    v.add_argument("--scheme", default="shplonk", choices=["shplonk", "gwc"])
    v.add_argument("--k", type=int, default=3)

    a = sub.add_parser("aggregate", parents=[common], help="batch verify + fold N proofs")
    a.add_argument("--n", type=int, default=4)

    sub.add_parser("aggregate-mixed", parents=[common],
                   help="fold snarks of two different protocols into one "
                        "pairing (zkevm+state shape)")

    t = sub.add_parser("tree", parents=[common], help="two-layer recursive aggregation")
    t.add_argument("--n", type=int, default=16)
    t.add_argument("--fanout", type=int, default=4)

    b = sub.add_parser("bench-msm", parents=[common], help="Pippenger MSM benchmark")
    b.add_argument("--log2n", type=int, default=16)

    g = sub.add_parser("gen-evm-verifier", parents=[common],
                       help="emit + execute a Yul verifier contract (host code)")
    g.add_argument("--scheme", default="shplonk", choices=["shplonk", "gwc"])
    g.add_argument("--k", type=int, default=3)
    g.add_argument("--out", default="verifier.yul")
    g.add_argument("--no-check", action="store_true")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    from .utils.timing import METER

    METER.start(args.cmd)
    try:
        COMMANDS[args.cmd](args)
    finally:
        METER.end(args.cmd)
        rep = METER.report()
        if rep:
            # per-span symbolic work counts, the gas-log analogue
            # (reference loader/evm/loader.rs:424-441)
            print(f"# cost-meter\n# {rep}", file=sys.stderr)


if __name__ == "__main__":
    main()
