"""Read the program's own spans and counters in one cell, on the card: the
cell's set-up and warm-up as a run of the benchmark makes them, then a
host slice like the traced run's slice B (`harness.program_spans`), and
optionally the cost of a span with no profiler running.

    python3 perfbench/tools/trace_spans.py --workload <cell> --seed <n> \
        [--seconds 1.0] [--span-cost]

Prints one JSON line: the card, the slice's calls and calls a second
under the profiler, every reading of `READINGS` (the same in every cell:
None where the cell's program opens none of the spans a reading needs),
the program spans and host waits a call, the idle seconds by span (top
12) and the harness's `idle_by_host` labels beside them; with
`--span-cost`, the ns of a span and of a bare call on this host.  A
program without the spans reads None where a reading needs them.  It
needs the card, as a run does."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


VERIFY_PREP = ("svt::verify.plan", "svt::verify.stack")
VERIFY_PHASES = ("svt::verify.read", "svt::verify.gather", "svt::verify.fr_tape",
                 "svt::verify.msm", "svt::verify.decide")
FOLD_LEVELS = ("svt::fold.groups", "svt::fold.top", "svt::fold.root")
MSM_PREP = ("svt::msm.points", "svt::msm.digits")


def readings(sl):
    """Every reading of a slice, by name: the nine metrics that a change to
    the benchmark would add (PERF.md §7), where `idle_unattributed_pct`
    stands for `verify.` and `tree.idle_unattributed_pct`, `launches` for
    `verify.launches` and `host_waits` for `msm.host_waits`.  The idle
    readings include the spans under the ones named."""
    from harness import program_spans as ps

    return {"verify.prep_idle_ms": ps.idle_ms(sl, VERIFY_PREP),
            "verify.phase_idle_ms": ps.idle_ms(sl, VERIFY_PHASES),
            "tree.fold_idle_ms": ps.idle_ms(sl, FOLD_LEVELS),
            "idle_unattributed_pct": ps.unattributed_pct(sl),
            "launches": ps.per_call(sl, sl.launches),
            "msm.prep_ms": ps.device_ms(sl, MSM_PREP),
            "msm.attempts": ps.per_call(sl, sl.counters, "msm_attempts"),
            "host_waits": ps.per_call(sl, sl.counters, "host_waits")}


def span_cost_ns(n: int = 1_000_000):
    """(ns a `_step` span, ns a bare call) with no profiler running; None
    where the program has no `_step`."""
    from snark_verifier_tpu_torch.utils import timing

    step = getattr(timing, "_step", None)
    if step is None:
        return None, None
    fn = int
    t = time.perf_counter()
    for _ in range(n):
        step("verify.plan", fn)
    spanned = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(n):
        fn()
    bare = time.perf_counter() - t
    return 1e9 * spanned / n, 1e9 * bare / n


def main(argv):
    for p in (BENCH, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(BENCH, "_cache", "torch_extensions"))
    from harness import cli, program_spans
    from harness.catalog import Catalog

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--span-cost", action="store_true")
    args = ap.parse_args(argv)

    cat = Catalog()
    cell = cat.cell(args.workload)
    cli.check_device(cell["chips"])
    run = cli.Run(args.workload, cat.config(cell["config"]), cat.traffic(cell["traffic"]),
                  args.seed, args.seconds, True)
    entry = cat.entry(cell["entry"])(run, None)
    entry.sync()
    entry.setup()
    for k in range(entry.n_inputs):
        entry.call(k)
    entry.sync()

    sl = program_spans.span_slice(entry, args.seconds)
    idle = sl.idle
    by_name = {}
    for s, v in idle.items():
        key = "(none)" if s is None else s.name
        by_name[key] = by_name.get(key, 0.0) + v
    out = {
        "cell": args.workload,
        "device": entry.device_info()["kind"],
        "calls": sl.calls,
        "calls_per_s": sl.calls / sl.window_s,
        "readings": readings(sl),
        "spans_per_call": len(sl.spans) / sl.calls,
        "idle_s": sum(idle.values()),
        "window_s": sl.window_s,
        "idle_by_span": sorted(by_name.items(), key=lambda kv: -kv[1])[:12],
        "idle_by_host": sorted(sl.idle_by_host.items(), key=lambda kv: -kv[1])[:12],
    }
    if args.span_cost:
        out["span_ns"], out["bare_call_ns"] = span_cost_ns()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
