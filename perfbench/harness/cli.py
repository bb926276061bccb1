"""One run of one cell: set-up, the measured window, the check of every
answer against the plain reference, and the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result's JSON object; the numbers
compared, each beside its limit, are the last lines of standard error and
the result's last key ("checks").  A run that finds no card, fewer cards
than the cell asks for, or a module of JAX or of the JAX package loaded
once the window has closed, exits non-zero and prints no result."""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import RunError, trace
from .catalog import Catalog
from .window import Record, run_calls, window_seconds

FORBIDDEN = ("jax", "jaxlib", "flax", "snark_verifier_tpu")


@dataclass
class Run:
    """What a metric reader sees of a run."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    setup_s: float = 0.0
    records: List[Record] = field(default_factory=list)
    window_s: float = 0.0
    work: List[float] = field(default_factory=list)  # each record's work
    spans: Dict[str, float] = field(default_factory=dict)  # set-up spans, seconds
    slice_a: Optional[trace.Slice] = None
    slice_b: Optional[trace.Slice] = None
    timings: List[dict] = field(default_factory=list)
    counts: Dict[str, float] = field(default_factory=dict)  # work counts from the entry


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def check_device(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark measures the card and never the CPU")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards; {torch.cuda.device_count()} present")


def _profiled(entry, run: Run, i: int, seconds: float, tag: str, host: bool):
    """Calls under the profiler for `seconds` (at least 2) -> (its slice,
    the next input index); with `host`, the host activity and the entry's
    spans too."""
    import torch

    n0 = len(run.records)
    with trace.spans_around(entry.spans if host else ()) as names, trace.profile(host) as prof:
        i = run_calls(entry.call, entry.n_inputs, i, time.perf_counter() + seconds, run.records,
                      min_calls=2, tag=tag)
        torch.cuda.synchronize()
    recs = run.records[n0:]
    s = trace.Slice(calls=len(recs), window_s=window_seconds(recs), ks=[r.k for r in recs],
                    kernels=trace.device_kernels(prof))
    if host:
        s.span_device_s = trace.span_device_seconds(prof, set(names))
        s.idle_by_host = trace.idle_by_host(prof, s.kernels)
    return s, i


def _traced_window(entry, run: Run, t_end: float):
    """Slice A (the device alone, a quarter of the window, at most 4 s),
    slice B (host and spans, a quarter of that, at most 1 s), then the rest
    of the window with the program's `timings` where the entry has them."""
    a_len = min(4.0, 0.25 * (t_end - time.perf_counter()))
    run.slice_a, i = _profiled(entry, run, 0, a_len, "A", host=False)
    run.slice_b, i = _profiled(entry, run, i, min(1.0, a_len / 4), "B", host=True)
    timings = run.timings if entry.has_timings else None
    run_calls(entry.call, entry.n_inputs, i, t_end, run.records, tag="C", timings=timings)


def measure(entry, run: Run, max_calls=None):
    """The window: `run.seconds` of calls (at most `max_calls`); with
    tracing, the traced slices."""
    t_end = time.perf_counter() + run.seconds
    if run.trace:
        _traced_window(entry, run, t_end)
    else:
        run_calls(entry.call, entry.n_inputs, 0, t_end, run.records, max_calls=max_calls)
    run.window_s = window_seconds(run.records)
    run.work = [entry.work(r.k) for r in run.records]


def run_cell(name: str, seed: int, seconds: float, traced: bool, t_start: float,
             catalog: Optional[Catalog] = None, device=None, traffic: Optional[dict] = None,
             config: Optional[dict] = None, check_card: bool = True, control: bool = False,
             max_calls: Optional[int] = None):
    """-> (result dict, checks [(name, value, limit)]).  `device`,
    `traffic` and `config` replace the cell's for a dry run on the CPU
    (tests only: a run on the CPU is no measurement).  `control` puts the
    control in the program's place after set-up: the reference with one
    guarantee broken (`Entry.control_answers`), which the check has to
    fail."""
    catalog = catalog or Catalog()
    cell = catalog.cell(name)
    if check_card:
        check_device(cell["chips"])
    run = Run(name, config or catalog.config(cell["config"]),
              traffic or catalog.traffic(cell["traffic"]), int(seed), float(seconds), traced)
    entry = catalog.entry(cell["entry"])(run, device)
    entry.sync()  # the device's context up before the inputs' span
    t = time.perf_counter()
    entry.setup()
    entry.sync()
    run.spans["setup.inputs_s"] = time.perf_counter() - t - run.spans.get("setup.srs_load_s", 0)
    entry.reset_peak()  # the program's peak from here: not the inputs' temporaries
    t = time.perf_counter()
    for k in range(entry.n_inputs):  # every shape the window uses
        entry.call(k)
    entry.sync()
    run.spans["setup.warmup_s"] = time.perf_counter() - t
    run.setup_s = time.perf_counter() - t_start
    if control:
        answers = entry.control_answers()
        entry.call = lambda k, timings=None: answers[k]

    measure(entry, run, max_calls)
    device_info = entry.device_info()
    if traced:
        device_info["busy_s"] = run.slice_a.busy_s
        device_info["window_s"] = run.slice_a.window_s
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package are loaded: {found}")

    entry.free()
    checks = entry.check(run)
    correct = all(value <= limit for _, value, limit in checks)
    metrics = {}
    for mname, unit, reader in catalog.metrics(name, traced):
        value = reader.read(run)
        if value is not None:
            metrics[mname] = {"value": value, "unit": unit}
    result = {
        "correct": correct,
        "attempted": len(run.records),
        "failed": int(entry.failed_calls),
        "metrics": metrics,
        "device": device_info,
    }
    if traced:
        result["breakdown"] = {
            "device_ops": run.slice_a.top_ops(10),
            "idle_gaps": sorted(([k[:120], v] for k, v in run.slice_b.idle_by_host.items()),
                                key=lambda x: -x[1])[:10],
        }
    result["checks"] = {c: {"value": v, "limit": lim} for c, v, lim in checks}
    return result, checks


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  t_start)
    except RunError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    for c, v, lim in checks:
        print(f"check {c}: {v} (limit {lim})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
