"""Spans, the device profile and the cost meter: the port's counterpart of
the JAX package's `utils/timing.py` (the reference SDK's `display`-feature
ark-std timers, snark-verifier-sdk src/lib.rs:3-4, halo2.rs:111-122, and
the loader's cost-metering hooks, snark-verifier src/loader.rs:255-259).

`_step(name, fn)` is the port's one span primitive: every step of the
batch verify, the tree, the folds and the MSM runs through it as the span
"svt::<name>".  With no profiler running it costs one test; under
torch.profiler it is a span of torch's C++ record function
(`_RecordFunctionFast`), on the profile's clock beside the kernels it
launches, nested under the call's outer span (`svt::verify`, `svt::tree`,
`svt::msm`), and it waits for nothing.  A profiler of the device alone
runs no host callbacks, so there the span records nothing and costs a
guard.  A caller's `timings` dict gets the host seconds of the steps
that name a key, each between two synchronizes.  `_wait` marks a place
where the program blocks the host on the device (counted in
`_launch.COUNTERS`).

`with profile_trace(out_dir): ...` writes a Chrome trace of the region
(torch.profiler, the CPU and, where there is a card, CUDA activities): the
`svt::` spans beside the kernels.  `METER` counts the verifier's group
operations per span, the analogue of the EvmLoader's gas deltas
(loader/evm/loader.rs:424-441): the fold (`pcs/kzg/accumulation.py`)
counts 2 MSMs and 2·N terms a call, the decide (`pcs/kzg/decider.py`) 2
pairings a call.  The JAX package counts once per trace under `jax.jit`;
the port counts once per call.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch._C._profiler import _RecordFunctionFast as _record
from torch.autograd import _profiler_enabled

from .._launch import COUNTERS


def _synchronize(where):
    """Wait for `where`: a device, or a mesh (`parallel.mesh.Mesh`, each of
    its cards)."""
    if not isinstance(where, torch.device):
        where.synchronize()
    elif where.type == "cuda":
        torch.cuda.synchronize(where)


def _step(name: str, fn, timings: dict = None, key: str = None, where=None):
    """fn() as the span "svt::<name>".  With `timings` and `key`, fn runs
    between two synchronizes of `where` (a device or a mesh) and its host
    seconds are added under `key` (a sharded path sums its shards)."""
    if timings is not None and key is not None:
        _synchronize(where)
        t = time.perf_counter()
        r = _step(name, fn)
        _synchronize(where)
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t
        return r
    if not _profiler_enabled():
        return fn()
    with _record("svt::" + name):
        return fn()


def _wait(site: str, fn):
    """fn(), a place where the program blocks the host on the device: a
    read of a device value, or an upload from pageable host memory (which
    waits for the stream's queued work).  The span "svt::wait.<site>", one
    count of `COUNTERS["host_waits"]`."""
    COUNTERS["host_waits"] += 1
    return _step("wait." + site, fn)


@contextlib.contextmanager
def profile_trace(out_dir: str):
    """Profile a region with torch.profiler (CPU activity, and CUDA where a
    card is present) and export its Chrome trace (Perfetto,
    chrome://tracing) to `out_dir`/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


@dataclass
class CostMeter:
    """Counts symbolic verifier work per span (the loader's cost-metering
    hooks): a count lands in every span open at the time."""

    spans: Dict[str, Dict[str, int]] = field(default_factory=dict)
    _stack: List[str] = field(default_factory=list)

    def start(self, identifier: str):
        self.spans.setdefault(identifier, {})
        self._stack.append(identifier)

    def end(self, identifier: str):
        if not self._stack or self._stack[-1] != identifier:
            raise ValueError(f"CostMeter.end({identifier!r}): the open span is "
                             f"{self._stack[-1] if self._stack else None!r}")
        self._stack.pop()

    def count(self, kind: str, n: int = 1):
        for ident in self._stack:
            span = self.spans[ident]
            span[kind] = span.get(kind, 0) + n

    def report(self) -> str:
        lines = []
        for ident, span in self.spans.items():
            ops = ", ".join(f"{k}={v}" for k, v in sorted(span.items()))
            lines.append(f"{ident}: {ops}")
        return "\n".join(lines)


METER = CostMeter()
