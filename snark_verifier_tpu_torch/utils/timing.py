"""Timers, the device profile and the cost meter: the port's copy of the JAX
package's `utils/timing.py` (the reference SDK's `display`-feature ark-std
timers, snark-verifier-sdk src/lib.rs:3-4, halo2.rs:111-122, and the
loader's cost-metering hooks, snark-verifier src/loader.rs:255-259).

Wall-clock spans print to stderr with SNARK_TPU_TIMERS=1 (the JAX package's
variable); `with profile_trace(out_dir): ...` writes a Chrome trace of the
region (torch.profiler, the CPU and, where there is a card, CUDA
activities).  `METER` counts the verifier's group operations per span, the
analogue of the EvmLoader's gas deltas (loader/evm/loader.rs:424-441): the
fold (`pcs/kzg/accumulation.py`) counts 2 MSMs and 2·N terms a call, the
decide (`pcs/kzg/decider.py`) 2 pairings a call.  The JAX package counts
once per trace under `jax.jit`; the port counts once per call.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List


def _enabled() -> bool:
    return os.environ.get("SNARK_TPU_TIMERS", "") not in ("", "0")


@contextlib.contextmanager
def timer(label: str):
    """start_timer!/end_timer!: prints the span's seconds to stderr when
    SNARK_TPU_TIMERS is set."""
    if not _enabled():
        yield
        return
    t0 = time.perf_counter()
    yield
    print(f"[timer] {label}: {time.perf_counter() - t0:.3f}s", file=sys.stderr)


@contextlib.contextmanager
def profile_trace(out_dir: str):
    """Profile a region with torch.profiler (CPU activity, and CUDA where a
    card is present) and export its Chrome trace (Perfetto,
    chrome://tracing) to `out_dir`/trace.json."""
    import torch
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
