"""The program's own spans and counters over a host slice like the traced
run's slice B, and the device's idle time given to the spans.

The port opens every step as a span of torch's record function named
"svt::<layer>.<step>" (`snark_verifier_tpu_torch.utils.timing._step`),
nested under the call's outer span (`svt::verify`, `svt::tree`,
`svt::msm`), on the profile's clock beside the kernels.  `program_spans`
reads them from a profile: name, start, end, the enclosing program spans,
and the device seconds of the kernels launched under each.
`attribute_idle` gives each idle gap between kernels whole to the
innermost program span open at the gap's middle (the rule of
`trace.idle_by_host`), a gap with none open to None.  Both the rule and
the readers below are pure functions over plain records; each reader
takes the spans it reads as an argument and knows nothing of cells.

A program without these spans (the parent of the change that added them)
gives no span, and every reading that needs one is None."""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import stats, trace
from .window import Record, run_calls, window_seconds

PREFIX = "svt::"

@dataclass(frozen=True)
class Span:
    name: str
    start: float  # s, the profile's clock
    end: float
    ancestors: Tuple[str, ...] = ()  # the enclosing program spans, innermost first
    device_s: float = 0.0  # the kernels launched under the span and its children

    def under(self, names: Iterable[str]) -> bool:
        """The span is one of `names` or lies inside one."""
        names = set(names)
        return self.name in names or any(a in names for a in self.ancestors)


def program_spans(prof) -> List[Span]:
    """Every program span of a host profile, in the profile's order."""
    out = []
    for ev in prof.events():
        if trace._is_device(ev) or not ev.name.startswith(PREFIX):
            continue
        ancestors, p = [], ev.cpu_parent
        while p is not None:
            if p.name.startswith(PREFIX):
                ancestors.append(p.name)
            p = p.cpu_parent
        device_s = sum(k.duration for d in [ev, *trace._descendants(ev)] for k in d.kernels)
        out.append(Span(ev.name, ev.time_range.start * 1e-6, ev.time_range.end * 1e-6,
                        tuple(ancestors), device_s * 1e-6))
    return out


def attribute_idle(kernels: Iterable[Tuple[float, float]],
                   spans: Sequence[Span]) -> Dict[Optional[Span], float]:
    """The device's idle gaps between the (start, end) kernel intervals,
    each given whole to the innermost span open at its middle (the latest
    start; of two that start together, the shorter), None where no span
    is open -> seconds a span."""
    out: Dict[Optional[Span], float] = {}
    for g0, g1 in stats.gaps(kernels):
        mid = 0.5 * (g0 + g1)
        live = [s for s in spans if s.start <= mid < s.end]
        owner = max(live, key=lambda s: (s.start, -s.end)) if live else None
        out[owner] = out.get(owner, 0.0) + (g1 - g0)
    return out


@dataclass
class SpanSlice:
    """Calls under the profiler, host and device, read for the program."""

    calls: int = 0
    window_s: float = 0.0
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: List[Span] = field(default_factory=list)
    launches: Dict[str, int] = field(default_factory=dict)  # the change over the slice
    counters: Dict[str, int] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)  # `trace.idle_by_host`'s labels

    @functools.cached_property
    def idle(self) -> Dict[Optional[Span], float]:
        return attribute_idle(((s, e) for _, s, e in self.kernels), self.spans)


def _counts():
    """(LAUNCHES, COUNTERS) of the port as they stand; {} for what it lacks."""
    from snark_verifier_tpu_torch import _launch

    return dict(_launch.LAUNCHES), dict(getattr(_launch, "COUNTERS", {}))


def span_slice(entry, seconds: float, min_calls: int = 2) -> SpanSlice:
    """The entry's calls for `seconds` (at least `min_calls`) under the
    profiler with the host activity and the entry's harness spans, as the
    traced run's slice B; the program's spans and the change in its
    counters over the calls."""
    import torch

    recs: List[Record] = []
    launches0, counters0 = _counts()
    with trace.spans_around(entry.spans), trace.profile(True) as prof:
        run_calls(entry.call, entry.n_inputs, 0, time.perf_counter() + seconds, recs,
                  min_calls=min_calls, tag="B")
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    launches1, counters1 = _counts()
    kernels = trace.device_kernels(prof)
    return SpanSlice(calls=len(recs), window_s=window_seconds(recs), kernels=kernels,
                     spans=program_spans(prof),
                     launches={k: v - launches0.get(k, 0) for k, v in launches1.items()},
                     counters={k: v - counters0.get(k, 0) for k, v in counters1.items()},
                     idle_by_host=trace.idle_by_host(prof, kernels))


# ------------------------------------------------------------------ readings


def idle_ms(sl: SpanSlice, roots: Sequence[str]) -> Optional[float]:
    """Idle ms a call given to the spans `roots` and every span under them;
    None where the slice holds none of them."""
    if not sl.calls or not any(s.under(roots) for s in sl.spans):
        return None
    return 1e3 * sum(v for s, v in sl.idle.items() if s is not None and s.under(roots)) / sl.calls


def unattributed_pct(sl: SpanSlice) -> Optional[float]:
    """100 × the idle seconds given to no program span / all idle seconds;
    None without program spans or idle time."""
    idle = sl.idle
    total = sum(idle.values())
    if not sl.spans or total <= 0:
        return None
    return 100.0 * idle.get(None, 0.0) / total


def device_ms(sl: SpanSlice, names: Sequence[str]) -> Optional[float]:
    """Device ms a call of the kernels launched under the spans `names`
    (none of them inside another); None where the slice holds none."""
    mine = [s for s in sl.spans if s.name in names]
    if not sl.calls or not mine:
        return None
    return 1e3 * sum(s.device_s for s in mine) / sl.calls


def per_call(sl: SpanSlice, counts: Dict[str, int], key: Optional[str] = None) -> Optional[float]:
    """A counter's change over the slice a call (all of `counts` where
    `key` is None); None where the program lacks it."""
    if not sl.calls or (key is not None and key not in counts):
        return None
    return (sum(counts.values()) if key is None else counts[key]) / sl.calls
