"""The traced run's two profiler slices, read into plain records.

Slice A profiles the device alone (torch.profiler's CUDA activity): every
kernel's name and (start, end), from which the busy time (the union of
the intervals), the device time by kernel name and the top device
operations come.  Slice B adds the host (CPU activity) and the harness's
spans (`torch.profiler.record_function`) around calls into the program's
layers: the device time of the kernels launched under each span, and the
idle gaps of the device labelled by what the host was doing then."""

from __future__ import annotations

import contextlib
import importlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from . import RunError, stats


@dataclass
class Slice:
    calls: int = 0
    window_s: float = 0.0
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)  # (name, s0, s1) s
    span_device_s: Dict[str, float] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)
    ks: List[int] = field(default_factory=list)  # the input index of each call

    @property
    def busy_s(self) -> float:
        return stats.union_seconds((s, e) for _, s, e in self.kernels)

    def device_s(self, names) -> float:
        """Device seconds of the kernels whose name contains one of `names`."""
        return sum(e - s for n, s, e in self.kernels if any(k in n for k in names))

    def top_ops(self, k: int = 10):
        by = defaultdict(float)
        for n, s, e in self.kernels:
            by[n] += e - s
        return sorted(([n[:120], v] for n, v in by.items()), key=lambda x: -x[1])[:k]


def _is_device(ev) -> bool:
    from torch.autograd import DeviceType

    return ev.device_type == DeviceType.CUDA


def device_kernels(prof) -> List[Tuple[str, float, float]]:
    """(name, start s, end s) of every device operation the profile holds."""
    out = []
    for ev in prof.events():
        if _is_device(ev):
            out.append((ev.name, ev.time_range.start * 1e-6, ev.time_range.end * 1e-6))
    return out


def _descendants(ev):
    stack = list(ev.cpu_children)
    while stack:
        e = stack.pop()
        yield e
        stack.extend(e.cpu_children)


def span_device_seconds(prof, span_names) -> Dict[str, float]:
    """The device seconds of the kernels launched under each named span."""
    secs = defaultdict(float)
    for ev in prof.events():
        if _is_device(ev) or ev.name not in span_names:
            continue
        for d in [ev, *_descendants(ev)]:
            secs[ev.name] += sum(k.duration for k in d.kernels) * 1e-6
    return dict(secs)


def idle_by_host(prof, kernels) -> Dict[str, float]:
    """The device's idle seconds between kernels, each gap given to the
    innermost harness span or, outside them, the outermost host operation
    running at the gap's middle ("host python" where none ran)."""
    host = []
    for ev in prof.events():
        if _is_device(ev) or ev.time_range.end <= ev.time_range.start:
            continue
        host.append((ev.time_range.start * 1e-6, ev.time_range.end * 1e-6, ev.name,
                     ev.cpu_parent is None, ev.name.startswith("bench::")))
    out = defaultdict(float)
    for g0, g1 in stats.gaps((s, e) for _, s, e in kernels):
        mid = 0.5 * (g0 + g1)
        live = [h for h in host if h[0] <= mid < h[1]]
        spans = [h for h in live if h[4]]
        if spans:
            label = max(spans, key=lambda h: h[0])[2]
        else:
            tops = [h for h in live if h[3]]
            label = min(tops, key=lambda h: h[0])[2] if tops else "host python"
        out[label] += g1 - g0
    return dict(out)


@contextlib.contextmanager
def spans_around(targets):
    """Wrap each "module:attribute" callable in a record_function span named
    "bench::<attribute>" for the block.  A target the program no longer
    has stops the run: a span that drops out would change a metric's
    source unseen, so a rename has to edit the entry's `spans` on purpose."""
    import torch

    missing = []
    for target in targets:
        mod_name, attr = target.split(":")
        try:
            getattr(importlib.import_module(mod_name), attr)
        except (ImportError, AttributeError):
            missing.append(target)
    if missing:
        raise RunError(f"span targets the program no longer has: {missing}")
    undo = []
    for target in targets:
        mod_name, attr = target.split(":")
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)

        def wrapped(*a, __fn=fn, __name=f"bench::{attr}", **kw):
            with torch.profiler.record_function(__name):
                return __fn(*a, **kw)

        setattr(mod, attr, wrapped)
        undo.append((mod, attr, fn))
    try:
        yield [f"bench::{t.split(':')[1]}" for t in targets]
    finally:
        for mod, attr, fn in reversed(undo):
            setattr(mod, attr, fn)


def profile(activities_host: bool):
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if activities_host else [])
    return torch.profiler.profile(activities=acts)
