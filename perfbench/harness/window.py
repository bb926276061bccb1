"""The measured window: a closed loop of one client with one call in
flight, cycling the cell's inputs until the window's seconds have passed.
Every call ends with its answer on the host, so a call's end is the
device's end too; the window runs from the first call's start to the last
call's end."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional


@dataclass
class Record:
    k: int  # the input's index
    t0: float
    t1: float
    out: Any
    traced: str = ""  # the traced run's part: "A", "B", "C"; "" untraced

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def run_calls(call: Callable, n_inputs: int, start_index: int, until: float,
              records: List[Record], min_calls: int = 1, tag: str = "",
              timings: Optional[list] = None, max_calls: Optional[int] = None) -> int:
    """Call inputs start_index, start_index + 1, ... (mod n_inputs) until the
    clock passes `until` (at least `min_calls`); append their records.
    With `timings` a list, each call gets a fresh dict, appended to it.
    At most `max_calls` calls where it is given.  Returns the next input
    index."""
    i = start_index
    done = 0
    while done < min_calls or (time.perf_counter() < until
                               and (max_calls is None or done < max_calls)):
        k = i % n_inputs
        tm = {} if timings is not None else None
        t0 = time.perf_counter()
        out = call(k, tm) if tm is not None else call(k)
        t1 = time.perf_counter()
        records.append(Record(k, t0, t1, out, tag))
        if tm is not None:
            timings.append(tm)
        i += 1
        done += 1
    return i


def window_seconds(records: List[Record]) -> float:
    return records[-1].t1 - records[0].t0

