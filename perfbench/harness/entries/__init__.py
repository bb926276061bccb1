"""The kinds of call a cell's window can drive, one module each; a cell
names its module as its `entry`.  Each module's `Entry` takes the run and
the device (None: the CUDA card) and offers:

  setup()          make the inputs from the seed and load the program's
                   state (the harness then calls every input once: every
                   shape the window uses, warmed up)
  n_inputs         how many inputs the window cycles
  call(k[, tm])    one call of the program on input k, its answer brought to
                   the host; `tm` the program's step timings (traced runs)
  work(k)          the call's work: proofs, leaves or points
  check(run)       after the window: every answer against the plain
                   reference -> [(name, value, limit)]; sets `failed_calls`
                   and `run.counts`
  free()           drop the program's state before the reference runs
  sync(), reset_peak(), device_info()   the card's side, shared
"""

from __future__ import annotations


class EntryBase:
    spans: tuple = ()  # "module:attribute" the traced run's slice B wraps
    has_timings = False

    def __init__(self, run, device=None):
        import torch

        self.run = run
        self.device = torch.device("cuda", torch.cuda.current_device()) if device is None \
            else torch.device(device)
        self.failed_calls = 0

    @property
    def n_inputs(self) -> int:
        raise NotImplementedError

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_peak(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def device_info(self) -> dict:
        import torch

        if self.device.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(self.device),
                "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(self.device))}

    def free(self):
        import gc

        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
