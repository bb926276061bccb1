"""Run one cell of the benchmark of the PyTorch/CUDA port
(`snark_verifier_tpu_torch`) once, on the card of the machine it runs on:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  See harness/cli.py for what a run does and
prints.  The port's caches stay inside the checkout: its kernel library in
snark_verifier_tpu_torch/build/, and any torch extension or Triton cache
under perfbench/_cache/."""

import time

T_ENTER = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _process_start() -> float:
    """The perf_counter reading at this process's start, as near as /proc
    tells it (to a clock tick); the script's own start where it cannot."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return T_ENTER - max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError):
        return T_ENTER


if __name__ == "__main__":
    t_start = _process_start()
    cache = os.path.join(HERE, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness.cli import main

    sys.exit(main(sys.argv[1:], t_start))
