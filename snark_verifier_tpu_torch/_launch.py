"""What every kernel wrapper of the port shares: argument checks, the
launch on the caller's stream, and the launch counts.

`LAUNCHES` counts each kernel's launches since the last `reset_launches()`:
a wrapper adds one where it launches its kernel, and nowhere else.
`chip_smoke.py` reads the counts around the main paths to show that they
ran through the kernels.  `COUNTERS` counts the program's other events
the same way, each where it happens: `msm_attempts` an `msm` run by
`msm_checked` (more than one a commitment where a bucket overflowed),
`host_waits` a place on the verify, tree and MSM paths where the host
blocks on the device (`utils.timing._wait`), `packed_uploads` a batch
whose streams and instances went to the device as one packed, non-blocking
upload (`sdk.aggregation._pack_inputs`), `lanes_invalid` a lane of a verify
batch that the screen answered False (`parallel.batch_verify._screen`): a
key that appears with its first count, and that `reset_launches()` drops.
"""

from __future__ import annotations

import torch

LAUNCHES = {
    # msm/cuda_ops.py
    "add": 0, "double": 0, "fold_buckets": 0, "msm_windowed": 0,
    "fold_segments": 0, "g1_add_chain": 0, "fq_mul_chain": 0,
    # msm/pippenger.py
    "bucket_reduce": 0,
    # ff/word_field.py
    "field_mul": 0, "field_add": 0, "field_sub": 0, "field_neg": 0,
    "field_inv": 0, "field_canon": 0, "points_to_fr": 0,
    # ff/fr_tape.py
    "fr_tape": 0,
    # hash/poseidon.py
    "poseidon_permute": 0, "poseidon_absorb": 0,
    # pairing/pairing.py
    "miller_loop": 0, "final_exp": 0, "fq12_op": 0,
    # pcs/kzg/accumulation.py
    "fr_powers": 0,
    # msm/cuda_ops.py: the IPA decider's h(X) coefficients
    "ipa_h_coeffs": 0,
    # hash/keccak_device.py: svt_keccak_read for a whole read, and for one
    # squeeze (EvmTranscript.squeeze_challenge)
    "keccak_read": 0, "keccak_squeeze": 0,
}


COUNTERS = {"msm_attempts": 0, "host_waits": 0, "packed_uploads": 0}
_COUNTERS_ALWAYS = tuple(COUNTERS)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    COUNTERS.clear()
    COUNTERS.update(dict.fromkeys(_COUNTERS_ALWAYS, 0))


def check(name: str, t, ndim: int, tail: tuple = ()):
    """t must be a contiguous int32 tensor of `ndim` dims ending in `tail`,
    on the CPU or a CUDA card; CUDA buffers of whole elements must be
    16-byte aligned (the kernels load 16 bytes at a time)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() != ndim or tuple(t.shape[ndim - len(tail):]) != tail:
        raise ValueError(f"{name}: bad shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.device.type == "cuda" and tail and tail[-1] == 8 and t.data_ptr() % 16:
        raise ValueError(f"{name}: element buffers must be 16-byte aligned")


def same_device(name: str, *ts):
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{name}: tensors on different devices")


def launch(kernel: str, fn, *args, device):
    """Call C entry point `fn(*args, stream)` on `device`'s current stream;
    raise if the launch was refused, else count it."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
    LAUNCHES[kernel] += 1
