"""The warm-start cache: what a verify needs, kept across processes.  The
port's counterpart of the JAX package's `sdk/aot.py` (`enabled` :27,
`digest` :68, `try_load` :84, `save` :110, `_prune` :128,
`load_or_compile` :154).

The JAX package caches compiled XLA executables.  The port's compilation is
`_build.py`'s nvcc build, already cached by a hash of its sources; what a
fresh process still recomputes is each recorded plan
(`verifier/plonk/plan.py::succinct_plan`, `pcs/ipa/plan.py::ipa_plan`) and
the SRS's G2 lines (`Srs.decider_coeffs_host`, python-int G2 arithmetic).
This module keeps those as records: numpy arrays (the tape's rows and
constants, the MSM records, the keccak schedule, the lines) and a JSON
header (labels and sizes), one `.npz` file an entry, written without
pickle and read with `allow_pickle=False`.  Nothing in a record holds a
device tensor: the loaded object uploads its tables on first use, as a
recorded one does.

Enabled by default for a CUDA device only; `SNARK_AOT=0` disables it and
`SNARK_AOT=1` enables it for any device (the CPU tests set it).
`SNARK_AOT_DIR` names the cache directory (default
`snark_verifier_tpu_torch/build/aot/`), `SNARK_AOT_MAX_BYTES` bounds it
(least recently used entries go first).  A stale or corrupt entry is
deleted and recorded again; an entry's key carries a hash of the port's
`.py` and `csrc/` sources, so a changed program never reads an old record.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

PKG_DIR = Path(__file__).resolve().parent.parent
Record = Tuple[Dict[str, np.ndarray], Dict[str, Any]]  # (arrays, JSON header)


def enabled(device=None) -> bool:
    """SNARK_AOT decides where it is set; else on for a CUDA device only."""
    env = os.environ.get("SNARK_AOT")
    if env is not None:
        return env.strip().lower() not in ("", "0", "false", "off", "no")
    return device is not None and torch.device(device).type == "cuda"


def cache_dir() -> Path:
    d = Path(os.environ.get("SNARK_AOT_DIR") or PKG_DIR / "build" / "aot")
    d.mkdir(parents=True, exist_ok=True)
    return d


_CODE_FP: Optional[str] = None


def _code_fingerprint() -> str:
    """A hash of the package's python and CUDA sources: a record never
    outlives the code that made it."""
    global _CODE_FP
    if _CODE_FP is None:
        h = hashlib.sha256()
        for p in sorted(PKG_DIR.rglob("*")):
            rel = p.relative_to(PKG_DIR)
            if rel.parts[0] == "build" or not p.is_file():
                continue
            if p.suffix == ".py" or rel.parts[0] == "csrc":
                h.update(str(rel).encode())
                h.update(p.read_bytes())
        _CODE_FP = h.hexdigest()
    return _CODE_FP


def digest(key_parts: Sequence[Any]) -> str:
    """A stable cross-process digest of a cache key (repr-based: content
    hashes and shapes, never object ids), salted with the sources'
    fingerprint and the torch and numpy versions."""
    payload = repr((tuple(repr(p) for p in key_parts), _code_fingerprint(),
                    torch.__version__, np.__version__)).encode()
    return hashlib.sha256(payload).hexdigest()[:32]


def _path(key: str) -> Path:
    return cache_dir() / f"{key}.npz"


def _drop(path: Path, why: str) -> None:
    try:
        path.unlink()
    except OSError:
        pass
    print(f"# aot: {path.name}: {why}; recording again", file=sys.stderr, flush=True)


def try_load(key: str) -> Optional[Record]:
    """The record of `key`, or None: a missing entry, or one that does not
    read (deleted, so the caller records it again)."""
    path = _path(key)
    if not path.exists():
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        meta = json.loads(str(arrays.pop("__meta__")))
        os.utime(path)  # the LRU touch of _prune
        return arrays, meta
    except Exception as e:  # truncated, corrupt or foreign: record again
        _drop(path, f"reload failed ({type(e).__name__}: {e})")
        return None


def save(key: str, record: Record) -> None:
    """Write `record` under `key` (a temporary file, then an atomic
    rename), then bound the cache."""
    arrays, meta = record
    path = _path(key)
    tmp = path.with_name(f"{path.stem}.tmp{os.getpid()}.npz")
    try:
        np.savez(tmp, __meta__=np.array(json.dumps(meta)), **arrays)
        os.replace(tmp, path)
    except OSError as e:
        print(f"# aot: saving {path.name} failed ({e}); the record stays in this process",
              file=sys.stderr, flush=True)
        return
    _prune()


def _prune() -> None:
    """Evict the least recently used entries past SNARK_AOT_MAX_BYTES
    (default 1 GiB; a plan's record is tens of KB)."""
    limit = int(os.environ.get("SNARK_AOT_MAX_BYTES", str(1 << 30)))
    entries = []
    for p in cache_dir().glob("*.npz"):
        try:
            st = p.stat()
            entries.append((st.st_mtime, st.st_size, p))
        except OSError:
            pass
    total = sum(s for _, s, _ in entries)
    for _, size, p in sorted(entries):  # oldest first
        if total <= limit:
            break
        try:
            p.unlink()
            total -= size
        except OSError:
            pass


def load_or_compile(key_parts: Sequence[Any], build: Callable[[], Any],
                    encode: Callable[[Any], Record], decode: Callable[[Dict, Dict], Any]):
    """The object `build()` makes, through the cache: a hit is
    `decode(arrays, meta)` of the saved record; a miss, or a record that
    does not decode (deleted), is `build()`, saved as `encode(obj)` for the
    next process."""
    key = digest(key_parts)
    rec = try_load(key)
    if rec is not None:
        try:
            return decode(*rec)
        except Exception as e:
            _drop(_path(key), f"decode failed ({type(e).__name__}: {e})")
    obj = build()
    save(key, encode(obj))
    return obj


# ------------------------------------------------- records of plain values


def to_json(x):
    """Labels and records -> JSON values, tuples tagged so that they come
    back as tuples (`from_json`)."""
    if isinstance(x, tuple):
        return {"t": [to_json(v) for v in x]}
    if isinstance(x, list):
        return [to_json(v) for v in x]
    if x is None or isinstance(x, (bool, int, str)):
        return x
    raise TypeError(f"aot: cannot record a {type(x).__name__}")


def from_json(x):
    if isinstance(x, dict):
        return tuple(from_json(v) for v in x["t"])
    if isinstance(x, list):
        return [from_json(v) for v in x]
    return x


_SRC_KINDS = ("stream", "lane", "const", "g")  # an MSM base's source: (kind, index), ("g",)


def _src_code(src) -> Tuple[int, int]:
    return _SRC_KINDS.index(src[0]), (src[1] if len(src) > 1 else -1)


def _src(code: int, idx: int) -> tuple:
    kind = _SRC_KINDS[code]
    return (kind,) if kind == "g" else (kind, int(idx))


def msm_arrays(rec, prefix: str) -> Dict[str, np.ndarray]:
    """A `MsmRecord` -> (n, 3) [output row, source kind, index] of its
    scaled terms and (m, 2) [kind, index] of its coefficient-1 terms."""
    return {prefix + "scaled": np.array([(r,) + _src_code(s) for r, s in rec.scaled],
                                        np.int64).reshape(-1, 3),
            prefix + "plain": np.array([_src_code(s) for s in rec.plain], np.int64).reshape(-1, 2)}


def msm_from(arrays, prefix: str):
    from ..loader.tape_loader import MsmRecord

    return MsmRecord([(int(r), _src(c, i)) for r, c, i in arrays[prefix + "scaled"].tolist()],
                     [_src(c, i) for c, i in arrays[prefix + "plain"].tolist()])


def tape_record(tape) -> Record:
    """An `FrTape` -> its rows and constants, its labels and slot count."""
    return ({"tape_rows": tape.rows, "tape_consts": tape.consts},
            {"inputs": to_json(tape.inputs), "outputs": to_json(tape.outputs),
             "n_slots": int(tape.n_slots)})


def tape_from(arrays, meta):
    from ..ff.fr_tape import FrTape

    return FrTape(np.ascontiguousarray(arrays["tape_rows"], np.int32),
                  np.ascontiguousarray(arrays["tape_consts"], np.int32),
                  from_json(meta["inputs"]), from_json(meta["outputs"]), int(meta["n_slots"]))
