"""Keccak-256 over a batch of transcript buffers: the counterpart of the
JAX package's `hash/keccak_device.py` (`keccak_f` :82, `keccak256_words`
:137, `limbs_to_lanes` / `lanes_to_limbs` :165-185).

A transcript buffer is W 32-byte words.  Each is a value in the port's word
layout, (..., 8) int32 little-endian 32-bit words, and enters the sponge as
the four 64-bit lanes of its big-endian encoding: lane i is the
byte-reversed 64-bit chunk 3 - i of the value (`words_to_lanes`,
`lanes_to_words`).  After the words come static padding lanes, the same for
every buffer of W words (`pad_lanes`): the dup marker 0x01 after a lone
word (transcript/evm.rs:88), then the keccak pad 0x01 ... 0x80.

* `ReadSchedule` — a transcript read's squeezes word by word, recorded once
  per protocol (`verifier/plonk/plan.py`): each word's source (an instance,
  a constant, a stream scalar, the x or y of a stream point, an earlier
  squeeze's hash, the x or y of a lane point), its index there and its tag.
* `read(schedule, inst, scalars, points, lanes)` — every squeeze of a
  batch's read -> (hashes, challenges), (n_sq, B, 8) each; `lanes` are the
  affine lane points (instance commitments, computed before the read).  On
  CUDA tensors one launch of `svt_keccak_read` (csrc/keccak_kernels.cu: a
  warp a proof); on CPU tensors `read_plain`, the same schedule squeeze by
  squeeze.
* `squeeze(words, tags)` — one transcript squeeze of (B, W, 8) words, word
  w tagged TAG_RAW (a previous hash), TAG_FR or TAG_FQ (a field element in
  Montgomery form, hashed as its canonical value) -> (hash (B, 8) raw
  words, challenge (B, 8) Fr Montgomery words, the hash mod r).  On a CUDA
  tensor the same kernel with a schedule of one squeeze; on a CPU tensor
  `squeeze_plain`.
* `keccak_f_plain`, `keccak256_words_plain`, `squeeze_plain`, `read_plain`
  — the plain versions on int64 tensors (lanes as two's-complement int64:
  torch has no uint64, and `>>` on int64 is arithmetic, so each rotation
  masks what the right shift drags in).  They run on any device; the checks
  hold the kernel to them.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .._build import load_library
from .._launch import check, launch, same_device
from ..ff import FQW, FRW
from .keccak import _ROTATIONS, _ROUND_CONSTANTS, RATE

TAG_RAW, TAG_FR, TAG_FQ = 0, 1, 2  # the tags of csrc/keccak_kernels.cu
# A word's source in a read (csrc/keccak_kernels.cu's KC_SRC_*)
(SRC_INSTANCE, SRC_CONST, SRC_SCALAR, SRC_POINT_X, SRC_POINT_Y, SRC_HASH, SRC_LANE_X,
 SRC_LANE_Y) = range(8)
RATE_LANES = RATE // 8  # 17
_FIELDS = {TAG_FR: FRW, TAG_FQ: FQW}
_I64 = torch.int64


def _signed(v: int) -> int:
    """A uint64 as the int64 with the same bits."""
    return v - (1 << 64) if v >> 63 else v


@functools.lru_cache(maxsize=None)
def _host_tables():
    """(round constants (24,), pi's source lane, rotation, right shift and
    carry mask (25,) each) int64 numpy, flat lane index x + 5 y: the fused
    rho + pi step is b[dest] = rotl(a[src[dest]], rot[dest])."""
    src = np.zeros(25, np.int64)
    rot = np.zeros(25, np.int64)
    for x in range(5):
        for y in range(5):
            dest = y + 5 * ((2 * x + 3 * y) % 5)
            src[dest] = x + 5 * y
            rot[dest] = _ROTATIONS[x][y]
    # rotl(v, n) = (v << n) | ((v >> (64 - n)) & (2^n - 1)); n = 0 takes nothing
    # from the right shift (its mask is 0).
    rshift = (64 - rot) % 64
    mask = np.array([(1 << int(n)) - 1 for n in rot], np.int64)
    rc = np.array([_signed(c) for c in _ROUND_CONSTANTS], np.int64)
    return rc, src, rot, rshift, mask


_tables: dict = {}


def _device_tables(device):
    key = str(device)
    if key not in _tables:
        _tables[key] = tuple(torch.from_numpy(a).to(device) for a in _host_tables())
    return _tables[key]


def keccak_f_plain(state):
    """One keccak-f[1600] of (..., 25) int64 lanes (lane x + 5 y)."""
    rc, src, rot, rshift, mask = _device_tables(state.device)
    shape = state.shape
    st = state
    for r in range(len(_ROUND_CONSTANTS)):
        grid = st.reshape(*shape[:-1], 5, 5)  # (..., y, x)
        c = grid[..., 0, :] ^ grid[..., 1, :] ^ grid[..., 2, :] ^ grid[..., 3, :] ^ grid[..., 4, :]
        c1 = torch.roll(c, -1, -1)
        d = torch.roll(c, 1, -1) ^ ((c1 << 1) | ((c1 >> 63) & 1))
        st = (grid ^ d[..., None, :]).reshape(shape)
        b = st.index_select(-1, src)
        b = (b << rot) | ((b >> rshift) & mask)
        bg = b.reshape(*shape[:-1], 5, 5)
        st = (bg ^ (~torch.roll(bg, -1, -1) & torch.roll(bg, -2, -1))).reshape(shape)
        st = torch.cat([st[..., :1] ^ rc[r], st[..., 1:]], -1)
    return st


@functools.lru_cache(maxsize=None)
def pad_lanes(num_words: int) -> Tuple[np.ndarray, int]:
    """The static sponge lanes after a buffer of `num_words` 32-byte words:
    ((L, 2) int32 (lo, hi) halves of lanes 4 W, ..., 17 nblocks - 1,
    nblocks).  The dup marker 0x01 follows a lone word (the transcript's
    squeeze of a bare hash), then the keccak pad 0x01 ... 0x80."""
    if num_words < 1:
        raise ValueError("keccak: a squeeze hashes at least one word")
    extra = 1 if num_words == 1 else 0
    n = 32 * num_words + extra
    nblocks = n // RATE + 1
    buf = bytearray(nblocks * RATE)
    if extra:
        buf[32] = 0x01  # the transcript's dup marker (evm.rs:88)
    buf[n] = 0x01  # keccak pad
    buf[-1] |= 0x80
    halves = np.frombuffer(bytes(buf), "<u4").reshape(-1, 2)
    out = np.ascontiguousarray(halves[4 * num_words :]).view(np.int32)
    out.setflags(write=False)  # cached: every caller shares it
    return out, nblocks


def _pad_lanes64(num_words: int, device):
    halves, nblocks = pad_lanes(num_words)
    h = torch.from_numpy(halves.astype(np.int64) & 0xFFFFFFFF).to(device)
    return h[:, 0] | (h[:, 1] << 32), nblocks


def keccak256_words_plain(lanes):
    """keccak256 over buffers of W words given as (..., 4 W) int64 lanes, the
    dup marker after a lone word -> (..., 4) int64 hash lanes."""
    W = lanes.shape[-1] // 4
    pad, nblocks = _pad_lanes64(W, lanes.device)
    full = torch.cat([lanes, pad.expand(*lanes.shape[:-1], -1)], -1)
    st = torch.zeros(*lanes.shape[:-1], 25, dtype=_I64, device=lanes.device)
    for blk in range(nblocks):
        block = full[..., blk * RATE_LANES : (blk + 1) * RATE_LANES]
        st = keccak_f_plain(torch.cat([st[..., :RATE_LANES] ^ block, st[..., RATE_LANES:]], -1))
    return st[..., :4]


# ------------------------------------------------------------------- codec


def words_to_lanes(words):
    """(..., 8) int32 words of a value -> (..., 4) int64 lanes of its 32-byte
    big-endian encoding."""
    u = words.to(_I64) & 0xFFFFFFFF
    le = torch.stack([(u >> (8 * s)) & 0xFF for s in range(4)], -1).reshape(*u.shape[:-1], 32)
    be = le.flip(-1).reshape(*u.shape[:-1], 4, 8)
    lanes = be[..., 0]
    for j in range(1, 8):
        lanes = lanes | (be[..., j] << (8 * j))
    return lanes


def lanes_to_words(lanes):
    """(..., 4) int64 lanes of a 32-byte word -> (..., 8) int32 words of the
    value it encodes big-endian."""
    be = torch.stack([(lanes >> (8 * j)) & 0xFF for j in range(8)], -1)
    le = be.reshape(*lanes.shape[:-1], 32).flip(-1).reshape(*lanes.shape[:-1], 8, 4)
    u = le[..., 0] | (le[..., 1] << 8) | (le[..., 2] << 16) | (le[..., 3] << 24)
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


# ------------------------------------------------------------------ squeeze


def _check_tags(words, tags: Sequence[int]) -> Tuple[int, ...]:
    tags = tuple(int(t) for t in tags)
    if len(tags) != words.shape[1] or any(t not in (TAG_RAW, TAG_FR, TAG_FQ) for t in tags):
        raise ValueError(f"keccak_squeeze: tags {tags} for {words.shape[1]} words")
    if not tags:
        raise ValueError("keccak_squeeze: a squeeze hashes at least one word")
    return tags


def squeeze_plain(words, tags: Sequence[int]):
    """The plain squeeze on any device: (B, W, 8) words, (W,) tags ->
    (hash (B, 8) raw words, challenge (B, 8) Fr Montgomery words).  A
    tagged word leaves Montgomery form (the limb twin's multiply by plain 1,
    then canon); the challenge is the limb twin's Montgomery product of the
    hash and R^2, as the kernel's and the JAX package's."""
    tags = _check_tags(words, tags)
    B, W = words.shape[:2]
    plain = words.clone()
    for tag, F in _FIELDS.items():
        idx = [w for w, t in enumerate(tags) if t == tag]
        if idx:
            sel = torch.tensor(idx, device=words.device)
            x = words.index_select(1, sel)
            one = F.const("ONE_PLAIN", words.device)
            plain[:, sel] = F.plain("canon", F.plain("mul", x, one))
    h = lanes_to_words(keccak256_words_plain(words_to_lanes(plain).reshape(B, 4 * W)))
    return h, FRW.plain("mul", h, FRW.const("R2", words.device))


class ReadSchedule:
    """The squeezes of a transcript read, word by word.

    `squeezes[q]` is squeeze q's buffer: (source, index, tag) triples, the
    source one of SRC_*: instance `index` of the batch's instance block, the
    constant `consts[index]` (a canonical value, hashed raw), stream scalar
    `index`, the x or y of stream point `index`, squeeze `index`'s hash
    (an earlier one), or the x or y of lane point `index`.  Every squeeze
    hashes at least one word."""

    def __init__(self, squeezes: Sequence[Sequence[Tuple[int, int, int]]],
                 consts: Sequence[int] = ()):
        self.squeezes = [tuple((int(s), int(i), int(t)) for s, i, t in sq) for sq in squeezes]
        self.consts = [int(v) for v in consts]
        if not self.squeezes:
            raise ValueError("keccak read: no squeeze")
        for q, sq in enumerate(self.squeezes):
            if not sq:
                raise ValueError(f"keccak read: squeeze {q} hashes no word")
            for src, idx, tag in sq:
                if tag not in (TAG_RAW, TAG_FR, TAG_FQ) or idx < 0 or not (
                        SRC_INSTANCE <= src <= SRC_LANE_Y):
                    raise ValueError(f"keccak read: bad word {(src, idx, tag)} in squeeze {q}")
                if src == SRC_HASH and idx >= q:
                    raise ValueError(f"keccak read: squeeze {q} takes the hash of squeeze {idx}")
                if src == SRC_CONST and idx >= len(self.consts):
                    raise ValueError(f"keccak read: constant {idx} of {len(self.consts)}")
        self._tables: dict = {}

    @property
    def widths(self) -> List[int]:
        return [len(sq) for sq in self.squeezes]

    def need(self, src: int) -> int:
        """How many entries of source `src` the read takes (its largest index + 1)."""
        return 1 + max((i for sq in self.squeezes for s, i, _ in sq if s == src), default=-1)

    def tables(self, device):
        """(rows (n, 3), starts, pad (L, 2), pad starts, consts (k, 8)) int32
        on `device`, uploaded once."""
        key = str(device)
        if key not in self._tables:
            rows = np.array([w for sq in self.squeezes for w in sq], np.int32).reshape(-1, 3)
            starts = np.cumsum([0] + self.widths).astype(np.int32)
            pads = [pad_lanes(w)[0] for w in self.widths]
            pad_starts = np.cumsum([0] + [p.shape[0] for p in pads]).astype(np.int32)
            consts = np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
                               for v in self.consts], np.uint32).reshape(-1, 8).view(np.int32)
            self._tables[key] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in
                                      (rows, starts, np.concatenate(pads), pad_starts, consts))
        return self._tables[key]


def _no_lanes(scalars):
    return torch.empty((scalars.shape[0], 0, 2, 8), dtype=torch.int32, device=scalars.device)


def _read_inputs(schedule: ReadSchedule, inst, scalars, points, lanes):
    """Check a read's inputs against its schedule; -> B."""
    check("keccak_read", inst, 3, (8,))
    check("keccak_read", scalars, 3, (8,))
    check("keccak_read", points, 4, (2, 8))
    check("keccak_read", lanes, 4, (2, 8))
    same_device("keccak_read", inst, scalars, points, lanes)
    B = scalars.shape[0]
    n_pt = max(schedule.need(SRC_POINT_X), schedule.need(SRC_POINT_Y))
    n_lanes = max(schedule.need(SRC_LANE_X), schedule.need(SRC_LANE_Y))
    for name, t, n in (("instances", inst, schedule.need(SRC_INSTANCE)),
                       ("scalars", scalars, schedule.need(SRC_SCALAR)), ("points", points, n_pt),
                       ("lane points", lanes, n_lanes)):
        if t.shape[0] != B or t.shape[1] < n:
            raise ValueError(f"keccak_read: {name} {tuple(t.shape)} for a read of {B} proofs "
                             f"that takes {n}")
    return B


def squeeze_words(schedule: ReadSchedule, q: int, inst, scalars, points, hashes, lanes=None):
    """Squeeze q's buffer, (B, W, 8) words, and its tags: its words gathered
    from their sources, `hashes` the earlier squeezes' (q', B, 8), `lanes`
    the (B, l, 2, 8) affine lane points."""
    B = scalars.shape[0]
    consts = schedule.tables(scalars.device)[4]
    cols = [inst[:, idx] if src == SRC_INSTANCE
            else consts[idx].expand(B, 8) if src == SRC_CONST
            else scalars[:, idx] if src == SRC_SCALAR
            else points[:, idx, 0] if src == SRC_POINT_X
            else points[:, idx, 1] if src == SRC_POINT_Y
            else lanes[:, idx, 0] if src == SRC_LANE_X
            else lanes[:, idx, 1] if src == SRC_LANE_Y
            else hashes[idx]
            for src, idx, _ in schedule.squeezes[q]]
    return torch.stack(cols, 1), [t for _, _, t in schedule.squeezes[q]]


def read_plain(schedule: ReadSchedule, inst, scalars, points, lanes=None):
    """The plain read on any device: `squeeze_plain` squeeze by squeeze ->
    (hashes, challenges), (n_sq, B, 8) each."""
    lanes = _no_lanes(scalars) if lanes is None else lanes
    _read_inputs(schedule, inst, scalars, points, lanes)
    hashes, chals = [], []
    for q in range(len(schedule.squeezes)):
        h, c = squeeze_plain(*squeeze_words(schedule, q, inst, scalars, points, hashes, lanes))
        hashes.append(h)
        chals.append(c)
    return torch.stack(hashes, 0), torch.stack(chals, 0)


def _launch_read(kernel: str, schedule: ReadSchedule, inst, scalars, points, lanes):
    B, dev = scalars.shape[0], scalars.device
    rows, starts, pad, pad_starts, consts = schedule.tables(dev)
    n_sq = len(schedule.squeezes)
    h = torch.empty((n_sq, B, 8), dtype=torch.int32, device=dev)
    c = torch.empty((n_sq, B, 8), dtype=torch.int32, device=dev)
    if B:
        launch(kernel, load_library().svt_keccak_read, inst.data_ptr(), inst.shape[1],
               consts.data_ptr(), scalars.data_ptr(), scalars.shape[1], points.data_ptr(),
               points.shape[1], lanes.data_ptr(), lanes.shape[1], rows.data_ptr(),
               starts.data_ptr(), pad.data_ptr(), pad_starts.data_ptr(), n_sq, h.data_ptr(),
               c.data_ptr(), B, device=dev)
    return h, c


def read(schedule: ReadSchedule, inst, scalars, points, lanes=None):
    """A batch's whole read: inst (B, n_inst, 8) Fr Montgomery words, the
    stream's scalars (B, n, 8) and points (B, m, 2, 8), the lane points
    (B, l, 2, 8) (affine Fq Montgomery words; None: none) -> (hashes,
    challenges), (n_sq, B, 8) each.  On CUDA tensors one launch of
    `svt_keccak_read`; on CPU tensors `read_plain`."""
    if scalars.device.type == "cpu":
        return read_plain(schedule, inst, scalars, points, lanes)
    lanes = _no_lanes(scalars) if lanes is None else lanes
    _read_inputs(schedule, inst, scalars, points, lanes)
    return _launch_read("keccak_read", schedule, inst, scalars, points, lanes)


_single: dict = {}  # tags -> the schedule of one squeeze of those words


def squeeze(words, tags: Sequence[int]):
    """One squeeze of B transcript buffers: words (B, W, 8), tags (W,) ->
    (hash (B, 8), challenge (B, 8)).  On a CUDA tensor one launch of
    `svt_keccak_read` with a schedule of one squeeze (the words as the
    stream's scalars); on a CPU tensor `squeeze_plain`."""
    check("keccak_squeeze", words, 3, (8,))
    tags = _check_tags(words, tags)
    if words.device.type == "cpu":
        return squeeze_plain(words, tags)
    if tags not in _single:
        _single[tags] = ReadSchedule([[(SRC_SCALAR, w, t) for w, t in enumerate(tags)]])
    B, dev = words.shape[0], words.device
    none = torch.empty((B, 0, 8), dtype=torch.int32, device=dev)
    pts = torch.empty((B, 0, 2, 8), dtype=torch.int32, device=dev)
    h, c = _launch_read("keccak_squeeze", _single[tags], none, words, pts, pts)
    return h[0], c[0]
