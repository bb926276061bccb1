"""The port's plain Keccak (hash/keccak_device.py) against the JAX
package's device keccak (`keccak_f`, `keccak256_words`, `limbs_to_lanes`,
`lanes_to_limbs`) and its host `keccak256` / `_keccak_f`: seeded random
states, every buffer length W = 1 ... 30 (the dup marker at W = 1, words
straddling the 136-byte block edge, W = 26 across 7 blocks), and the
word <-> lane codec.  The JAX results are computed once for the module.

Tolerance: exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_verifier_tpu.hash.keccak import _keccak_f as j_keccak_f_host
from snark_verifier_tpu.hash.keccak import keccak256 as j_keccak256
from snark_verifier_tpu.hash.keccak_device import keccak_f as j_keccak_f
from snark_verifier_tpu.hash.keccak_device import keccak256_words as j_keccak256_words
from snark_verifier_tpu.hash.keccak_device import lanes_to_limbs, limbs_to_lanes
from snark_verifier_tpu_torch.ff import limbs_to_words, words_to_limbs
from snark_verifier_tpu_torch.hash import keccak_device as kd
from snark_verifier_tpu_torch.hash.keccak import _keccak_f, keccak256

B = 3
MAX_W = 30


def _u64(t):
    return [int(v) & ((1 << 64) - 1) for v in t.reshape(-1)]


def _pairs_to_int64(pairs):
    """(..., 2) uint32 (lo, hi) numpy -> int64 torch lanes."""
    p = pairs.astype(np.uint64)
    return torch.from_numpy((p[..., 0] | (p[..., 1] << np.uint64(32))).view(np.int64))


def _value(words_row) -> int:
    return sum((int(w) & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(words_row))


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(0)
    return rng.integers(0, 1 << 64, size=(4, 25), dtype=np.uint64)


def test_keccak_f_plain_matches_jax_and_host(states):
    got = kd.keccak_f_plain(torch.from_numpy(states.view(np.int64)))
    pairs = np.stack([(states & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                      (states >> np.uint64(32)).astype(np.uint32)], -1)
    want_jax = _pairs_to_int64(np.asarray(jax.jit(j_keccak_f)(jnp.asarray(pairs))))
    assert torch.equal(got, want_jax)
    for row, g in zip(states, got):
        host = [[int(row[x + 5 * y]) for y in range(5)] for x in range(5)]
        want = _keccak_f([r[:] for r in host])
        assert _u64(g) == [want[x][y] for y in range(5) for x in range(5)]
        assert j_keccak_f_host([r[:] for r in host]) == want  # the copy is the JAX oracle's


@pytest.fixture(scope="module")
def buffers():
    """Per W: (B, W, 8) random raw words, their JAX hash lanes (B, 4, 2)."""
    rng = np.random.default_rng(1)
    out = {}
    for W in range(1, MAX_W + 1):
        limbs = rng.integers(0, 1 << 16, size=(B, W, 16)).astype(np.uint32)
        lanes = [limbs_to_lanes(jnp.asarray(limbs[:, w])) for w in range(W)]
        h = np.asarray(j_keccak256_words(lanes, batch_shape=(B,)))
        out[W] = (limbs_to_words(torch.from_numpy(limbs.astype(np.int64))), h)
    return out


@pytest.mark.parametrize("W", range(1, MAX_W + 1))
def test_keccak256_words_plain_matches_jax_and_host(buffers, W):
    words, want_jax = buffers[W]
    lanes = kd.words_to_lanes(words).reshape(B, 4 * W)
    got = kd.keccak256_words_plain(lanes)
    assert torch.equal(got, _pairs_to_int64(want_jax))
    for b in range(B):
        data = b"".join(_value(words[b, w]).to_bytes(32, "big") for w in range(W))
        want = keccak256(data + (b"\x01" if W == 1 else b""))
        assert want == j_keccak256(data + (b"\x01" if W == 1 else b""))
        assert b"".join(int(v).to_bytes(8, "little", signed=True) for v in got[b]) == want
    # the raw squeeze hashes the same bytes; its hash word is the value read big-endian
    h, _ = kd.squeeze(words.contiguous(), [kd.TAG_RAW] * W)
    assert torch.equal(kd.words_to_lanes(h), got)


def test_pad_lanes_edges():
    """The pad byte lands at 32 W (+1 after a lone word); 0x80 ends the
    last block; a buffer that fills a block exactly takes a block of its own."""
    for W in range(1, MAX_W + 1):
        halves, nblocks = kd.pad_lanes(W)
        n = 32 * W + (W == 1)
        assert nblocks == n // 136 + 1 and halves.shape == (17 * nblocks - 4 * W, 2)
        raw = bytes(32 * W) + halves.view(np.uint32).astype("<u4").tobytes()
        assert raw[n] & 0x01 and raw[-1] & 0x80 and len(raw) == 136 * nblocks
        assert (raw[32] == 0x01) == (W == 1)
    assert kd.pad_lanes(26)[1] == 7
    with pytest.raises(ValueError):
        kd.pad_lanes(0)


def test_codec_matches_jax():
    rng = np.random.default_rng(2)
    limbs = rng.integers(0, 1 << 16, size=(64, 16)).astype(np.uint32)
    limbs[0] = 0
    limbs[1] = 0xFFFF
    words = limbs_to_words(torch.from_numpy(limbs.astype(np.int64)))
    lanes = kd.words_to_lanes(words)
    want = np.asarray(limbs_to_lanes(jnp.asarray(limbs)))
    assert torch.equal(lanes, _pairs_to_int64(want))
    assert torch.equal(kd.lanes_to_words(lanes), words)
    back = np.asarray(lanes_to_limbs(jnp.asarray(want)))
    assert torch.equal(words_to_limbs(kd.lanes_to_words(lanes)),
                      torch.from_numpy(back.astype(np.int64)))
    # lane i is the byte-reversed 64-bit chunk 3 - i of the value
    v = _value(words[5])
    for i in range(4):
        chunk = (v >> (64 * (3 - i))) & ((1 << 64) - 1)
        assert _u64(lanes[5, i])[0] == int.from_bytes(chunk.to_bytes(8, "little"), "big")


def test_squeeze_rejects_bad_input():
    w = torch.zeros((2, 3, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        kd.squeeze(w, [0, 1])
    with pytest.raises(ValueError):
        kd.squeeze(w, [0, 1, 3])
    with pytest.raises(ValueError):
        kd.squeeze(torch.zeros((2, 0, 8), dtype=torch.int32), [])
    with pytest.raises(TypeError):
        kd.squeeze(w.long(), [0, 0, 0])
