"""Keccak-256 in python ints, the Ethereum variant (pad 0x01 ... 0x80, not
SHA-3's 0x06): a frozen copy of the port's `hash/keccak.py`, the EVM transcript's squeeze.

The state is `state[x][y]`, 25 lanes of 64 bits; a sponge block is 136
bytes (17 lanes, lane i at x = i % 5, y = i // 5, little-endian).
"""

from __future__ import annotations

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_MASK = (1 << 64) - 1
RATE = 136  # bytes of a sponge block: the 1088-bit rate


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _MASK


def _keccak_f(state):
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [state[x][0] ^ state[x][1] ^ state[x][2] ^ state[x][3] ^ state[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(state[x][y], _ROTATIONS[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _MASK)
        # iota
        state[0][0] ^= rc
    return state


def keccak256(data: bytes) -> bytes:
    state = [[0] * 5 for _ in range(5)]
    padded = bytearray(data)
    padded.append(0x01)
    while len(padded) % RATE:
        padded.append(0x00)
    padded[-1] |= 0x80
    for off in range(0, len(padded), RATE):
        block = padded[off : off + RATE]
        for i in range(RATE // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            state[x][y] ^= lane
        state = _keccak_f(state)
    out = b""
    for i in range(4):  # 32 bytes
        x, y = i % 5, i // 5
        out += state[x][y].to_bytes(8, "little")
    return out
