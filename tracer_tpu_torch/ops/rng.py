"""Counter-based per-lane RNG, bit-exact with tracer_tpu/ops/rng.py.

Each lane carries a 32-bit PCG state made by hashing (seed, frame, lane
id); the salted draws use 20-round threefry2x32. The generator is
stateless, so no torch.Generator is involved.

torch's uint32 lacks add, shifts and remainder on the CPU, so every
32-bit word lives in an int64 tensor in [0, 2^32) and is masked after
each add and multiply. int64 products wrap modulo 2^64, so the low 32
bits are right even when a product overflows; the same code runs on
CUDA.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_MULT = 747796405
_INC = 2891336453

# Matches the reference's [0, 0.9999) unit interval (rand.fut:15-16).
UNIT_SCALE = 0.9999
_UNIT_F = UNIT_SCALE / (1 << 24)
_UNIFORM_F = 1.0 / (1 << 24)


def as_u32(x) -> torch.Tensor:
    """A python int, numpy array or tensor as int64 words in [0, 2^32)."""
    return torch.as_tensor(x).to(torch.int64) & MASK


def sqrt_rn(x):
    """Correctly rounded f32 square root. torch's vectorised CPU sqrt can be
    an ulp off; the f64 root of an f32 rounds back exactly."""
    return torch.sqrt(x.double()).float()


def _pcg_permute(state):
    """RXS-M-XS output permutation."""
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK
    return (word >> 22) ^ word


def hash_u32(x):
    """One full PCG step as a stateless hash u32 -> u32."""
    return _pcg_permute((as_u32(x) * _MULT + _INC) & MASK)


def make_streams(seed: int, frame: int, lane_ids: torch.Tensor):
    """Independent per-lane states; seed and frame are python ints."""
    base = int(hash_u32(int(seed) ^ int(hash_u32(int(frame)))))
    return hash_u32(as_u32(lane_ids) ^ base)


def next_u32(state):
    """Advance each lane one step; return (new_state, uniform u32)."""
    state = (state * _MULT + _INC) & MASK
    return state, _pcg_permute(state)


def next_unit(state):
    """Uniform f32 in [0, UNIT_SCALE) per lane."""
    state, bits = next_u32(state)
    return state, (bits >> 8).to(torch.float32) * _UNIT_F


def next_uniform(state, lo=0.0, hi=1.0):
    """Uniform f32 in [lo, hi) per lane."""
    state, bits = next_u32(state)
    u = (bits >> 8).to(torch.float32) * _UNIFORM_F
    return state, lo + u * (hi - lo)


def in_unit_disk_xy(state):
    """Uniform point in the unit disk as two (...,) components."""
    state, theta = next_uniform(state, 0.0, 2.0 * math.pi)
    state, u = next_unit(state)
    r = sqrt_rn(u)
    return state, (r * torch.cos(theta), r * torch.sin(theta))


def in_unit_square(state):
    """Pair of unit uniforms."""
    state, x = next_unit(state)
    state, y = next_unit(state)
    return state, (x, y)


def in_triangle(state):
    """Uniform barycentric sample."""
    state, (u, v) = in_unit_square(state)
    su = sqrt_rn(u)
    return state, (1.0 - su, v * su)


def select(state, n: int):
    """Uniform index in [0, n) via u32 modulo; n >= 1."""
    state, bits = next_u32(state)
    return state, (bits % int(n)).to(torch.int32)


_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(key0: int, key1: int, x0, x1):
    """Threefry-2x32, 20 rounds, over u32 words held in int64."""
    k0 = int(key0) & MASK
    k1 = int(key1) & MASK
    k2 = k0 ^ k1 ^ _THREEFRY_PARITY
    ks = (k0, k1, k2)
    x0 = (as_u32(x0) + k0) & MASK
    x1 = (as_u32(x1) + k1) & MASK
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def salted_pair(state, salt: int):
    """Two u32 draws decorrelated from the sequential chain; a pure
    function of (state, salt) that does not advance the chain."""
    x1 = torch.full_like(state, 0x85EBCA6B)
    return threefry2x32(salt, 0x9E3779B9, state, x1)
