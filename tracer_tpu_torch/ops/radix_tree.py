"""Karras radix-tree construction (port of tracer_tpu/ops/radix_tree.py).

Karras 2012, "Maximizing Parallelism in the Construction of BVHs, Octrees,
and k-d Trees": given sorted Morton codes, every internal node finds its
range and its split on its own by binary searches on the
longest-common-prefix function delta. Each search is a fixed-trip masked
loop over the possible doublings and halvings, vectorised over the
(n-1,) node axis. Duplicate codes are told apart by their index.

Child pointer encoding, as the JAX package's: ptr in [0, n-1) is an
internal node; ptr >= n-1 is leaf (ptr - (n-1)).

Words are int64 tensors holding 32-bit values (torch's uint32 lacks the
arithmetic on the CPU); the pointers come out as int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_MAX_DOUBLINGS = 32


class RadixTree(NamedTuple):
    left: torch.Tensor    # (n-1,) int32 encoded child ptr
    right: torch.Tensor   # (n-1,) int32 encoded child ptr
    parent: torch.Tensor  # (n-1,) int32 parent internal index, -1 for root


def leaf_ptr(i, n_internal):
    return i + n_internal


def is_leaf(ptr, n_internal):
    return ptr >= n_internal


def leaf_index(ptr, n_internal):
    return ptr - n_internal


def clz32(x):
    """Leading zeros of 32-bit words held in an integer tensor, exact;
    clz32(0) = 32. The float64 of a 32-bit word is exact, and frexp's
    exponent is its bit length."""
    return 32 - torch.frexp(x.to(torch.float64))[1].to(torch.int64)


def build(mortons) -> RadixTree:
    """The internal-node hierarchy of sorted morton codes (n,), n >= 2."""
    mortons = torch.as_tensor(mortons).to(torch.int64) & 0xFFFFFFFF
    n = mortons.shape[0]
    assert n >= 2, "radix tree needs at least 2 leaves"
    n_int = n - 1
    dev = mortons.device

    def delta(i, j):
        """Common-prefix length of codes i, j; -1 when j is out of range.
        Equal codes go on into the prefix of their indices."""
        in_range = (j >= 0) & (j < n)
        jc = torch.clamp(j, 0, n - 1)
        li = mortons[i]
        lj = mortons[jc]
        lcp = torch.where(li == lj, 32 + clz32(i ^ jc), clz32(li ^ lj))
        return torch.where(in_range, lcp, -1)

    i = torch.arange(n_int, dtype=torch.int64, device=dev)

    # direction of each node's range
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    delta_min = delta(i, i - d)

    # upper bound on the range length: double while delta exceeds delta_min
    l_max = torch.full((n_int,), 2, dtype=torch.int64, device=dev)
    active = delta(i, i + l_max * d) > delta_min
    for _ in range(_MAX_DOUBLINGS):
        l_max = torch.where(active, l_max * 2, l_max)
        active = active & (delta(i, i + l_max * d) > delta_min)

    # binary search for the other end j = i + l*d
    l = torch.zeros((n_int,), dtype=torch.int64, device=dev)
    for k in range(31):
        t = l_max >> (k + 1)
        ok = (t >= 1) & (delta(i, i + (l + t) * d) > delta_min)
        l = torch.where(ok, l + t, l)
    j = i + l * d
    delta_node = delta(i, j)

    # binary search for the split, steps t = ceil(l / 2^(k+1))
    s = torch.zeros((n_int,), dtype=torch.int64, device=dev)
    for k in range(31):
        t = (l >> (k + 1)) + ((l & ((1 << (k + 1)) - 1)) != 0)
        ok = ((1 << k) <= l) & (delta(i, i + (s + t) * d) > delta_node)
        s = torch.where(ok, s + t, s)
    gamma = i + s * d + torch.clamp_max(d, 0)

    left_is_leaf = torch.minimum(i, j) == gamma
    right_is_leaf = torch.maximum(i, j) == gamma + 1
    left = torch.where(left_is_leaf, leaf_ptr(gamma, n_int), gamma)
    right = torch.where(right_is_leaf, leaf_ptr(gamma + 1, n_int), gamma + 1)

    # parent pointers: each node writes its index into both internal
    # children; a leaf child writes into slot n_int, which is cut off
    parent = torch.full((n_int + 1,), -1, dtype=torch.int64, device=dev)
    parent[torch.where(left_is_leaf, n_int, gamma)] = i
    parent[torch.where(right_is_leaf, n_int, gamma + 1)] = i
    return RadixTree(left=left.to(torch.int32), right=right.to(torch.int32),
                     parent=parent[:n_int].to(torch.int32))
