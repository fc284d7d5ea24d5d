"""LBVH build and vectorised stackless traversal (port of
tracer_tpu/ops/bvh.py).

Build: triangle boxes -> scene bounds -> morton codes -> stable sort ->
Karras radix tree -> bottom-up refit of the node boxes, repeated until
nothing changes. Traversal is the parent-pointer stackless walk run for
the whole ray batch at once: per ray a cursor (current, prev) and a
shrinking tmax, advanced by gathers and selects until every lane has
left through the root. Rays are (N, 3).

Both loops end on a test of the whole batch, which is a host read on the
card, so they test only every CHECK_EVERY-th step: a refit round past
the fixed point changes nothing, and a lane that has left the tree is
left alone by `live`. The walk's step runs under ops/loop.run, so a
traced walk (a step captured by torch.export) is torch's while_loop.

Plain torch on either device: the TPU package has no kernel here either.
"""

from __future__ import annotations

import torch
from torch import nn

from tracer_tpu_torch.ops import loop, morton, radix_tree, shapes

CHECK_EVERY = 8


class LBVH(nn.Module):
    """Node arrays over the I = n-1 internal nodes; tris are in morton
    order. Child pointers use the radix_tree encoding: [0, I) internal,
    [I, I+n) leaf (index - I into the reordered leaves).

    node_min, node_max: (I, 3) f32; left, right, parent: (I,) int32;
    tris: (n, 3, 3) f32 reordered; perm: (n,) int32, leaf i was input
    triangle perm[i]."""

    def __init__(self, node_min, node_max, left, right, parent, tris, perm):
        super().__init__()
        for name, v in (("node_min", node_min), ("node_max", node_max),
                        ("left", left), ("right", right), ("parent", parent),
                        ("tris", tris), ("perm", perm)):
            self.register_buffer(name, v)


def build(tris) -> LBVH:
    """Build an LBVH over (n, 3, 3) triangles, n >= 2, on their device."""
    tris = torch.as_tensor(tris, dtype=torch.float32).reshape(-1, 3, 3)
    n = tris.shape[0]

    tri_min, tri_max = shapes.bounding_box_triangle(tris)
    scene_min = tri_min.amin(dim=0)
    dims = torch.clamp_min(tri_max.amax(dim=0) - scene_min, 1e-30)
    centers = (shapes.aabb_center(tri_min, tri_max) - scene_min) / dims
    codes = morton.morton3d(centers)

    order = torch.sort(codes, stable=True).indices
    codes = codes[order]
    tris = tris[order]
    tri_min = tri_min[order]
    tri_max = tri_max[order]

    tree = radix_tree.build(codes)
    n_int = n - 1
    left, right = tree.left.long(), tree.right.long()

    def child_aabb(node_min, node_max, ptr):
        leaf = radix_tree.is_leaf(ptr, n_int)[:, None]
        li = torch.clamp(radix_tree.leaf_index(ptr, n_int), 0, n - 1)
        ii = torch.clamp(ptr, 0, n_int - 1)
        return (torch.where(leaf, tri_min[li], node_min[ii]),
                torch.where(leaf, tri_max[li], node_max[ii]))

    def refit_round(node_min, node_max):
        lmin, lmax = child_aabb(node_min, node_max, left)
        rmin, rmax = child_aabb(node_min, node_max, right)
        return torch.minimum(lmin, rmin), torch.maximum(lmax, rmax)

    zeros = torch.zeros((n_int, 3), device=tris.device)
    node_min, node_max = refit_round(zeros, zeros)
    for it in range(1, n_int + 3):
        new_min, new_max = refit_round(node_min, node_max)
        done = (it % CHECK_EVERY == 0
                and torch.equal(new_min, node_min)
                and torch.equal(new_max, node_max))
        node_min, node_max = new_min, new_max
        if done:
            break

    return LBVH(node_min=node_min, node_max=node_max, left=tree.left,
                right=tree.right, parent=tree.parent, tris=tris,
                perm=order.to(torch.int32))


def _traverse(bvh: LBVH, tmax0, origin, d, *, any_hit: bool,
              max_iters: int | None = None):
    """The shared stackless walk. Returns (closest_leaf (N,), tmax (N,))
    for the closest hit, or (hit (N,) bool, tmax) for any hit.

    One step (body) over the carry (step, current, prev, closest[,
    tmax]) runs under ops/loop.run: eagerly it tests for a live lane
    every CHECK_EVERY-th step; traced it is torch's while_loop with cond
    (step < max_iters) & any lane live. A step leaves a lane that has
    left the tree as it is, so the two stop at different steps and give
    the same result."""
    n_int = bvh.left.shape[0]
    n_leaves = bvh.tris.shape[0]
    n_rays = origin.shape[0]
    dev = origin.device
    if max_iters is None:
        # each internal node is entered at most 3 times on the walk
        max_iters = 3 * n_int + 3 * n_leaves + 8
    left, right, parent = bvh.left.long(), bvh.right.long(), bvh.parent.long()

    tmax = torch.as_tensor(tmax0, dtype=torch.float32,
                           device=dev).expand(n_rays).clone()
    init = (torch.zeros((), dtype=torch.int64, device=dev),
            torch.zeros((n_rays,), dtype=torch.int64, device=dev),
            torch.full((n_rays,), -1, dtype=torch.int64, device=dev),
            torch.zeros((n_rays,), dtype=torch.bool, device=dev) if any_hit
            else torch.full((n_rays,), -1, dtype=torch.int64, device=dev))

    def cond(it, current, *_):
        return (it < max_iters) & (current != -1).any()

    def body(it, current, prev, closest, *tmax_carry):
        # any hit never lowers tmax: it is not carried, since a loop's
        # step may not hand back one of its inputs unchanged
        t_max = tmax_carry[0] if tmax_carry else tmax
        live = current != -1
        ci = torch.where(live, current, 0)
        node_left = left[ci]
        node_right = right[ci]

        aabb_hit = shapes.hit_aabb(t_max, origin, d, bvh.node_min[ci],
                                   bvh.node_max[ci])
        from_left = prev == node_left
        take_left = (~from_left) & (prev != node_right) & aabb_hit
        has_child = from_left | take_left
        child = torch.where(from_left, node_right, node_left)

        child_is_leaf = radix_tree.is_leaf(child, n_int) & has_child
        li = torch.clamp(radix_tree.leaf_index(child, n_int), 0, n_leaves - 1)
        tri = bvh.tris[torch.where(child_is_leaf, li, 0)]
        ok, t, _, _ = shapes.hit_triangle(t_max, origin, d, tri)
        leaf_hit = child_is_leaf & ok & live

        if any_hit:
            closest = closest | leaf_hit
        else:
            closest = torch.where(leaf_hit, li, closest)
            t_max = torch.where(leaf_hit, t, t_max)

        # next cursor: go down into an internal child, stay for a leaf
        # test, or go back up when no child is left
        descend = has_child & ~child_is_leaf
        new_current = torch.where(descend, child,
                                  torch.where(has_child, current, parent[ci]))
        new_prev = torch.where(descend | child_is_leaf, child,
                               torch.where(has_child, prev, current))
        if any_hit:
            new_current = torch.where(closest, -1, new_current)
        out = (it + 1, torch.where(live, new_current, current),
               torch.where(live, new_prev, prev), closest)
        return out if any_hit else out + (t_max,)

    carry = loop.run(cond, body, init if any_hit else init + (tmax,),
                     max_iters, name="lbvh", check_every=CHECK_EVERY)
    return carry[3], (tmax if any_hit else carry[4])


def closest_hit(bvh: LBVH, tmax, origin, d):
    """Closest hit of (N, 3) rays. Returns (ok, t, tri_idx (input index,
    -1 on a miss), pos (N, 3), normal (N, 3)); the winning leaf is
    intersected once more at the caller's tmax."""
    leaf, _ = _traverse(bvh, tmax, origin, d, any_hit=False)
    ok0 = leaf >= 0
    li = torch.where(ok0, leaf, 0)
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=origin.device)
    ok, t, pos, normal = shapes.hit_triangle(tmax, origin, d, bvh.tris[li])
    ok = ok & ok0
    return (ok, torch.where(ok, t, float("inf")),
            torch.where(ok, bvh.perm[li], -1), pos, normal)


def any_hit(bvh: LBVH, tmax, origin, d):
    """Shadow-ray query: any intersection before tmax."""
    return _traverse(bvh, tmax, origin, d, any_hit=True)[0]
