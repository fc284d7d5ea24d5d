"""LBVH build and stackless traversal (port of tracer_tpu/ops/bvh.py),
with the walk as hand-written CUDA kernels, K14 and K15 (csrc/bvh.cu).

Build: triangle boxes -> scene bounds -> morton codes -> stable sort ->
Karras radix tree -> bottom-up refit of the node boxes, repeated until
nothing changes. The refit loop ends on a test of the whole tree, a host
read on the card, so it tests only every CHECK_EVERY-th round: a round
past the fixed point changes nothing.

Traversal is the parent-pointer stackless walk: per ray a cursor
(current, prev) and a shrinking tmax. A step at an internal node takes
its left child when it came from the parent and the ray enters the
node's box, its right child when it came back from the left one, and
goes up to the parent otherwise; a leaf child is tested in the same step
and the cursor stays. Rays are V3 (3, N); the box and triangle tests are
shapes.hit_aabb_v and shapes.triangle_t_v, whose every f32 operation is
one PyTorch op.

Dispatch: closest_hit and any_hit call the torch.library custom ops
tracer_tpu_torch::lbvh_closest_hit / lbvh_any_hit. Their CPU
implementation is the plain version, _traverse: the walk of the whole
batch at once, a step of gathers and selects over every lane, under
ops/loop.run (eagerly it reads its exit test every CHECK_EVERY-th step;
the test's host read is lbvh.exit). Their CUDA implementation launches
K14 (closest) or K15 (any) through ops/cuda_lib.py, one thread a lane
walking the same order with the same f32 operations, so it returns the
plain version's leaf and t on every lane, ties included, and its hit
flag. The fake rules give torch.export the output shapes, so the
exported step (utils/aot.py) holds the ops. Each launch, and each plain
call, adds its lanes to the counter query.lanes.<kernel>; each launch
adds the tree's triangles to query.tris.<kernel> (utils/profiling).

The TPU package has no kernel here: its walk is the plain version's.
"""

from __future__ import annotations

import torch
from torch import nn

from tracer_tpu_torch.ops import cuda_lib, loop, morton, radix_tree, shapes
from tracer_tpu_torch.utils import profiling

CHECK_EVERY = 8

# The kernels' names in cuda_lib's counts: K14, K15.
KERNELS = ("lbvh_closest", "lbvh_any")

# The LBVH's buffers the walk reads, in the ops' order.
BUFFERS = ("node_min", "node_max", "left", "right", "parent", "tris")


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
    """Build an LBVH over (n, 3, 3) triangles, n >= 2, on their device
    (span lbvh.build)."""
    with profiling.span("lbvh.build"):
        return _build(tris)


def _build(tris) -> LBVH:
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


def max_steps(n_int: int, n_leaves: int) -> int:
    """A bound on a lane's steps: each internal node is entered at most 3
    times on the walk, and each leaf tested once."""
    return 3 * n_int + 3 * n_leaves + 8


def _traverse(node_min, node_max, left, right, parent, tris, tmax, origin,
              d, *, any_hit: bool):
    """The plain walk over the LBVH's buffers (BUFFERS) of V3 rays (3, N)
    with tmax (N,). Returns (closest leaf (N,) int64, -1 on a miss, t (N,)
    f32, tmax where it misses) for the closest hit, or (hit (N,) bool,
    tmax) for any hit.

    One step (body) over the carry (step, current, prev, closest[,
    tmax]) runs under ops/loop.run: eagerly it tests for a live lane
    every CHECK_EVERY-th step; traced it is torch's while_loop with cond
    (step < max_iters) & any lane live. A step leaves a lane that has
    left the tree as it is, so the two stop at different steps and give
    the same result."""
    n_int = left.shape[0]
    n_leaves = tris.shape[0]
    n_rays = d.shape[1]
    dev = d.device
    max_iters = max_steps(n_int, n_leaves)
    left, right, parent = left.long(), right.long(), parent.long()
    inv_d = 1.0 / d

    tmax = torch.as_tensor(tmax, dtype=torch.float32,
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

        aabb_hit = shapes.hit_aabb_v(t_max, origin, inv_d, node_min[ci].T,
                                     node_max[ci].T)
        from_left = prev == node_left
        take_left = (~from_left) & (prev != node_right) & aabb_hit
        has_child = from_left | take_left
        child = torch.where(from_left, node_right, node_left)

        child_is_leaf = radix_tree.is_leaf(child, n_int) & has_child
        li = torch.clamp(radix_tree.leaf_index(child, n_int), 0, n_leaves - 1)
        tri = tris[torch.where(child_is_leaf, li, 0)]
        ok, t, _ = shapes.triangle_t_v(t_max, origin, d, tri[:, 0].T,
                                       tri[:, 1].T, tri[:, 2].T)
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


# ---------------------------------------------------------------------------
# The custom ops: tmax (N,) and V3 rays (3, N). The CPU implementation is
# the plain version, the CUDA one the kernel; no device falls back.

_SCHEMA = ("(Tensor node_min, Tensor node_max, Tensor left, Tensor right, "
           "Tensor parent, Tensor tris, Tensor tmax, Tensor origin, "
           "Tensor d) -> ")


def _plain(name, args, any_hit):
    cuda_lib.plain(name)
    profiling.count("query.lanes." + name, args[-1].shape[1])
    return _traverse(*args, any_hit=any_hit)


def _launch(name, args, outs):
    """Launch kernel `name` on the op's operands, into outs."""
    node_min, node_max, left, right, parent, tris, tmax, origin, d = args
    n, dev = d.shape[1], d.device
    n_int, n_leaves = left.shape[0], tris.shape[0]
    i32, f32 = torch.int32, torch.float32
    ptrs = [cuda_lib.operand(x, dev, dtype, shape) for x, dtype, shape in (
        (node_min, f32, (n_int, 3)), (node_max, f32, (n_int, 3)),
        (left, i32, (n_int,)), (right, i32, (n_int,)),
        (parent, i32, (n_int,)), (tris, f32, (n_leaves, 3, 3)),
        (tmax, f32, (n,)), (origin, f32, (3, n)), (d, f32, (3, n)))]
    if n:
        cuda_lib.launch(name, dev, ptrs + list(outs),
                        [n, n_int, max_steps(n_int, n_leaves)])
        profiling.count("query.lanes." + name, n)
        profiling.count("query.tris." + name, n_leaves)
    return outs


@torch.library.custom_op("tracer_tpu_torch::lbvh_closest_hit",
                         mutates_args=(), device_types="cpu",
                         schema=_SCHEMA + "(Tensor, Tensor)")
def _closest_op(*args):
    leaf, t = _plain("lbvh_closest", args, False)
    return leaf, t


@_closest_op.register_fake
def _closest_fake(*args):
    d = args[-1]
    return (d.new_empty((d.shape[1],), dtype=torch.int64),
            d.new_empty((d.shape[1],)))


@_closest_op.register_kernel("cuda")
def _closest_cuda(*args):
    return _launch("lbvh_closest", args, _closest_fake(*args))


@torch.library.custom_op("tracer_tpu_torch::lbvh_any_hit", mutates_args=(),
                         device_types="cpu", schema=_SCHEMA + "Tensor")
def _any_op(*args):
    return _plain("lbvh_any", args, True)[0]


@_any_op.register_fake
def _any_fake(*args):
    d = args[-1]
    return d.new_empty((d.shape[1],), dtype=torch.bool)


@_any_op.register_kernel("cuda")
def _any_cuda(*args):
    return _launch("lbvh_any", args, (_any_fake(*args),))[0]


# ---------------------------------------------------------------------------
# What the scene calls

def op_args(bvh: LBVH, tmax, origin, d) -> tuple:
    """The operands of the two ops from a query's: the LBVH's buffers,
    tmax as (N,) f32 and the rays as contiguous (3, N) (an origin of
    (3, 1) is expanded)."""
    n = max(origin.shape[1], d.shape[1])
    dev = d.device
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev)
    return (*(getattr(bvh, k) for k in BUFFERS),
            tmax.expand(n).contiguous(), origin.expand(3, n).contiguous(),
            d.expand(3, n).contiguous())


def closest_hit(bvh: LBVH, tmax, origin, d, *, then=None):
    """Closest hit of V3 rays (3, N). Returns (ok, t, tri_idx (input
    index, -1 on a miss), pos (3, N), normal (3, N)); the winning leaf is
    intersected once more at the caller's tmax. Or, given then,
    then(leaf, tmax) of the walk's leaf (N,) int64, -1 on a miss, in
    place of that re-test (models/scene.closest_interaction)."""
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=d.device)
    leaf, _ = torch.ops.tracer_tpu_torch.lbvh_closest_hit(
        *op_args(bvh, tmax, origin, d))
    if then is not None:
        return then(leaf, tmax)
    ok0 = leaf >= 0
    li = torch.where(ok0, leaf, 0)
    tri = bvh.tris[li]
    ok, t, pos, normal = shapes.hit_triangle_v(tmax, origin, d, tri[:, 0].T,
                                               tri[:, 1].T, tri[:, 2].T)
    ok = ok & ok0
    return (ok, torch.where(ok, t, float("inf")),
            torch.where(ok, bvh.perm[li], -1), pos, normal)


def any_hit(bvh: LBVH, tmax, origin, d):
    """Shadow-ray query of V3 rays (3, N): any intersection before
    tmax."""
    return torch.ops.tracer_tpu_torch.lbvh_any_hit(
        *op_args(bvh, tmax, origin, d))
