"""The closest hit's surface interaction (models/scene.closest_interaction
after its query) as one hand-written CUDA kernel, K16
(csrc/interaction.cu), and its plain version.

From the closest-hit query's answer, each lane tests the winning triangle
again exactly (ops/shapes.hit_triangle_v: t, position and normal), takes
its material id and evaluates that material's row at the lane's hero
wavelength (ops/materials.at_wavelength_rows: the colour and emission
knots, the dispersion of ref_ix). The query's answer says which accel
asked:
  the dense accel  (best_t, best_i) of the kernel wrapper
                   (ops/intersect.closest_hit_phi, after a sorted query's
                   scatter back); the rows (T, 10) of DenseTris.tris, whose
                   column 9 is the material id; the re-test at tmax x (1 +
                   REINTERSECT_SLACK)
  the LBVH         the leaf of its walk (ops/bvh, K14 on the card); its
                   leaves (n, 3, 3), perm and the scene's tri_mat; the
                   re-test at tmax, the material id tri_mat[perm[leaf]]
A lane the query missed tests triangle 0, whose position and normal it
returns, and takes material 0 (dense) or tri_mat[0] (LBVH), as the code
before the kernel did.

The kernel replaces no TPU kernel: the JAX package leaves this to XLA,
which fuses it. PyTorch ran it eagerly as ~250 elementwise ops and
gathers a bounce, many of them on strided views of the gathered rows.

Dispatch: dense() and lbvh() call the torch.library custom op
tracer_tpu_torch::interaction, whose CPU implementation is the plain
version (_plain: bit for bit what closest_interaction gave before the
kernel) and whose CUDA implementation launches K16 or raises. Rays,
tmax and wavelengths may come strided or broadcast; the kernel takes
their strides. The outputs are contiguous: ok, t, pos (3, N), normal
(3, N) and the (6, N) rows color, roughness, metalness, ref_ix, opacity,
emission. The fake rule gives torch.export the output shapes, so the
exported step (utils/aot.py) holds the op. The kernel keeps the plain
version's f32 operations, their order and rounding (csrc/torch_f32.cuh),
so every output equals the plain version's bit for bit. Each launch
adds its lanes to the counter interaction.lanes (utils/profiling).
"""

from __future__ import annotations

import struct

import torch

from tracer_tpu_torch.ops import cuda_lib, intersect, materials, shapes
from tracer_tpu_torch.utils import profiling

# The kernel's name in cuda_lib's counts.
KERNELS = ("interaction",)

# Rows of the op's (6, N) material output.
MAT_ROWS = ("color", "roughness", "metalness", "ref_ix", "opacity",
            "emission")

# The dense re-test's tmax scale, as the f32 its PyTorch product uses,
# handed to the kernel as its bits.
_SLACK_BITS = struct.unpack(
    "<I", struct.pack("<f", 1.0 + intersect.REINTERSECT_SLACK))[0]


# ---------------------------------------------------------------------------
# The plain version

def _plain(tris, perm, tri_mat, mat_rows, tmax, origin, d, wavelen, best_t,
           best_i, leaf):
    if leaf is None:   # the dense accel: intersect.closest_hit's re-test
        ok = torch.isfinite(best_t)
        best_i = torch.where(ok, best_i, 0)
        slack = 1.0 + intersect.REINTERSECT_SLACK
        ok2, t, pos, normal, aux = intersect._reintersect(
            tris, best_i, origin, d, tmax * slack)
        ok = ok & ok2
        t = torch.where(ok, t, float("inf"))
        lane_mat = torch.where(ok, aux, 0.0).long()
    else:              # the LBVH: bvh.closest_hit's re-test
        ok0 = leaf >= 0
        li = torch.where(ok0, leaf, 0)
        tri = tris[li]
        ok, t, pos, normal = shapes.hit_triangle_v(
            tmax, origin, d, tri[:, 0].T, tri[:, 1].T, tri[:, 2].T)
        ok = ok & ok0
        t = torch.where(ok, t, float("inf"))
        tri_idx = torch.where(ok, perm[li], -1)
        lane_mat = tri_mat[torch.where(ok, tri_idx, 0).long()].long()
    mat, emission = materials.at_wavelength_rows(mat_rows[lane_mat].T,
                                                 wavelen)
    return (ok, t, pos.contiguous(), normal.contiguous(),
            torch.stack([*mat, emission]))


# ---------------------------------------------------------------------------
# The custom op. The CPU implementation is the plain version, the CUDA one
# the kernel; no device falls back.

_SCHEMA = ("(Tensor tris, Tensor? perm, Tensor? tri_mat, Tensor mat_rows, "
           "Tensor tmax, Tensor origin, Tensor d, Tensor wavelen, "
           "Tensor? best_t, Tensor? best_i, Tensor? leaf) -> (Tensor, "
           "Tensor, Tensor, Tensor, Tensor)")


@torch.library.custom_op("tracer_tpu_torch::interaction", mutates_args=(),
                         device_types="cpu", schema=_SCHEMA)
def _interaction_op(*args):
    cuda_lib.plain("interaction")
    return _plain(*args)


@_interaction_op.register_fake
def _interaction_fake(tris, perm, tri_mat, mat_rows, tmax, origin, d, *_):
    n = d.shape[1]

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=d.device)

    return (new(n, dtype=torch.bool), new(n), new(3, n), new(3, n),
            new(len(MAT_ROWS), n))


@_interaction_op.register_kernel("cuda")
def _interaction_cuda(tris, perm, tri_mat, mat_rows, tmax, origin, d,
                      wavelen, best_t, best_i, leaf):
    n, dev = d.shape[1], d.device
    f32, i32 = torch.float32, torch.int32
    lbvh = leaf is not None
    given = [x is not None for x in (perm, tri_mat, best_t, best_i)]
    if given != [lbvh, lbvh, not lbvh, not lbvh]:
        raise ValueError("interaction takes best_t and best_i (the dense "
                         "accel) or leaf, perm and tri_mat (the LBVH)")
    t_rows = tris.shape[0]
    outs = _interaction_fake(tris, perm, tri_mat, mat_rows, tmax, origin, d)
    ptrs = [cuda_lib.operand(tris, dev, f32,
                             (t_rows, 3, 3) if lbvh else (t_rows, 10))]
    ptrs += ([cuda_lib.operand(perm, dev, i32, (t_rows,)),
              cuda_lib.operand(tri_mat, dev, i32, (tri_mat.shape[0],))]
             if lbvh else [None, None])
    ptrs.append(cuda_lib.operand(mat_rows, dev, f32,
                                 (mat_rows.shape[0], 28)))
    ints = [n]
    for x in (tmax, wavelen):
        ptrs.append(cuda_lib.operand(x, dev, f32, (n,), strided=True))
        ints += x.stride()
    for x in (origin, d):
        ptrs.append(cuda_lib.operand(x, dev, f32, (3, n), strided=True))
        ints += x.stride()
    if lbvh:
        ptrs += [None, None, cuda_lib.operand(leaf, dev, torch.int64, (n,))]
    else:
        ptrs += [cuda_lib.operand(best_t, dev, f32, (n,)),
                 cuda_lib.operand(best_i, dev, i32, (n,)), None]
    ints.append(_SLACK_BITS)
    cuda_lib.launch("interaction", dev, ptrs + list(outs), ints)
    profiling.count("interaction.lanes", n)
    return outs


# ---------------------------------------------------------------------------
# What the scene calls

def _lanes(tmax, origin, d, wavelen) -> tuple:
    """tmax and wavelen as (N,), the rays as (3, N): broadcast views, no
    copy."""
    n = max(origin.shape[1], d.shape[1])
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=d.device)
    return (tmax.expand(n), origin.expand(3, n), d.expand(3, n),
            wavelen.expand(n))


def dense_args(dense, mat_rows, tmax, origin, d, wavelen, best_t,
               best_i) -> tuple:
    """The operands of the op tracer_tpu_torch::interaction, in its
    schema's order, after the dense accel's query."""
    return (dense.tris, None, None, mat_rows,
            *_lanes(tmax, origin, d, wavelen), best_t, best_i, None)


def lbvh_args(bvh, tri_mat, mat_rows, tmax, origin, d, wavelen,
              leaf) -> tuple:
    """The operands of the op tracer_tpu_torch::interaction, in its
    schema's order, after the LBVH's walk."""
    return (bvh.tris, bvh.perm, tri_mat, mat_rows,
            *_lanes(tmax, origin, d, wavelen), None, None, leaf)


def dense(dense, mat_rows, tmax, origin, d, wavelen, best_t, best_i):
    """The op on the answer (best_t, best_i) of a DenseTris's closest-hit
    query of the rays origin, d (3, N) below tmax; mat_rows the scene's
    (M, 28) material rows, wavelen the lanes' hero wavelengths (N,).
    Returns (ok (N,), t (N,), pos (3, N), normal (3, N), mat (6, N): the
    rows of MAT_ROWS)."""
    return torch.ops.tracer_tpu_torch.interaction(*dense_args(
        dense, mat_rows, tmax, origin, d, wavelen, best_t, best_i))


def lbvh(bvh, tri_mat, mat_rows, tmax, origin, d, wavelen, leaf):
    """The op on the leaf (N,) an LBVH's closest-hit walk returned, with
    the scene's tri_mat (T,); otherwise as dense()."""
    return torch.ops.tracer_tpu_torch.interaction(*lbvh_args(
        bvh, tri_mat, mat_rows, tmax, origin, d, wavelen, leaf))
