"""Rotated-box BEV intersection and IoU (counterpart of
``minddet_tpu/ops/rotated_iou.py``: ``rotated_intersection_bev``,
``rotated_iou_bev``).

Boxes are [x, y, w, l, yaw]. ``rotated_intersection_bev`` maps (N, 5) x
(M, 5), or a batch (B, N, 5) x (B, M, 5), to the f32 intersection areas
(N, M) or (B, N, M). On a CUDA tensor it launches ``csrc/rotated_iou.cu``,
the port of the TPU kernel ``rotated_iou_pallas.py:_intersect_kernel``; on
a CPU tensor it runs the plain version ``rotated_intersection_bev_plain``.

The plain version is the kernel's own algorithm, vectorised over the pair
axes: Sutherland-Hodgman clips quad A against the four half-planes of quad
B into an 8-slot polygon ("append at cnt" as 8 selects), then the shoelace
area. It holds a few dozen (rows, M) tensors, O(N*M*16) memory in all,
where the reference's XLA angular-successor form needs (N, M, 24, 24); the
rows go in chunks so the CPU stays bounded.

Both work in pair-relative coordinates: A's centre is the origin, so B's
corners are (x_B - x_A) + B's corner offsets. That is the same geometry as
the TPU kernel's absolute coordinates, with rounding errors that scale
with the boxes' size instead of their distance from the sensor (KITTI
centres reach 70 m, where an absolute-coordinate shoelace loses ~1e-3 of
area). The inside tests keep the TPU kernel's tolerance.
"""

from __future__ import annotations

import torch

from minddet_tpu_torch.kernels import ROTATED_IOU, cuda_stream
from minddet_tpu_torch.ops.box import rect_corner_offsets

EPS = 1e-8          # |den| guard of the clip-line intersection, IoU floor
INSIDE_EPS = 1e-6   # a vertex with side >= -INSIDE_EPS is inside an edge
MAX_VERTICES = 8    # rect ∩ rect has at most 8 vertices


def _clip_area(ax, ay, bx, by):
    """Sutherland-Hodgman of quad A against quad B, both as 4 CCW corners
    [(x, y)] of broadcastable tensors -> intersection area."""
    zero = torch.zeros(torch.broadcast_shapes(ax[0].shape, bx[0].shape),
                       dtype=ax[0].dtype, device=ax[0].device)
    px = [zero + x for x in ax] + [zero] * 4
    py = [zero + y for y in ay] + [zero] * 4
    cnt = torch.full_like(zero, 4, dtype=torch.int32)
    for e in range(4):  # clip against edge e of B (CCW: inside = side >= 0)
        ex0, ey0 = bx[e], by[e]
        dx, dy = bx[(e + 1) % 4] - ex0, by[(e + 1) % 4] - ey0
        sides = [dx * (py[k] - ey0) - dy * (px[k] - ex0)
                 for k in range(MAX_VERTICES)]
        nx = [zero] * MAX_VERTICES
        ny = [zero] * MAX_VERTICES
        ncnt = torch.zeros_like(cnt)
        for k in range(MAX_VERTICES):
            kn = (k + 1) % MAX_VERTICES
            active = cnt > k
            wrap = cnt == k + 1
            qx, qy = px[k], py[k]
            rx = torch.where(wrap, px[0], px[kn])
            ry = torch.where(wrap, py[0], py[kn])
            s_cur = sides[k]
            s_nxt = torch.where(wrap, sides[0], sides[kn])
            in_cur = s_cur >= -INSIDE_EPS
            in_nxt = s_nxt >= -INSIDE_EPS
            den = s_cur - s_nxt
            t = s_cur / torch.where(den.abs() < EPS, torch.ones_like(den),
                                    den)
            ix = qx + t * (rx - qx)
            iy = qy + t * (ry - qy)
            for emit, vx, vy in ((active & in_cur, qx, qy),
                                 (active & (in_cur != in_nxt), ix, iy)):
                for s in range(MAX_VERTICES):
                    hit = emit & (ncnt == s)
                    nx[s] = torch.where(hit, vx, nx[s])
                    ny[s] = torch.where(hit, vy, ny[s])
                ncnt = ncnt + emit.to(torch.int32)
        px, py, cnt = nx, ny, ncnt
    area = zero
    for k in range(MAX_VERTICES):
        kn = (k + 1) % MAX_VERTICES
        wrap = cnt == k + 1
        rx = torch.where(wrap, px[0], px[kn])
        ry = torch.where(wrap, py[0], py[kn])
        area = area + torch.where(cnt > k, px[k] * ry - rx * py[k], zero)
    return torch.where(cnt >= 3, torch.clamp(0.5 * area, min=0.0), zero)


def _intersection_rows(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """(..., n, 5) x (..., M, 5) -> (..., n, M), pair-relative."""
    a = b1[..., :, None, :]
    b = b2[..., None, :, :]
    rel_x = b[..., 0] - a[..., 0]
    rel_y = b[..., 1] - a[..., 1]
    ca = rect_corner_offsets(a[..., 2], a[..., 3], a[..., 4])
    cb = rect_corner_offsets(b[..., 2], b[..., 3], b[..., 4])
    return _clip_area([x for x, _ in ca], [y for _, y in ca],
                      [rel_x + x for x, _ in cb], [rel_y + y for _, y in cb])


def rotated_intersection_bev_plain(boxes1: torch.Tensor,
                                   boxes2: torch.Tensor,
                                   row_chunk: int = 256) -> torch.Tensor:
    """Plain PyTorch version of the K4 kernel, on any device: (..., N, 5) x
    (..., M, 5) f32 -> (..., N, M) f32 areas, ``row_chunk`` rows at a
    time."""
    b1 = boxes1.float()
    b2 = boxes2.float()
    n = b1.shape[-2]
    return torch.cat([_intersection_rows(b1[..., i:i + row_chunk, :], b2)
                      for i in range(0, n, row_chunk)], dim=-2)


def _check(b1: torch.Tensor, b2: torch.Tensor) -> None:
    if b1.dim() != 3 or b2.dim() != 3 or b1.shape[-1] != 5 \
            or b2.shape[-1] != 5 or b1.shape[0] != b2.shape[0]:
        raise ValueError(f"expected (B, N, 5) and (B, M, 5); got "
                         f"{tuple(b1.shape)} and {tuple(b2.shape)}")
    for name, t in (("boxes1", b1), ("boxes2", b2)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b1.device != b2.device:
        raise ValueError(f"boxes1 on {b1.device}, boxes2 on {b2.device}")
    b, n, m = b1.shape[0], b1.shape[1], b2.shape[1]
    if b > 65535 or b * n * m >= 2 ** 31:
        raise ValueError(f"(B, N, M) = {(b, n, m)} is too large for the "
                         "kernel's grid and 32-bit offsets")


def _intersection_cuda(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    _check(b1, b2)
    b, n, m = b1.shape[0], b1.shape[1], b2.shape[1]
    out = torch.empty(b, n, m, dtype=torch.float32, device=b1.device)
    if out.numel() == 0:
        return out
    fn = ROTATED_IOU.fn()
    ROTATED_IOU.launches += 1
    err = fn(b1.data_ptr(), b2.data_ptr(), out.data_ptr(), b, n, m,
             cuda_stream(b1.device))
    ROTATED_IOU.check(err)
    return out


def rotated_intersection_bev(boxes1: torch.Tensor, boxes2: torch.Tensor
                             ) -> torch.Tensor:
    """Pairwise intersection areas, (N, 5) x (M, 5) -> (N, M) or (B, N, 5)
    x (B, M, 5) -> (B, N, M), f32. CUDA tensors launch the
    ``rotated_iou_intersect`` kernel once (f32, contiguous) and raise on
    what it does not take; CPU tensors run the plain version."""
    if boxes1.device.type == "cuda":
        if boxes1.dim() == 2:
            return _intersection_cuda(boxes1[None], boxes2[None])[0]
        return _intersection_cuda(boxes1, boxes2)
    if boxes1.device.type != "cpu":
        raise ValueError(f"unsupported device {boxes1.device}")
    return rotated_intersection_bev_plain(boxes1, boxes2)


def rotated_iou_bev(boxes1: torch.Tensor, boxes2: torch.Tensor,
                    criterion: int = -1) -> torch.Tensor:
    """Pairwise rotated BEV IoU, shapes as ``rotated_intersection_bev``.
    ``criterion`` as the KITTI evaluator's: -1 intersection over union, 0
    over area(box1), 1 over area(box2)."""
    inter = rotated_intersection_bev(boxes1, boxes2)
    area1 = (boxes1[..., 2] * boxes1[..., 3])[..., :, None]
    area2 = (boxes2[..., 2] * boxes2[..., 3])[..., None, :]
    if criterion == -1:
        denom = area1 + area2 - inter
    elif criterion == 0:
        denom = area1.expand_as(inter)
    elif criterion == 1:
        denom = area2.expand_as(inter)
    else:
        raise ValueError(f"criterion must be -1/0/1, got {criterion}")
    return inter / torch.clamp(denom, min=EPS)
