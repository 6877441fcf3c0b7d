"""Voxelization on the device (counterpart of ``minddet_tpu/ops/
voxelize.py``): raw padded points -> either the padded voxels (B, V, P, F)
of ``voxelize_batch`` with ``decorate_pillar_features``, or a decorated
point stream sorted by pillar, with segment flags, for the stream PFN.

Batched over a leading sample axis (the reference vmaps one sample at a
time). Both voxelizers share one sort of the points by voxel id. The
segmented operations of the stream are the reference's distance-bounded
Hillis-Steele scans: ceil(log2(bound)) shift-and-combine levels, exact for
every row within ``bound`` rows of its segment head, which the voxelizer's
per-pillar point cap guarantees for every kept row. They run in the same
order as the reference's, so the sums agree to the last bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch


class VoxelizeOutput(NamedTuple):
    voxels: torch.Tensor      # (B, V, P, F), zero where empty
    num_points: torch.Tensor  # (B, V) int32
    coords: torch.Tensor      # (B, V, 3) int32 [gz, gy, gx], -1 = empty
    num_voxels: torch.Tensor  # (B,) int32


class StreamVoxels(NamedTuple):
    feats: torch.Tensor       # (B, N, F + 5) decorated, zero where ~keep
    keep: torch.Tensor        # (B, N) point kept (valid, slot/rank in caps)
    first: torch.Tensor       # (B, N) group-head flags (segment starts)
    last: torch.Tensor        # (B, N) each group's LAST KEPT row
    canvas_idx: torch.Tensor  # (B, N) int64, see voxelize_stream_batch
    num_voxels: torch.Tensor  # (B,) int32


def grid_size(point_cloud_range: Sequence[float],
              voxel_size: Sequence[float]) -> Tuple[int, int, int]:
    """(nx, ny, nz) from range and voxel size, rounded."""
    pcr = np.asarray(point_cloud_range, np.float64)
    vs = np.asarray(voxel_size, np.float64)
    g = np.round((pcr[3:] - pcr[:3]) / vs).astype(int)
    return int(g[0]), int(g[1]), int(g[2])


def _shift(x: torch.Tensor, d: int, dim: int, fill) -> torch.Tensor:
    """Shift ``x`` by ``d`` along ``dim`` (positive: toward higher index),
    filling the vacated rows with ``fill``."""
    n = x.shape[dim]
    pad_shape = list(x.shape)
    pad_shape[dim] = abs(d)
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if d > 0:
        return torch.cat([pad, x.narrow(dim, 0, n - d)], dim=dim)
    return torch.cat([x.narrow(dim, -d, n + d), pad], dim=dim)


def _seg_scan_bounded(comb: Callable, identity, first: torch.Tensor,
                      x: torch.Tensor, bound: int, dim: int = 1,
                      reverse: bool = False) -> torch.Tensor:
    """Segmented inclusive scan truncated at distance ``bound``: exact for
    every row within ``bound`` rows of its segment head (reverse: tail)."""
    f = first[..., None] if x.dim() == first.dim() + 1 else first
    v = x
    d = 1
    sgn = -1 if reverse else 1
    while d < bound:
        fs = _shift(f, sgn * d, dim, True)
        vs = _shift(v, sgn * d, dim, identity)
        v = torch.where(f, v, comb(vs, v))
        f = f | fs
        d *= 2
    return v


def _seg_bcast_bounded(sel: torch.Tensor, vals: torch.Tensor, bound: int,
                       dim: int = 1) -> torch.Tensor:
    """Broadcast each segment's value at its ``sel``-flagged row backward to
    the up to ``bound`` rows before it. Rows with no flagged row within
    ``bound`` ahead get garbage: callers mask them."""
    f = sel[..., None] if vals.dim() == sel.dim() + 1 else sel
    v = torch.where(f, vals, torch.zeros_like(vals))
    d = 1
    while d < bound:
        fs = _shift(f, -d, dim, False)
        vs = _shift(v, -d, dim, 0)
        v = torch.where(f, v, vs)
        f = f | fs
        d *= 2
    return v


def _seg_sum_bounded(first: torch.Tensor, x: torch.Tensor, bound: int,
                     dim: int = 1) -> torch.Tensor:
    """Bounded-distance segmented cumulative sum."""
    return _seg_scan_bounded(torch.add, 0, first, x, bound, dim)


def seg_running_max(first: torch.Tensor, x: torch.Tensor, bound: int,
                    dim: int = 1) -> torch.Tensor:
    """Segmented running max, reset where ``first``, exact for rows within
    ``bound`` of their segment head: at each segment's last kept row it is
    the whole segment's maximum. Autograd differentiates the shift levels:
    a tie shares the gradient half and half at each ``maximum``, as the
    reference's ``jnp.maximum`` levels do."""
    neg = (torch.finfo(x.dtype).min if x.is_floating_point()
           else torch.iinfo(x.dtype).min)
    return _seg_scan_bounded(torch.maximum, neg, first, x, bound, dim)


def _windowed_running_max(x: torch.Tensor, bound: int,
                          dim: int = 1) -> torch.Tensor:
    """Running max over (at least) the trailing ``bound`` elements."""
    v = x
    d = 1
    while d < bound:
        v = torch.maximum(v, _shift(v, d, dim, -1))
        d *= 2
    return v


def _heads(svid: torch.Tensor, big: int) -> torch.Tensor:
    """Group-head flags of a stream sorted by voxel id: a valid row whose
    id differs from the row before it."""
    ones = torch.ones_like(svid[:, :1], dtype=torch.bool)
    return torch.cat([ones, svid[:, 1:] != svid[:, :-1]], dim=1) & (
        svid < big)


def _sort_points(points: torch.Tensor, points_mask: torch.Tensor,
                 voxel_size: Sequence[float],
                 point_cloud_range: Sequence[float], drop_order: str):
    """The sorted point order of both voxelizers. Returns (svid, order,
    (sgx, sgy, sgz), big): each sorted row's voxel id (``big`` where the
    point is masked or out of range: those rows come last), the input row
    it holds and its grid indices.

    Points are stably sorted by voxel id; with ``drop_order``
    "first_come" the groups are then stably sorted by each group's first
    input row (the stable sort puts it at the group head), so they come in
    order of first appearance and each keeps its points in input order."""
    b, n, _ = points.shape
    dev = points.device
    # the reference's voxelizers run compiled, and XLA turns the divide by
    # the constant voxel size into a product with its f32 reciprocal: that
    # decides the cell of a point on a cell boundary
    inv = torch.from_numpy(np.float32(1) / np.asarray(voxel_size,
                                                      np.float32)).to(dev)
    pcr = torch.tensor(point_cloud_range, dtype=torch.float32, device=dev)
    nx, ny, nz = grid_size(point_cloud_range, voxel_size)

    g = torch.floor((points[..., :3] - pcr[:3]) * inv).to(torch.int32)
    gx, gy, gz = g.unbind(-1)
    in_range = ((gx >= 0) & (gx < nx) & (gy >= 0) & (gy < ny) & (gz >= 0)
                & (gz < nz) & points_mask.bool())
    big = nx * ny * nz + 1
    vid = torch.where(in_range, (gz * ny + gy) * nx + gx,
                      torch.full_like(gx, big))

    svid, order = torch.sort(vid, dim=1, stable=True)
    if drop_order == "sorted":
        safe = torch.clamp(svid, max=big - 1)
        sgx = safe % nx
        sgy = torch.div(safe, nx, rounding_mode="floor") % ny
        sgz = torch.div(safe, nx * ny, rounding_mode="floor")
        return svid, order, (sgx, sgy, sgz), big
    if drop_order != "first_come":
        raise ValueError(f"drop_order must be 'first_come' or 'sorted', "
                         f"got {drop_order!r}")
    pos = torch.arange(n, device=dev)
    head = torch.cummax(torch.where(_heads(svid, big), pos, -1),
                        dim=1).values
    firstidx = torch.gather(order, 1, head.clamp(min=0))
    firstidx = torch.where(svid < big, firstidx,
                           torch.full_like(firstidx, n))
    _, order2 = torch.sort(firstidx, dim=1, stable=True)
    order = torch.gather(order, 1, order2)
    svid = torch.gather(svid, 1, order2)
    return svid, order, tuple(torch.gather(c, 1, order)
                              for c in (gx, gy, gz)), big


def _slots(svid: torch.Tensor, big: int, max_voxels: int, max_points: int):
    """Per sorted row: (group-head flags, voxel slot, rank inside the
    voxel, kept). A row is kept where its point is valid, its slot is below
    ``max_voxels`` and its rank below ``max_points``."""
    b, n = svid.shape
    first = _heads(svid, big)
    slot = torch.cumsum(first.to(torch.int32), dim=1) - 1
    pos = torch.arange(n, dtype=torch.int32, device=svid.device).expand(b, n)
    # a row within max_points of its head sees the head's position; a row
    # further out sees -1 (no head in its window), so its rank is too large
    first_pos = _windowed_running_max(
        torch.where(first, pos, torch.full_like(pos, -1)), max_points)
    rank = pos - first_pos
    keep = (svid < big) & (slot < max_voxels) & (rank < max_points)
    return first, slot, rank, keep


def voxelize_batch(points: torch.Tensor, points_mask: torch.Tensor,
                   voxel_size: Sequence[float],
                   point_cloud_range: Sequence[float],
                   max_voxels: int = 16000,
                   max_points: int = 32) -> VoxelizeOutput:
    """Points (B, N, F) + mask (B, N) -> the padded voxels of each cloud:
    the reference's ``voxelize`` with the batch axis written out.

    Voxel slots follow first appearance in the input, each voxel keeps its
    first ``max_points`` points in input order, and voxels past
    ``max_voxels`` are dropped (the first-come sort of the stream
    voxelizer). Every dropped point goes to a sentinel slot and rank (the
    buffers have one more of each, sliced off), so each kept (slot, rank)
    pair is written once and only the sentinel more often; ``coords`` are
    written at the kept groups' heads only."""
    b, n, f = points.shape
    dev = points.device
    svid, order, (sgx, sgy, sgz), big = _sort_points(
        points, points_mask, voxel_size, point_cloud_range, "first_come")
    first, slot, rank, keep = _slots(svid, big, max_voxels, max_points)
    spoints = torch.gather(points, 1, order[..., None].expand(-1, -1, f))

    v1, p1 = max_voxels + 1, max_points + 1
    base = torch.arange(b, device=dev)[:, None] * v1
    slot_c = torch.where(keep, slot, max_voxels).long() + base
    rank_c = torch.where(keep, rank, max_points).long()
    voxels = torch.zeros(b * v1 * p1, f, dtype=points.dtype, device=dev)
    voxels.index_copy_(0, (slot_c * p1 + rank_c).reshape(-1),
                       spoints.reshape(b * n, f))
    counts = torch.zeros(b * v1, dtype=torch.int32, device=dev)
    counts.index_add_(0, slot_c.reshape(-1), keep.to(torch.int32).reshape(-1))
    heads = torch.where(first & keep, slot_c, base + max_voxels)
    coords = torch.full((b * v1, 3), -1, dtype=torch.int32, device=dev)
    coords.index_copy_(0, heads.reshape(-1),
                       torch.stack([sgz, sgy, sgx], -1).reshape(b * n, 3))
    num_voxels = torch.clamp(slot.max(dim=1).values + 1,
                             max=max_voxels).to(torch.int32)
    return VoxelizeOutput(
        voxels.view(b, v1, p1, f)[:, :max_voxels, :max_points],
        counts.view(b, v1)[:, :max_voxels],
        coords.view(b, v1, 3)[:, :max_voxels], num_voxels)


def voxelize_stream_batch(points: torch.Tensor, points_mask: torch.Tensor,
                          voxel_size: Sequence[float],
                          point_cloud_range: Sequence[float],
                          max_voxels: int = 16000, max_points: int = 32,
                          drop_order: str = "first_come") -> StreamVoxels:
    """Points (B, N, F) f32 + mask (B, N) -> the decorated point streams:
    the reference's ``voxelize_stream`` with the batch axis written out.

    Points are stably sorted by voxel id (in-range, valid points first);
    each voxel keeps its first ``max_points`` points in input order, and at
    most ``max_voxels`` voxels are kept: with ``drop_order`` "first_come"
    the first to appear in the input (the reference contract; a second
    stable sort by each group's first index), with "sorted" the lowest cell
    ids (one sort). ``feats`` are the points with the cluster offsets (xyz
    minus the mean of the kept points of the pillar) and the xy offsets
    from the pillar's centre, zero where not kept.

    ``canvas_idx`` is the pillar's BEV cell gy * nx + gx: with "sorted" on
    every valid row (nondecreasing, ny * nx on the invalid tail), with
    "first_come" only at each group's last kept row (ny * nx elsewhere).
    At ``last`` it is the pillar's cell in both.
    """
    b, n, f = points.shape
    dev = points.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    pcr = torch.tensor(point_cloud_range, dtype=torch.float32, device=dev)
    nx, ny, _ = grid_size(point_cloud_range, voxel_size)

    svid, order, (sgx, sgy, _), big = _sort_points(
        points, points_mask, voxel_size, point_cloud_range, drop_order)
    spoints = torch.gather(points, 1, order[..., None].expand(-1, -1, f))
    first, slot, rank, keep = _slots(svid, big, max_voxels, max_points)

    ends = torch.cat([svid[:, 1:] != svid[:, :-1],
                      torch.ones_like(first[:, :1])], dim=1)
    last = keep & (ends | (rank == max_points - 1))

    kf = keep.to(torch.float32)
    xyz = spoints[..., :3] * kf[..., None]
    total_xyz = _seg_bcast_bounded(
        last, _seg_sum_bounded(first, xyz, max_points), max_points)
    count = torch.clamp(_seg_bcast_bounded(
        last, _seg_sum_bounded(first, kf, max_points), max_points), min=1.0)
    cluster = spoints[..., :3] - total_xyz / count[..., None]
    cx = sgx.to(torch.float32) * vs[0] + (vs[0] / 2 + pcr[0])
    cy = sgy.to(torch.float32) * vs[1] + (vs[1] / 2 + pcr[1])
    center = spoints[..., :2] - torch.stack([cx, cy], dim=-1)
    feats = torch.cat([spoints, cluster, center], dim=-1) * kf[..., None]

    lin = (sgy * nx + sgx).long()
    sentinel = torch.full_like(lin, ny * nx)
    canvas_idx = torch.where(svid < big if drop_order == "sorted" else last,
                             lin, sentinel)
    num_voxels = torch.clamp(slot.max(dim=1).values + 1,
                             max=max_voxels).to(torch.int32)
    return StreamVoxels(feats, keep, first, last, canvas_idx, num_voxels)


def decorate_pillar_features(voxels: torch.Tensor, num_points: torch.Tensor,
                             coords: torch.Tensor,
                             voxel_size: Sequence[float],
                             point_cloud_range: Sequence[float]
                             ) -> torch.Tensor:
    """Padded voxels (B, V, P, F) -> (B, V, P, F + 5): each point, its
    offsets from the mean of its pillar's kept points (xyz) and from the
    pillar's centre (xy only, as the reference's PFN input), zero at the
    empty point slots. ``coords`` are (B, V, 3) [gz, gy, gx]."""
    p = voxels.shape[2]
    dev = voxels.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    pcr = torch.tensor(point_cloud_range, dtype=torch.float32, device=dev)
    npts = torch.clamp(num_points, min=1).to(torch.float32)[..., None, None]
    mean = voxels[..., :3].sum(dim=2, keepdim=True) / npts
    cluster = voxels[..., :3] - mean
    centers = torch.stack(
        [coords[..., 2].to(torch.float32) * vs[0] + (vs[0] / 2 + pcr[0]),
         coords[..., 1].to(torch.float32) * vs[1] + (vs[1] / 2 + pcr[1])],
        dim=-1)
    center = voxels[..., :2] - centers[:, :, None, :]
    out = torch.cat([voxels, cluster, center], dim=-1)
    mask = torch.arange(p, device=dev) < num_points[..., None]
    return out * mask[..., None].to(out.dtype)


def voxel_cell_rows(coords: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """Voxel coords (B, V, 3) [gz, gy, gx] -> each voxel's row of a flat
    (B * ny * nx + 1)-row canvas, b * ny * nx + gy * nx + gx, the empty
    slots (coords -1) all the last row: (B, V) int64."""
    cells = ny * nx
    base = torch.arange(coords.shape[0], device=coords.device)[:, None] \
        * cells
    return torch.where(coords[..., 0] >= 0,
                       (coords[..., 1] * nx + coords[..., 2]).long() + base,
                       torch.full_like(base, coords.shape[0] * cells))


def scatter_stream_canvas(h: torch.Tensor, sv: StreamVoxels, ny: int, nx: int,
                          occupancy: bool = False):
    """The stream PFN's output ``h`` (B, N, C) -> the BEV canvas (B, C, ny,
    nx) in ``channels_last`` memory: one ``index_copy_`` of each pillar's
    last kept row into B * ny * nx + 1 rows, the last row taking every
    other one. With ``occupancy`` also the (B, ny, nx) f32 0/1 map of the
    cells that hold a pillar, from the same indices; else None.

    Differentiable with respect to ``h``: the backward of ``index_copy_``
    is a gather, so each pillar's last kept row receives its cell's
    gradient and every other row (they all went to the last row, which is
    sliced off) none."""
    b, n, c = h.shape
    cells = ny * nx
    base = torch.arange(b, device=h.device)[:, None] * cells
    rows = torch.where(sv.last, sv.canvas_idx + base,
                       torch.full_like(sv.canvas_idx, b * cells)).reshape(-1)
    flat = torch.zeros(b * cells + 1, c, dtype=h.dtype, device=h.device)
    flat.index_copy_(0, rows, h.reshape(b * n, c))
    canvas = flat[:b * cells].view(b, ny, nx, c).permute(0, 3, 1, 2)
    if not occupancy:
        return canvas, None
    occ = torch.zeros(b * cells + 1, dtype=torch.float32, device=h.device)
    occ.index_fill_(0, rows, 1.0)
    return canvas, occ[:b * cells].view(b, ny, nx)
