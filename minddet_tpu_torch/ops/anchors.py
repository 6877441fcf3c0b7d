"""3D anchor grids and the BEV-occupancy anchor mask (counterpart of the
parts of ``minddet_tpu/ops/anchors.py`` the PointPillars predict path uses:
``create_anchors_3d_stride``, ``ClassAnchorConfig``, ``generate_anchors``
and ``make_grid_area_mask``).

The anchor grids are numpy, computed once per configuration, as in the
reference. The mask is computed on the device from the occupancy map.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def create_anchors_3d_stride(
    feature_size: Tuple[int, int],
    sizes: Sequence[float] = (1.6, 3.9, 1.56),
    anchor_strides: Sequence[float] = (0.4, 0.4, 0.0),
    anchor_offsets: Sequence[float] = (0.2, -39.8, -1.78),
    rotations: Sequence[float] = (0.0, float(np.pi / 2)),
) -> np.ndarray:
    """Strided anchor grid -> (ny, nx, n_size, n_rot, 7) float32 [x, y, z,
    w, l, h, yaw], centres at offset + index * stride."""
    ny, nx = feature_size
    sizes = np.asarray(sizes, np.float32).reshape(-1, 3)
    rotations = np.asarray(rotations, np.float32)
    xs = anchor_offsets[0] + np.arange(nx, dtype=np.float32) * anchor_strides[0]
    ys = anchor_offsets[1] + np.arange(ny, dtype=np.float32) * anchor_strides[1]
    out = np.zeros((ny, nx, sizes.shape[0], rotations.shape[0], 7),
                   np.float32)
    out[..., 0] = xs[None, :, None, None]
    out[..., 1] = ys[:, None, None, None]
    out[..., 2] = np.float32(anchor_offsets[2])
    out[..., 3:6] = sizes[None, None, :, None, :]
    out[..., 6] = rotations[None, None, None, :]
    return out


class ClassAnchorConfig(NamedTuple):
    """Per-class anchor spec."""

    name: str
    sizes: Tuple[float, ...]
    strides: Tuple[float, ...]
    offsets: Tuple[float, ...]
    rotations: Tuple[float, ...] = (0.0, float(np.pi / 2))
    matched_threshold: float = 0.6
    unmatched_threshold: float = 0.45


def generate_anchors(feature_size: Tuple[int, int],
                     configs: Sequence[ClassAnchorConfig]
                     ) -> Dict[str, np.ndarray]:
    """Per-class anchor grids concatenated per cell: anchors (A, 7) and the
    per-anchor matched/unmatched thresholds (A,)."""
    all_anchors, m_th, u_th = [], [], []
    for cfg in configs:
        a = create_anchors_3d_stride(
            feature_size, cfg.sizes, cfg.strides, cfg.offsets, cfg.rotations
        ).reshape(feature_size[0], feature_size[1], -1, 7)
        shape = a.shape[:3]
        all_anchors.append(a)
        m_th.append(np.full(shape, cfg.matched_threshold, np.float32))
        u_th.append(np.full(shape, cfg.unmatched_threshold, np.float32))
    return {
        "anchors": np.concatenate(all_anchors, axis=2).reshape(-1, 7),
        "matched_threshold": np.concatenate(m_th, axis=2).reshape(-1),
        "unmatched_threshold": np.concatenate(u_th, axis=2).reshape(-1),
    }


def make_grid_area_mask(
    grid_shape: Tuple[int, int],
    voxel_size: Sequence[float],
    pc_range: Sequence[float],
    feature_size: Tuple[int, int],
    configs: Sequence[ClassAnchorConfig],
    area_threshold: float = 1.0,
) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The anchor-area mask for a regular strided anchor grid: an anchor is
    kept when more than ``area_threshold`` occupied BEV cells lie under its
    footprint.

    Each (class, size, rotation) combination's footprint query is one
    strided box filter, as cumulative sums along each axis and strided
    differences. Returns ``from_occ(occ (B, ny, nx)) -> (B, A) bool`` in
    ``generate_anchors`` order, or None when the layout does not qualify
    (a stride that is not a whole number of cells, rotations other than 0
    and pi/2). Cells outside the grid count as empty.
    """
    ny, nx = grid_shape
    fny, fnx = feature_size
    vx, vy = float(voxel_size[0]), float(voxel_size[1])
    ox, oy = float(pc_range[0]), float(pc_range[1])

    combos = []  # (ky, kx, wh, ww, y0, x0) per anchor cell
    for cfg in configs:
        sx, sy = float(cfg.strides[0]), float(cfg.strides[1])
        kx, ky = sx / vx, sy / vy
        if abs(kx - round(kx)) > 1e-6 or abs(ky - round(ky)) > 1e-6:
            return None
        kx, ky = int(round(kx)), int(round(ky))
        for s in np.asarray(cfg.sizes, np.float32).reshape(-1, 3):
            w, l = float(s[0]), float(s[1])
            for rot in cfg.rotations:
                r = abs(float(rot)) % np.pi
                if min(r, np.pi - r) > 1e-6 and abs(r - np.pi / 2) > 1e-6:
                    return None
                ex, ey = (l, w) if abs(r - np.pi / 2) <= 1e-6 else (w, l)
                # floors nudged by eps: footprints of the stock configs
                # sit exactly on cell boundaries
                eps = 1e-3
                x1 = int(np.floor((cfg.offsets[0] - ex / 2 - ox) / vx + eps))
                y1 = int(np.floor((cfg.offsets[1] - ey / 2 - oy) / vy + eps))
                x2 = int(np.floor((cfg.offsets[0] + ex / 2 - ox) / vx + eps))
                y2 = int(np.floor((cfg.offsets[1] + ey / 2 - oy) / vy + eps))
                combos.append((ky, kx, y2 - y1 + 1, x2 - x1 + 1, y1, x1))

    pad_t = max(0, max(-c[4] for c in combos))
    pad_l = max(0, max(-c[5] for c in combos))
    pad_b = max(0, max(c[4] + c[2] + (fny - 1) * c[0] - ny for c in combos))
    pad_r = max(0, max(c[5] + c[3] + (fnx - 1) * c[1] - nx for c in combos))

    def from_occ(occ: torch.Tensor) -> torch.Tensor:
        occ = F.pad(occ.float(), (pad_l, pad_r, pad_t, pad_b))
        cx = F.pad(torch.cumsum(occ, dim=-1), (1, 0))
        masks = []
        for ky, kx, wh, ww, y0, x0 in combos:
            c_lo = pad_l + x0
            rowsum = (cx[..., c_lo + ww:c_lo + ww + kx * (fnx - 1) + 1:kx]
                      - cx[..., c_lo:c_lo + kx * (fnx - 1) + 1:kx])
            cy = F.pad(torch.cumsum(rowsum, dim=-2), (0, 0, 1, 0))
            r_lo = pad_t + y0
            area = (cy[..., r_lo + wh:r_lo + wh + ky * (fny - 1) + 1:ky, :]
                    - cy[..., r_lo:r_lo + ky * (fny - 1) + 1:ky, :])
            masks.append(area > area_threshold)
        return torch.stack(masks, dim=-1).flatten(-3)

    return from_occ
