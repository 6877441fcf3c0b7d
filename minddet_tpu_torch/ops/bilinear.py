"""Batched weighted row gather and the bilinear sampling built on it
(counterpart of ``minddet_tpu/ops/bilinear.py``: ``bilinear_gather``,
``bilinear_sample_2d``).

    out[b, p, :] = sum_{c < 4} cw[b, p, c] * x[b, ci[b, p, c], :]

with x (B, HW, C), ci (B, P, 4) int32 row indices and cw (B, P, 4) f32
weights. A corner with ``ci < 0`` is skipped whatever its weight; an index
past the last row reads the last row (the reference's clipped gather). The
sum is taken in f32 and rounded once to x's type.

``bilinear_gather`` is differentiable with respect to ``x`` and ``cw``
through a ``torch.autograd.Function``, and ``bilinear_sample_2d`` with
respect to the map and, through the weights, the coordinates:

    dx[b, q, :]  = sum_{p, c: ci[b, p, c] = q} cw[b, p, c] * g[b, p, :]
    dcw[b, p, c] = <g[b, p, :], x[b, ci[b, p, c], :]>

with skipped corners (``ci < 0``) adding nothing to dx and getting a zero
dcw. dx is summed in f32 and rounded once to x's type.

On a CUDA tensor ``bilinear_gather`` launches ``csrc/bilinear_gather.cu``,
the port of the TPU kernel ``bilinear.py:_fwd_kernel``, and in the backward
``csrc/bilinear_gather_bwd_dx.cu`` (``_bwd_dx_kernel``) for a map that needs
a gradient and ``csrc/bilinear_gather_bwd_dcw.cu`` (``_bwd_dcw_kernel``) for
weights that do; on a CPU tensor it runs the plain versions
``bilinear_gather_plain``, ``bilinear_gather_bwd_dx_plain`` and
``bilinear_gather_bwd_dcw_plain``, the reference's XLA forms. The kernels
move 16-byte vectors (4 f32 or 8 bf16 channels); for any other C the
wrappers zero-pad the channel axis to a whole number of vectors
(``pad_channels``) before the launch and slice the padding off the
result. Zero channels add nothing to a row, a dot or a gradient, so the
result is the unpadded one.

``bilinear_warp_affine`` is the inverse-affine warp of a (B, H, W, C) map
to (B, OH, OW, C), every output pixel (x, y) sampled at A_b (x, y, 1):
``bilinear_sample_2d`` at ``affine_points``, with no gradient. On a CUDA
tensor it launches ``csrc/bilinear_warp.cu``, which maps each pixel and
finds its corners in registers and reads the unpadded channels (no corners
tensor, no pad, no slice); on a CPU tensor it runs
``bilinear_warp_affine_plain``, the route through the corners and the
plain gather.
"""

from __future__ import annotations

import torch

from typing import Tuple

from minddet_tpu_torch.kernels import (BILINEAR_GATHER_BWD_DCW,
                                       BILINEAR_GATHER_BWD_DX,
                                       BILINEAR_GATHER_FWD,
                                       BILINEAR_WARP_AFFINE_FWD, cuda_stream,
                                       device_kind)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # values per 16-byte vector
_INT32_MAX = 2 ** 31 - 1


def bilinear_gather_plain(x: torch.Tensor, ci: torch.Tensor,
                          cw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the K3f kernel, on any device: gather the
    four (clipped) rows, weight them (zero where ``ci < 0``), sum in f32
    (or x's type where that is wider), round once."""
    b, p, _ = ci.shape
    hw, ch = x.shape[1], x.shape[2]
    acc = torch.promote_types(x.dtype, torch.float32)
    idx = ci.clamp(0, hw - 1).long().reshape(b, p * 4, 1).expand(-1, -1, ch)
    rows = torch.gather(x, 1, idx).reshape(b, p, 4, ch).to(acc)
    w = (cw * (ci >= 0)).to(acc)
    return (rows * w[..., None]).sum(dim=2).to(x.dtype)


def _clipped_rows(ci: torch.Tensor, hw: int) -> torch.Tensor:
    """(B, P, 4) indices -> (B, P * 4) int64 rows, clipped into [0, hw)."""
    return ci.clamp(0, hw - 1).long().reshape(ci.shape[0], -1)


def bilinear_gather_bwd_dx_plain(g: torch.Tensor, ci: torch.Tensor,
                                 cw: torch.Tensor, hw: int) -> torch.Tensor:
    """Plain PyTorch version of the K3dx kernel, on any device: g (B, P, C)
    -> dx (B, hw, C) in g's type. Each corner's ``cw * g`` (zero where
    ``ci < 0``) is added into its (clipped) row with ``index_add_``, in f32
    (or g's type where that is wider), and the sum is rounded once."""
    b, p, ch = g.shape
    acc = torch.promote_types(g.dtype, torch.float32)
    w = (cw * (ci >= 0)).to(acc)
    contrib = w[..., None] * g.to(acc)[:, :, None, :]  # (B, P, 4, C)
    base = torch.arange(b, device=g.device)[:, None] * hw
    dx = torch.zeros(b * hw, ch, dtype=acc, device=g.device)
    dx.index_add_(0, (_clipped_rows(ci, hw) + base).reshape(-1),
                  contrib.reshape(-1, ch))
    return dx.reshape(b, hw, ch).to(g.dtype)


def bilinear_gather_bwd_dcw_plain(g: torch.Tensor, x: torch.Tensor,
                                  ci: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the K3dcw kernel, on any device: g (B, P,
    C) and x (B, HW, C) -> dcw (B, P, 4) f32: the dot product of g's row
    with each of its four (clipped) rows of x, in f32 (or x's type where
    that is wider), 0 where ``ci < 0``."""
    b, p, ch = g.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    idx = _clipped_rows(ci, x.shape[1])[..., None].expand(-1, -1, ch)
    rows = torch.gather(x, 1, idx).reshape(b, p, 4, ch).to(acc)
    dots = (rows * g.to(acc)[:, :, None, :]).sum(-1)
    return (dots * (ci >= 0)).float()


def pad_channels(t: torch.Tensor) -> torch.Tensor:
    """``t`` (..., C) f32 or bf16, zero-padded along its last axis to a
    whole number of 16-byte vectors (a multiple of 4 in f32, 8 in bf16):
    a new contiguous tensor, or ``t`` itself where C already is one (or
    the type is not one the kernels take, for ``_check`` to refuse)."""
    c = t.shape[-1]
    vec = _VEC.get(t.dtype, 1)
    if c % vec == 0:
        return t
    return torch.nn.functional.pad(t, (0, -c % vec))


def unpad_channels(t: torch.Tensor, c: int) -> torch.Tensor:
    """The first ``c`` channels of a padded result, contiguous."""
    return t if t.shape[-1] == c else t[..., :c].contiguous()


def _check(x, ci, cw, g=None, width=None) -> None:
    """What the kernels take, checked on the padded tensors: x (B, HW, C),
    C (or ``width``, the padded channels of g where the kernel reads no x)
    a whole number of 16-byte vectors, ci (B, P, 4) int32, cw (B, P, 4)
    f32, and g where given, all contiguous, 16-byte aligned, on x's
    device."""
    if x.dim() != 3 or ci.dim() != 3 or ci.shape[2] != 4 \
            or cw.shape != ci.shape or ci.shape[0] != x.shape[0]:
        raise ValueError(f"expected x (B, HW, C) and ci, cw (B, P, 4); got "
                         f"{tuple(x.shape)}, {tuple(ci.shape)}, "
                         f"{tuple(cw.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if ci.dtype != torch.int32 or cw.dtype != torch.float32:
        raise TypeError(f"ci must be int32 and cw float32, got {ci.dtype} "
                        f"and {cw.dtype}")
    width = x.shape[2] if width is None else width
    if width % _VEC[x.dtype]:
        raise ValueError(f"C={width} is not padded to a multiple of "
                         f"{_VEC[x.dtype]} for {x.dtype} (16-byte vectors)")
    if x.shape[1] < 1:
        raise ValueError("x has no rows to gather")
    named = (("x", x), ("ci", ci), ("cw", cw)) + (
        () if g is None else (("g", g),))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


GATHER_THREADS = 256  # threads a block of K3f and K3dcw
GRID_BLOCKS = 2 ** 31 - 1  # the most blocks of a one-dimensional grid


def _int_args(**sizes) -> None:
    """The sizes passed to a kernel as C ints must fit 32 bits."""
    for name, v in sizes.items():
        if v > _INT32_MAX:
            raise ValueError(f"{name} = {v} does not fit the kernel's 32-bit "
                             f"size arguments")


def gather_fwd_plan(b: int, hw: int, c: int, p: int, dtype) -> dict:
    """K3f's launch for (b, hw, c) maps (c padded to 16-byte vectors) and p
    points per image: one thread per output vector, ``blocks`` of
    ``GATHER_THREADS``, ``wide`` (64-bit thread indices) from 2**31
    vectors on; every offset into x and out is 64-bit, so any B * P * C
    the grid holds is one launch. Raises where it does not."""
    _int_args(B=b, HW=hw, C=c, P=p)
    vectors = b * p * (c // _VEC[dtype])
    blocks = -(-vectors // GATHER_THREADS)
    if blocks > GRID_BLOCKS:
        raise ValueError(f"{vectors} output vectors pass the grid")
    return dict(wide=vectors >= 2 ** 31, blocks=blocks)


def gather_dcw_plan(b: int, hw: int, c: int, p: int) -> dict:
    """K3dcw's launch: one warp per corner (B * P * 4 of them), 8 a block,
    ``wide`` (64-bit warp indices) from 2**31 corners on; offsets into g and
    x are 64-bit. Raises where the grid does not hold it."""
    _int_args(B=b, HW=hw, C=c, P=p)
    corners = 4 * b * p
    blocks = -(-corners // (GATHER_THREADS // 32))
    if blocks > GRID_BLOCKS:
        raise ValueError(f"{corners} corners pass the grid")
    return dict(wide=corners >= 2 ** 31, blocks=blocks)


def _bilinear_gather_cuda(x, ci, cw) -> torch.Tensor:
    c = x.shape[-1]
    x = pad_channels(x)
    _check(x, ci, cw)
    b, hw, ch = x.shape
    p = ci.shape[1]
    plan = gather_fwd_plan(b, hw, ch, p, x.dtype)
    out = torch.empty(b, p, ch, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return unpad_channels(out, c)
    fn = BILINEAR_GATHER_FWD.fn()
    BILINEAR_GATHER_FWD.launches += 1
    err = fn(x.data_ptr(), ci.data_ptr(), cw.data_ptr(), out.data_ptr(), b,
             hw, ch, p, _DTYPE_CODE[x.dtype], int(plan["wide"]),
             cuda_stream(x.device))
    BILINEAR_GATHER_FWD.check(err)
    return unpad_channels(out, c)


def _check_g(g, x, ci) -> None:
    """g against the unpadded x: (B, P, C) in x's type, on x's device."""
    want = (ci.shape[0], ci.shape[1], x.shape[2])
    if (g.shape != want or g.dtype != x.dtype or g.device != x.device
            or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous {x.dtype} (B, P, C) = "
                         f"{want} tensor on {x.device}; got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")


# K3dx's launch plan: the f32 row tile in shared memory takes at most this
# many bytes; the sort of one window of a bucket holds SORT_CAP 8-byte keys
DX_TILE_BYTES = 32 * 1024
DX_MAX_TILE_ROWS = 64
DX_SORT_CAP = 1024
DX_HIST_BINS = 256
SMEM_PER_BLOCK = 232_448  # an H100 block's most dynamic shared memory


def gather_bwd_dx_plan(b: int, hw: int, c: int, p: int) -> dict:
    """K3dx's launch plan for dx (b, hw, c) from p points per image:
    ``tile_rows`` (TQ, a power of two: the most rows, up to 64, whose f32
    sums fit in ``DX_TILE_BYTES``, or one), ``tiles`` (b * ceil(hw / TQ),
    one block each), ``cap`` (keys sorted at once), ``smem_bytes`` per
    block and ``scratch_ints`` (the corners' bucket ids, the tiles' counts
    and starts). Raises where the kernel cannot take the shape."""
    if b < 1 or hw < 1 or c < 1:
        raise ValueError(f"empty map ({b}, {hw}, {c})")
    if 4 * b * p > _INT32_MAX:
        raise ValueError(f"4 * B * P = {4 * b * p} corner ids pass 2**31")
    tq = DX_MAX_TILE_ROWS
    while tq > 1 and tq * c * 4 > DX_TILE_BYTES:
        tq //= 2
    tiles = b * -(-hw // tq)
    smem = tq * c * 4 + DX_SORT_CAP * 8 + (tq + 1 + DX_HIST_BINS) * 4
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"C={c}: one row's f32 sums do not fit in shared "
                         f"memory ({smem} > {SMEM_PER_BLOCK} bytes)")
    return dict(tile_rows=tq, tiles=tiles, cap=DX_SORT_CAP, smem_bytes=smem,
                scratch_ints=4 * b * p + 2 * tiles + 1)


def _bwd_dx_cuda(g, x, ci, cw) -> torch.Tensor:
    _check_g(g, x, ci)
    c = x.shape[-1]
    g = pad_channels(g)
    _check(x, ci, cw, g, width=g.shape[-1])  # the kernel reads no x
    b, hw = x.shape[:2]
    ch = g.shape[-1]
    p = ci.shape[1]
    plan = gather_bwd_dx_plan(b, hw, ch, p)
    dx = torch.empty(b, hw, ch, dtype=x.dtype, device=x.device)
    scratch = torch.empty(plan["scratch_ints"], dtype=torch.int32,
                          device=x.device)
    fn = BILINEAR_GATHER_BWD_DX.fn()
    BILINEAR_GATHER_BWD_DX.launches += 1
    err = fn(g.data_ptr(), ci.data_ptr(), cw.data_ptr(), scratch.data_ptr(),
             dx.data_ptr(), b, hw, ch, p, plan["tile_rows"], plan["cap"],
             plan["smem_bytes"], _DTYPE_CODE[x.dtype], cuda_stream(x.device))
    BILINEAR_GATHER_BWD_DX.check(err)
    return unpad_channels(dx, c)


def _bwd_dcw_cuda(g, x, ci, cw) -> torch.Tensor:
    _check_g(g, x, ci)
    g, x = pad_channels(g), pad_channels(x)
    _check(x, ci, cw, g)
    b, hw, ch = x.shape
    p = ci.shape[1]
    plan = gather_dcw_plan(b, hw, ch, p)
    dcw = torch.empty(b, p, 4, dtype=torch.float32, device=x.device)
    if dcw.numel() == 0:
        return dcw
    fn = BILINEAR_GATHER_BWD_DCW.fn()
    BILINEAR_GATHER_BWD_DCW.launches += 1
    err = fn(g.data_ptr(), x.data_ptr(), ci.data_ptr(), dcw.data_ptr(), b,
             hw, ch, p, _DTYPE_CODE[x.dtype], int(plan["wide"]),
             cuda_stream(x.device))
    BILINEAR_GATHER_BWD_DCW.check(err)
    return dcw


def _forward(x, ci, cw) -> torch.Tensor:
    if device_kind(x) == "cuda":
        return _bilinear_gather_cuda(x, ci, cw)
    return bilinear_gather_plain(x, ci, cw)


def bilinear_gather_bwd_dx(g: torch.Tensor, x: torch.Tensor,
                           ci: torch.Tensor, cw: torch.Tensor
                           ) -> torch.Tensor:
    """The gradient of ``bilinear_gather`` with respect to ``x`` (only its
    shape, type and device are read), from the output's gradient ``g`` (B,
    P, C): a CUDA ``x`` launches the ``bilinear_gather_bwd_dx`` kernel (g
    contiguous, in x's type; a C that is not a whole number of 16-byte
    vectors is zero-padded to one for the launch and dx sliced back to C)
    and raises on what it does not take; a CPU ``x`` runs the plain
    version."""
    if device_kind(x) == "cuda":
        return _bwd_dx_cuda(g, x, ci, cw)
    return bilinear_gather_bwd_dx_plain(g, ci, cw, x.shape[1])


def bilinear_gather_bwd_dcw(g: torch.Tensor, x: torch.Tensor,
                            ci: torch.Tensor, cw: torch.Tensor
                            ) -> torch.Tensor:
    """The gradient of ``bilinear_gather`` with respect to ``cw`` (B, P, 4)
    f32 (only its shape and type are read): a CUDA ``x`` launches the
    ``bilinear_gather_bwd_dcw`` kernel (g and x padded with zero channels as
    for the forward, which leaves every dot as it is) and raises on what it
    does not take; a CPU ``x`` runs the plain version."""
    if device_kind(x) == "cuda":
        return _bwd_dcw_cuda(g, x, ci, cw)
    return bilinear_gather_bwd_dcw_plain(g, x, ci)


class _BilinearGather(torch.autograd.Function):
    """``bilinear_gather`` with its backward; saves (x, ci, cw) as the
    reference's ``_vjp_fwd`` does, and computes only the gradients that are
    asked for."""

    @staticmethod
    def forward(ctx, x, ci, cw):
        ctx.save_for_backward(x, ci, cw)
        return _forward(x, ci, cw)

    @staticmethod
    def backward(ctx, g):
        x, ci, cw = ctx.saved_tensors
        g = g.contiguous()
        dx = dcw = None
        if ctx.needs_input_grad[0]:
            dx = bilinear_gather_bwd_dx(g, x, ci, cw)
        if ctx.needs_input_grad[2]:
            dcw = bilinear_gather_bwd_dcw(g, x, ci, cw)
        return dx, None, dcw


def bilinear_gather(x: torch.Tensor, ci: torch.Tensor,
                    cw: torch.Tensor) -> torch.Tensor:
    """``out[b, p] = sum_{c<4} cw[b, p, c] * x[b, ci[b, p, c], :]``: x
    (B, HW, C), ci (B, P, 4) int32 (negative = skip), cw (B, P, 4) f32 ->
    (B, P, C) in x's type. Differentiable with respect to x and cw.

    A CUDA ``x`` launches the ``bilinear_gather_fwd`` kernel, and in the
    backward ``bilinear_gather_bwd_dx`` and / or ``bilinear_gather_bwd_dcw``
    (f32 or bf16, contiguous, any C >= 1: a C that is not a multiple of 4 in
    f32 or 8 in bf16 is zero-padded to one for the launch and the result
    sliced back to C), and raises on what they do not take; a CPU ``x``
    runs the plain versions."""
    if torch.is_grad_enabled() and (x.requires_grad or cw.requires_grad):
        return _BilinearGather.apply(x, ci, cw)
    return _forward(x, ci, cw)


def bilinear_corners(ys: torch.Tensor, xs: torch.Tensor, h: int, w: int):
    """Float coordinates (B, P) on an (h, w) map -> (ci (B, P, 4) int32, cw
    (B, P, 4) f32): the four corners' flat row indices, -1 for a corner
    outside the map, and their bilinear weights (left as they are at
    corners outside the map: the gather skips on the index). The weights
    carry the gradient to ``ys`` and ``xs``, with ``floor`` held fixed."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    dy = (ys - y0).float()
    dx = (xs - x0).float()
    cis, cws = [], []
    for cy, cx, wgt in ((y0, x0, (1 - dy) * (1 - dx)),
                        (y0, x0 + 1, (1 - dy) * dx),
                        (y0 + 1, x0, dy * (1 - dx)),
                        (y0 + 1, x0 + 1, dy * dx)):
        inb = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
        # clamped before the int conversion, so far-out coordinates never
        # reach it
        idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).to(torch.int32)
        cis.append(torch.where(inb, idx, torch.full_like(idx, -1)))
        cws.append(wgt)
    return torch.stack(cis, dim=-1), torch.stack(cws, dim=-1)


def bilinear_sample_2d(x: torch.Tensor, ys: torch.Tensor,
                       xs: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) at float coordinates ys / xs (B, P) -> (B, P,
    C); corners outside the map contribute zero. Gradients flow to ``x``
    and, through the bilinear weights, to ``ys`` and ``xs``. ``x`` must be
    contiguous
    (the NHWC view of a ``channels_last`` NCHW map is): it is read in place
    as (B, H*W, C), never copied."""
    b, h, w, ch = x.shape
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor (the NHWC view "
                         "of a channels_last NCHW map is)")
    ci, cw = bilinear_corners(ys, xs, h, w)
    return bilinear_gather(x.view(b, h * w, ch), ci, cw)


def affine_points(affines: torch.Tensor, out_hw: Tuple[int, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every output pixel (x, y) of an (oh, ow) grid, row by row, mapped
    through each (B, 2, 3) affine: the input coordinates (ys, xs), (B, oh *
    ow) f32 each, on the affines' device."""
    oh, ow = out_hw
    gy, gx = torch.meshgrid(
        torch.arange(oh, dtype=torch.float32, device=affines.device),
        torch.arange(ow, dtype=torch.float32, device=affines.device),
        indexing="ij")
    gx, gy = gx.reshape(1, -1), gy.reshape(1, -1)  # the (P, 2) grid
    a = affines.float()
    xs = a[:, 0, 0, None] * gx + a[:, 0, 1, None] * gy + a[:, 0, 2, None]
    ys = a[:, 1, 0, None] * gx + a[:, 1, 1, None] * gy + a[:, 1, 2, None]
    return ys, xs


def bilinear_warp_affine_plain(x: torch.Tensor, affines: torch.Tensor,
                               out_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the warp kernel, on any device: x (B, H, W,
    C) sampled at ``affine_points`` through ``bilinear_corners`` and
    ``bilinear_gather_plain`` -> (B, oh, ow, C) in x's type."""
    b, h, w, c = x.shape
    ys, xs = affine_points(affines, out_hw)
    ci, cw = bilinear_corners(ys, xs, h, w)
    out = bilinear_gather_plain(x.reshape(b, h * w, c), ci, cw)
    return out.reshape(b, *out_hw, c)


# The warp kernel's launch: the pixel route's block owns a WARP_TILE (rows,
# columns) tile of one image's output, one pixel a thread
WARP_TILE = (8, 32)
WARP_THREADS = 256
GRID_YZ = 65535  # the most blocks along a grid's y or z
COORD_MAX = 2 ** 24  # float coordinates are exact integers below this


def warp_affine_plan(b: int, h: int, w: int, c: int, oh: int, ow: int,
                     dtype) -> dict:
    """The warp kernel's launch for (b, h, w, c) maps warped to (oh, ow):
    ``route`` "pixel" for C <= 4 (f32) or 8 (bf16), ``grid`` (ow / 32, oh
    / 8, b) blocks of ``threads``, each owning a ``tile`` of (8, 32)
    output pixels; ``route`` "vector" for wider C, one thread a 16-byte
    vector of a pixel (``vectors`` a pixel, ``aligned`` where C is a whole
    number of them), ``grid`` (oh * ow * vectors / 256, b, 1).

    Raises on what the kernel does not take: another type, an empty map or
    output, a side of 2**24 or more, more than 65535 images or tile rows,
    an image of 2**31 vectors."""
    if dtype not in _VEC:
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    if min(b, h, w, c, oh, ow) < 1:
        raise ValueError(f"empty warp: ({b}, {h}, {w}, {c}) -> ({oh}, {ow})")
    if max(h, w, oh, ow) >= COORD_MAX:
        raise ValueError(f"a side of ({h}, {w}) -> ({oh}, {ow}) reaches "
                         f"2**24, past exact float coordinates")
    if b > GRID_YZ:
        raise ValueError(f"B = {b} images pass the grid's {GRID_YZ}")
    elt = torch.empty((), dtype=dtype).element_size()
    _int_args(row_bytes=w * c * elt)
    vec = _VEC[dtype]
    if c <= vec:
        th, tw = WARP_TILE
        grid = (-(-ow // tw), -(-oh // th), b)
        if grid[1] > GRID_YZ:
            raise ValueError(f"OH = {oh}: {grid[1]} tile rows pass the grid")
        return dict(route="pixel", tile=WARP_TILE, threads=WARP_THREADS,
                    grid=grid)
    nv = -(-c // vec)
    total = oh * ow * nv
    if total > _INT32_MAX:
        raise ValueError(f"{total} vectors an image pass 2**31")
    return dict(route="vector", vectors=nv, aligned=c % vec == 0,
                threads=WARP_THREADS, grid=(-(-total // WARP_THREADS), b, 1))


def _check_warp(x, affines) -> None:
    """What the warp kernel takes: x (B, H, W, C) f32 or bf16, contiguous,
    16-byte aligned; affines (B, 2, 3) f32 contiguous on x's device."""
    if x.dim() != 4 or affines.shape != (x.shape[0], 2, 3):
        raise ValueError(f"expected x (B, H, W, C) and affines (B, 2, 3); "
                         f"got {tuple(x.shape)}, {tuple(affines.shape)}")
    if x.dtype not in _DTYPE_CODE or affines.dtype != torch.float32:
        raise TypeError(f"x must be float32 or bfloat16 and affines "
                        f"float32, got {x.dtype} and {affines.dtype}")
    for name, t in (("x", x), ("affines", affines)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


def _warp_affine_cuda(x, affines, out_hw) -> torch.Tensor:
    _check_warp(x, affines)
    b, h, w, c = x.shape
    oh, ow = out_hw
    warp_affine_plan(b, h, w, c, oh, ow, x.dtype)
    out = torch.empty(b, oh, ow, c, dtype=x.dtype, device=x.device)
    fn = BILINEAR_WARP_AFFINE_FWD.fn()
    BILINEAR_WARP_AFFINE_FWD.launches += 1
    err = fn(x.data_ptr(), affines.data_ptr(), out.data_ptr(), b, h, w, c,
             oh, ow, _DTYPE_CODE[x.dtype], cuda_stream(x.device))
    BILINEAR_WARP_AFFINE_FWD.check(err)
    return out


def bilinear_warp_affine(x: torch.Tensor, affines: torch.Tensor,
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse-affine bilinear warp: x (B, H, W, C) sampled at every output
    pixel (x, y) of ``out_hw`` mapped through its image's (B, 2, 3) affine
    -> (B, oh, ow, C) in x's type; corners off the map add zero. No
    gradient.

    A CUDA ``x`` launches the ``bilinear_warp_affine_fwd`` kernel (f32 or
    bf16, contiguous, any C >= 1 unpadded, affines f32 contiguous on x's
    device; ``warp_affine_plan``) and raises on what it does not take or a
    failed build or launch; a CPU ``x`` runs the plain version."""
    if device_kind(x) == "cuda":
        return _warp_affine_cuda(x, affines, out_hw)
    return bilinear_warp_affine_plain(x, affines, out_hw)
