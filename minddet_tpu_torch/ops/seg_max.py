"""Bounded segment max of a sorted point stream, at every row of the segment
(counterpart of ``minddet_tpu/ops/seg_pallas.py``: ``seg_full_max_bounded``).

The stream PFN's non-last layers concatenate each pillar's max back onto
every point of the pillar. ``x`` (B, N, C) is the stream sorted by pillar,
``first`` (B, N) flags each segment's head and ``last`` each segment's last
kept row, at most ``bound`` rows after the head (the voxelizer's per-pillar
point cap). At every row from a segment's head to its last kept row the
result is the max of ``x`` over exactly those rows; everywhere else (rows
past their segment's last kept row, segments with none, the invalid tail)
it is 0. The reference leaves those rows to whatever its shift levels
produce, and its callers read kept rows only; ``seg_covered`` gives the mask
of the rows where the two agree.

``seg_full_max_bounded`` is the ``torch.library`` custom op
``minddet::SegFullMax``, its gradient the op ``minddet::SegFullMaxBwd``
(each with a CPU implementation, the plain version; a CUDA one, the kernel;
a fake one for ``torch.export`` and the meta device; none for any other
device). On a CUDA tensor ``seg_full_max_bounded`` launches
``csrc/seg_full_max.cu``, the port of the TPU kernel
``seg_pallas.py:_fwd_kernel``, and in the
backward ``csrc/seg_full_max_bwd.cu``, the port of ``_bwd_kernel``; on a CPU
tensor it runs the plain versions ``seg_full_max_bounded_plain`` (the
reference's shift-level form: ``seg_running_max``, then the last row's
value broadcast back) and ``seg_full_max_bounded_bwd_plain``. The kernels
move 16-byte vectors (4 f32 or 8 bf16 channels); for any other C the
wrappers zero-pad the channel axis to a whole number of vectors
(``bilinear.pad_channels``) and slice the result back to C. A zero channel
has a max of 0, and in the backward its x equals its m and its g is 0, so
its dx is 0: the result is the unpadded one. Any size the grid holds is
one launch (``seg_max_plan`` for the forward, ``seg_max_bwd_plan`` for the
backward).

Both kernels work on tiles of rows (``_tile_plan``): a block stages the
tile's flag bytes with a halo of ``bound - 1`` rows on each side in shared
memory; a tile with no covered row writes zeros and reads no data; any
other copies its rows of x (and g) into shared memory while it finds each
row's segment once. The forward then copies a one-row segment's x and walks
a longer one once per vector for its max; the backward gives a one-row
segment g and walks a longer one once per half vector, taking the
segment's max of x itself (it reads no ``m``). Each is bit for bit the
per-row kernel it replaced.
It reads ``g`` in place with any row stride: the non-last stream PFN
layer's ``torch.cat`` hands its backward the second half of a (B, N, 2C)
gradient, and no copy of it is made (``_check_bwd``).

The gradient follows the reference's Pallas backward, the reduce-max
convention: within a segment the summed gradient of the covered rows goes to
the rows that hold the max, shared evenly among ties. (The reference's
default XLA path differentiates its shift levels instead and splits a tie
half and half at every ``maximum``, so three tied rows get 1/2, 1/4, 1/4
there.) Outside ``seg_covered`` the forward is the constant 0: dx is 0 there
and the gradient arriving at such rows is not summed.
"""

from __future__ import annotations

import torch

from minddet_tpu_torch.kernels import (SEG_FULL_MAX, SEG_FULL_MAX_BWD,
                                       contiguous, cuda_stream)
from minddet_tpu_torch.ops.bilinear import (GRID_BLOCKS, pad_channels,
                                            unpad_channels)
from minddet_tpu_torch.ops.voxelize import (_seg_bcast_bounded,
                                            _seg_sum_bounded,
                                            seg_running_max)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # values per 16-byte vector
_INT32_MAX = 2 ** 31 - 1


def _next_flag(flag: torch.Tensor) -> torch.Tensor:
    """(B, N) bool -> at each row the index of the nearest flagged row at or
    after it, N where there is none."""
    n = flag.shape[1]
    idx = torch.arange(n, device=flag.device).expand_as(flag)
    marked = torch.where(flag, idx, torch.full_like(idx, n))
    return marked.flip(1).cummin(dim=1).values.flip(1)


def seg_covered(first: torch.Tensor, last: torch.Tensor,
                bound: int) -> torch.Tensor:
    """(B, N) bool: the rows from a segment's head to its last kept row,
    i.e. with a ``last`` row at or after them, fewer than ``bound`` rows
    away, and no segment head in between. For a voxelizer stream these are
    its kept rows."""
    n = first.shape[1]
    idx = torch.arange(n, device=first.device).expand_as(first)
    nl = _next_flag(last)
    nf = _next_flag(first)
    nf_after = torch.cat([nf[:, 1:], torch.full_like(nf[:, :1], n)], dim=1)
    return (nl < n) & (nl - idx < bound) & (nl < nf_after)


def seg_full_max_bounded_plain(first: torch.Tensor, last: torch.Tensor,
                               x: torch.Tensor, bound: int) -> torch.Tensor:
    """Plain PyTorch version of the K5f kernel, on any device: the running
    max within each segment (ceil(log2(bound)) shift levels), the value at
    each ``last`` row broadcast back over the rows before it (as many
    levels again), and 0 outside ``seg_covered``."""
    full = _seg_bcast_bounded(last, seg_running_max(first, x, bound), bound)
    return torch.where(seg_covered(first, last, bound)[..., None], full,
                       torch.zeros_like(full))


def seg_full_max_bounded_bwd_plain(first: torch.Tensor, last: torch.Tensor,
                                   x: torch.Tensor, m: torch.Tensor,
                                   g: torch.Tensor, bound: int
                                   ) -> torch.Tensor:
    """Plain PyTorch version of the K5b kernel, on any device: ``m`` is the
    forward's output and ``g`` its gradient. Per segment and channel the sum
    of ``g`` and the count of the rows with ``x == m``, both over the
    covered rows (a running sum to each ``last`` row, broadcast back, in
    f32 or x's type where that is wider); ``dx = tie * gsum / max(count,
    1)``, 0 outside ``seg_covered``; rounded once to x's type."""
    acc = torch.promote_types(x.dtype, torch.float32)
    cov = seg_covered(first, last, bound)[..., None]
    tie = ((x == m) & cov).to(acc)
    gz = torch.where(cov, g.to(acc), torch.zeros((), dtype=acc,
                                                 device=x.device))

    def over_segment(z):
        return _seg_bcast_bounded(last, _seg_sum_bounded(first, z, bound),
                                  bound)

    dx = tie * over_segment(gz) / over_segment(tie).clamp(min=1.0)
    return torch.where(cov, dx, torch.zeros_like(dx)).to(x.dtype)


def _check(first, last, x, bound) -> None:
    """What the kernels take, checked on the padded x: (B, N, C) f32 or
    bf16 with C a whole number of 16-byte vectors, first and last (B, N)
    bool, all contiguous and on x's device, x 16-byte aligned."""
    if x.dim() != 3 or first.shape != x.shape[:2] or last.shape != first.shape:
        raise ValueError(f"expected x (B, N, C) and first, last (B, N); got "
                         f"{tuple(x.shape)}, {tuple(first.shape)}, "
                         f"{tuple(last.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.shape[2] % _VEC[x.dtype]:
        raise ValueError(f"C={x.shape[2]} is not padded to a multiple of "
                         f"{_VEC[x.dtype]} for {x.dtype} (16-byte vectors)")
    if bound < 1:
        raise ValueError(f"bound must be >= 1, got {bound}")
    for name, t in (("first", first), ("last", last)):
        if t.dtype != torch.bool:
            raise TypeError(f"{name} must be bool, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("first", first), ("last", last)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


SEG_THREADS = 128       # threads a block of K5f and of K5b
SEG_FWD_WORK = 512      # K5f: rows times 16-byte vectors a block takes
SEG_FWD_CHUNK = 8       # ... of which vectors of a row at most
SEG_FWD_TILE = 256      # ... and rows at most
SEG_BWD_WORK = 512      # K5b: the same three
SEG_BWD_CHUNK = 8
SEG_BWD_TILE = 256
SEG_SLOTS = 132 * 8     # blocks an H100 holds at once (132 SMs, 8 each)
SHARED_MEMORY_MAX = 232448  # bytes of shared memory a block may take


def _seg_fwd_smem(tile: int, bound: int, chunk: int) -> int:
    """K5f's shared memory: per tile row its item, per longer segment its
    last row and head (int32 each), the warps' counts of them and the halo's
    two edges, padded to 16 bytes; ``chunk`` vectors of x at each row of the
    window (the tile and bound - 1 rows of halo on each side) and of a
    segment's max at each tile row; the window's two flag planes as 32-bit
    masks, one word a warp of each round of ``SEG_THREADS`` rows, and one
    word more."""
    warps = SEG_THREADS // 32
    window = tile + 2 * (bound - 1)
    ints = -(-(12 * tile + 4 * warps + 8) // 16) * 16
    words = warps * -(-window // SEG_THREADS) + 1
    return ints + (window + tile) * 16 * chunk + 8 * words


def _seg_bwd_smem(tile: int, bound: int, chunk: int) -> int:
    """K5b's shared memory: per tile row its segment's last row, the
    one-row segments' rows, per longer segment its first row, last row and
    head (int32 each) and the warps' counts of both, padded to 16 bytes;
    then at each row of the window (the tile and bound - 1 rows of halo on
    each side) x's and g's ``chunk`` vectors and the two flag bytes."""
    ints = -(-(20 * tile + 8 * (SEG_THREADS // 32)) // 16) * 16
    return ints + (tile + 2 * (bound - 1)) * (2 * 16 * chunk + 2)


def _tile_plan(b, n, c, dtype, bound, row_vectors, work, chunk_max,
               tile_max, fill, smem_of) -> dict:
    """The tiled kernels' launch: a chunk of a whole row up to
    ``chunk_max`` vectors; the most rows up to ``tile_max`` with tile x
    chunk <= ``work`` (64 at least), halved once where ``fill`` and the grid
    would not fill the card's ``SEG_SLOTS``; the chunk halved where a long
    bound's window would not fit a block's shared memory. ``row_vectors`` is
    the widest operand's vectors a row, which decides ``wide``."""
    if bound < 1:
        raise ValueError(f"bound must be >= 1, got {bound}")
    halo = bound - 1
    vec = _VEC[dtype]
    nv = c // vec
    chunk = min(nv, chunk_max)
    tile = tile_max
    while tile * chunk > work and tile > 64:
        tile //= 2
    grid = lambda: b * -(-n // tile) * -(-nv // chunk)
    if fill and grid() < SEG_SLOTS and tile > 64:
        tile //= 2
    while chunk > 1 and smem_of(tile, bound, chunk) > SHARED_MEMORY_MAX:
        chunk //= 2
    smem = smem_of(tile, bound, chunk)
    if smem > SHARED_MEMORY_MAX:
        raise ValueError(f"bound = {bound}: the window of {tile} rows and a "
                         f"halo of {halo} on each side takes {smem} bytes at "
                         f"one vector a row, past a block's "
                         f"{SHARED_MEMORY_MAX} of shared memory")
    blocks = grid()
    if blocks > GRID_BLOCKS:
        raise ValueError(f"{blocks} tiles of {tile} rows pass the grid")
    return dict(tile_rows=tile, chunk=chunk, halo=halo, smem=smem,
                blocks=blocks, wide=b * n * row_vectors >= 2 ** 31)


def _int_sizes(**sizes) -> None:
    for name, v in sizes.items():
        if v > _INT32_MAX:
            raise ValueError(f"{name} = {v} does not fit the kernel's 32-bit "
                             f"size arguments")


def seg_max_plan(b: int, n: int, c: int, dtype, bound: int = 1) -> dict:
    """K5f's launch for (b, n, c) streams (c padded to 16-byte vectors):
    blocks of ``SEG_THREADS`` threads, each on a tile of ``tile_rows`` rows
    and ``chunk`` vectors of each row, with a window of ``halo`` = bound - 1
    rows on each side in ``smem`` bytes of shared memory; ``wide`` (64-bit
    row offsets) from 2**31 vectors of x on, 32-bit below (offsets within a
    sample's window are 32-bit).

    ``_tile_plan`` with ``SEG_FWD_WORK``, ``SEG_FWD_CHUNK`` and
    ``SEG_FWD_TILE``, and no halving to fill the card (halved tiles were
    slower on every batch-1 stream): at the CenterPoint and Waymo shapes
    f32 (B, N, 32) takes 64 x 8 and bf16 128 x 4, the fastest of 64-256
    rows x 2-8 vectors on an H100 (``scripts/seg_max_fwd_turns.py``). The
    kernel refuses a plan whose shared memory is short of the window of the
    bound it is launched with (a plan made at the default bound 1 has no
    halo). Raises where a size does not fit the kernel's 32-bit int
    arguments, the window does not fit a block's shared memory at one
    vector a row, or the grid does not hold the launch."""
    _int_sizes(B=b, N=n, C=c, bound=bound)
    return _tile_plan(b, n, c, dtype, bound, c // _VEC[dtype], SEG_FWD_WORK,
                      SEG_FWD_CHUNK, SEG_FWD_TILE, False, _seg_fwd_smem)


def seg_max_bwd_plan(b: int, n: int, c: int, dtype, bound: int,
                     g_stride: int | None = None) -> dict:
    """K5b's launch for (b, n, c) streams (c padded to 16-byte vectors, g's
    rows ``g_stride`` elements apart, c where None): blocks of
    ``SEG_THREADS`` threads, each on a tile of ``tile_rows`` rows and
    ``chunk`` vectors of each row, with a window of ``halo`` = bound - 1
    rows on each side in ``smem`` bytes of shared memory; ``wide`` (64-bit
    row offsets) from 2**31 vectors of g's rows on, 32-bit below.

    ``_tile_plan`` with ``SEG_BWD_WORK``, ``SEG_BWD_CHUNK`` and
    ``SEG_BWD_TILE``: at the CenterPoint shapes bf16 (8, 120000, 32) takes
    128 x 4, f32 (4, 120000, 32) 64 x 8, the fastest of 64-256 rows x 4-8
    vectors on an H100 (``scripts/seg_max_bwd_turns.py``). Raises where a
    size does not fit the kernel's 32-bit int arguments, the window does
    not fit a block's shared memory at one vector a row, or the grid does
    not hold the launch."""
    g_stride = c if g_stride is None else g_stride
    _int_sizes(B=b, N=n, C=c, bound=bound, **{"g's row stride": g_stride})
    return _tile_plan(b, n, c, dtype, bound, g_stride // _VEC[dtype],
                      SEG_BWD_WORK, SEG_BWD_CHUNK, SEG_BWD_TILE, True,
                      _seg_bwd_smem)


def _check_bwd(x, g) -> None:
    """What the backward kernel takes of g beside the padded x: x's shape,
    type and device, unit channel stride, rows a whole number of 16-byte
    vectors apart and at least C elements (the batch stride N rows), and
    16-byte alignment. The cat's gradient slice (row stride 2C) passes."""
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must be a {x.dtype} {tuple(x.shape)} tensor on "
                         f"{x.device}; got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")
    b, n, c = g.shape
    row = g.stride(1)
    if g.stride(2) != 1:
        raise ValueError(f"g's channels must be unit-strided, got stride "
                         f"{g.stride(2)}")
    if row < c or (row * g.element_size()) % 16 or (
            b > 1 and g.stride(0) != n * row):
        raise ValueError(f"g's rows must lie a whole number of 16-byte "
                         f"vectors apart, at least C = {c} elements, and its "
                         f"samples N rows apart; got strides {g.stride()}")
    if g.data_ptr() % 16:
        raise ValueError("g must be 16-byte aligned")


def _seg_full_max_cuda(first, last, x, bound) -> torch.Tensor:
    c = x.shape[-1]
    x = pad_channels(x)
    _check(first, last, x, bound)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return unpad_channels(out, c)
    b, n, ch = x.shape
    plan = seg_max_plan(b, n, ch, x.dtype, bound)
    fn = SEG_FULL_MAX.fn()
    SEG_FULL_MAX.launches += 1
    err = fn(x.data_ptr(), first.data_ptr(), last.data_ptr(), out.data_ptr(),
             b, n, ch, bound, plan["tile_rows"], plan["chunk"], plan["smem"],
             _DTYPE_CODE[x.dtype], int(plan["wide"]), cuda_stream(x.device))
    SEG_FULL_MAX.check(err)
    return unpad_channels(out, c)


def _seg_full_max_bwd_cuda(first, last, x, m, g, bound) -> torch.Tensor:
    if m.shape != x.shape or m.dtype != x.dtype or m.device != x.device:
        raise ValueError(f"m must be a {x.dtype} {tuple(x.shape)} tensor on "
                         f"{x.device}; got {m.dtype} {tuple(m.shape)} on "
                         f"{m.device}")
    c = x.shape[-1]
    x, g = pad_channels(x), pad_channels(g)
    _check(first, last, x, bound)
    _check_bwd(x, g)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return unpad_channels(dx, c)
    b, n, ch = x.shape
    plan = seg_max_bwd_plan(b, n, ch, x.dtype, bound, g.stride(1))
    fn = SEG_FULL_MAX_BWD.fn()
    SEG_FULL_MAX_BWD.launches += 1
    err = fn(x.data_ptr(), g.data_ptr(), first.data_ptr(), last.data_ptr(),
             dx.data_ptr(), b, n, ch, g.stride(1), bound, plan["tile_rows"],
             plan["chunk"], plan["smem"], _DTYPE_CODE[x.dtype],
             int(plan["wide"]), cuda_stream(x.device))
    SEG_FULL_MAX_BWD.check(err)
    return unpad_channels(dx, c)


# K5f's op: the plain version on the CPU, the kernel on a CUDA tensor
@torch.library.custom_op("minddet::SegFullMax", mutates_args=(),
                         device_types="cpu")
def _seg_op(first: torch.Tensor, last: torch.Tensor, x: torch.Tensor,
            bound: int) -> torch.Tensor:
    return seg_full_max_bounded_plain(first, last, x, bound)


_seg_op.register_kernel("cuda")(
    lambda first, last, x, bound: _seg_full_max_cuda(
        *contiguous(first, last), x, bound))


@_seg_op.register_fake
def _(first, last, x, bound):
    return torch.empty_like(x)


# K5b's op
@torch.library.custom_op("minddet::SegFullMaxBwd", mutates_args=(),
                         device_types="cpu")
def _seg_bwd_op(first: torch.Tensor, last: torch.Tensor, x: torch.Tensor,
                m: torch.Tensor, g: torch.Tensor, bound: int) -> torch.Tensor:
    return seg_full_max_bounded_bwd_plain(first, last, x, m, g, bound)


_seg_bwd_op.register_kernel("cuda")(
    lambda first, last, x, m, g, bound: _seg_full_max_bwd_cuda(
        *contiguous(first, last), x, m, g, bound))


@_seg_bwd_op.register_fake
def _(first, last, x, m, g, bound):
    return torch.empty_like(x)


def seg_full_max_bounded_bwd(first: torch.Tensor, last: torch.Tensor,
                             x: torch.Tensor, m: torch.Tensor,
                             g: torch.Tensor, bound: int) -> torch.Tensor:
    """The gradient of ``seg_full_max_bounded`` with respect to ``x``, from
    the forward's output ``m`` and its gradient ``g`` (see
    ``seg_full_max_bounded_bwd_plain``), the op ``minddet::SegFullMaxBwd``:
    a CUDA ``x`` launches the ``seg_full_max_bwd`` kernel and raises on what
    it does not take (x contiguous; g in x's type with any row stride that
    ``_check_bwd`` takes; any C, zero-padded to a whole number of 16-byte
    vectors for the launch, which copies g); the kernel takes each
    segment's max of x itself, so ``m`` is only checked for its shape
    there; a CPU ``x`` runs the plain version."""
    return _seg_bwd_op(first, last, x, m, g, bound)


def _seg_setup(ctx, inputs, output):
    """Saves (first, last, x, out) as the reference's ``_op_fwd`` does (the
    kernel reads no ``out``; the plain version does)."""
    first, last, x, bound = inputs
    ctx.save_for_backward(first, last, x, output)
    ctx.bound = bound


def _seg_backward(ctx, g):
    """The gradient is passed on as it comes: the stream PFN's cat hands
    over a strided slice, which the kernel reads in place. Only a gradient
    with a zero stride (an expanded one, as ``out.sum()`` gives) is made
    contiguous first: the kernel reads whole rows."""
    first, last, x, out = ctx.saved_tensors
    if 0 in g.stride():
        g = g.contiguous()
    dx = seg_full_max_bounded_bwd(first, last, x, out, g, ctx.bound)
    return None, None, dx, None


_seg_op.register_autograd(_seg_backward, setup_context=_seg_setup)


def seg_full_max_bounded(first: torch.Tensor, last: torch.Tensor,
                         x: torch.Tensor, bound: int) -> torch.Tensor:
    """The max of ``x`` (B, N, C) over each segment's rows from its head to
    its last kept row, at every one of those rows; 0 at every other row.
    ``first`` / ``last`` (B, N) bool flag the heads and the last kept rows;
    a last kept row lies fewer than ``bound`` rows after its head.

    The op ``minddet::SegFullMax``, differentiable with respect to ``x``
    (ties share the gradient evenly). A CUDA ``x`` launches the
    ``seg_full_max`` kernel, and ``seg_full_max_bwd`` in the backward (f32
    or bf16, contiguous, any C: one that is not a multiple of 4 in f32 or 8
    in bf16 is zero-padded to one for the launch and the result sliced back
    to C), and raises on what they do not take; a CPU ``x`` runs the plain
    versions."""
    return _seg_op(first, last, x, bound)
