"""The per-shard kernels of the mesh drivers (parallel/dist.py): K24, the
gather and sorted segment reduce of one edge shard (csrc/shard_reduce.cu);
K25, the bit-packed frontier (csrc/mesh_bits.cu); K26, the updates of a node
vector after a collective (csrc/mesh_update.cu).

Each wrapper takes the plain PyTorch version beside it for CPU tensors and
launches its kernel for CUDA tensors, on the tensors' own device (a ctypes
launch runs on the current device: K24 and K26 take native/cuda.py's lean
path, which enters torch.cuda.device only when that device is not the
current one; K25's wrappers enter it every call).  Nothing is written in
place."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from falkordb_tpu_torch.native import cuda as _cuda

OR, SUM, MINPLUS, MIN = 0, 1, 2, 3
FORMS = {"or": OR, "sum": SUM, "minplus": MINPLUS, "min": MIN}
BIG = 2**30  # what a masked edge gives the MIN form
INT32_MAX = 2**31 - 1
TILE_ITEMS = 2048  # K24: a tile's segments start within 2048 items
LONG_SEG = 2048  # wider segments are cut into tasks
TASK_EDGES = 4096  # the edges of a task
TILE_CAP = TILE_ITEMS + LONG_SEG + 1  # csrc/shard_reduce.cu kTileCap


def _launch(name, fn, t, *args):
    """Call entry point `fn` on t's device and stream; count the launch."""
    with torch.cuda.device(t.device):
        rc = fn(*args, _cuda.stream_ptr(t))
    _cuda.check(rc, name)
    _cuda.count_launch(name)


# -- K24: the shard's segment reduce ----------------------------------------

_OFFSETS = _cuda.Entry("fk_shard_offsets", "shard_reduce")
_REDUCE = _cuda.Entry("fk_shard_reduce", "shard_reduce")


@dataclasses.dataclass(eq=False)
class SegmentPlan:
    """How K24 cuts a shard's sorted dst into num_segments segments, made
    once a sharding, on dst's device: offs (num_segments + 1,) int64,
    offs[s] the first edge whose dst >= s; tiles (n_tiles, 2) int64 [s0,
    s1), runs of whole segments of at most LONG_SEG edges, in order, a
    segment in the tile of its first merge-path item (a segment is its
    edges plus its end) counted in steps of TILE_ITEMS, so a tile holds at
    most TILE_ITEMS + LONG_SEG items; tasks (n_tasks, 5) int64 (segment,
    lo, hi, first, count): each wider segment's edges in runs of at most
    TASK_EDGES, in order, its tasks being rows first .. first + count - 1;
    scratch (2 n_tasks,) int32, the tasks' partials then their counters
    (zero between calls: the last task of a segment resets its counter);
    table, the 7 int64 words the launch reads (the device pointers and
    counts of offs, tiles, tasks and scratch), at host address
    table_ptr."""
    offs: torch.Tensor
    tiles: torch.Tensor
    tasks: torch.Tensor
    scratch: torch.Tensor
    num_segments: int
    table: np.ndarray
    table_ptr: int


def _tiles(width: torch.Tensor) -> torch.Tensor:
    """The tiles of the segments of at most LONG_SEG edges (`SegmentPlan`)."""
    dev = width.device
    long = width > LONG_SEG
    items = torch.where(long, 0, width + 1)
    tile = (torch.cumsum(items, 0) - items) // TILE_ITEMS
    segs = torch.nonzero(~long)[:, 0]
    if segs.numel() == 0:
        return torch.zeros((0, 2), dtype=torch.int64, device=dev)
    cut = torch.ones(segs.numel(), dtype=torch.bool, device=dev)
    cut[1:] = (tile[segs[1:]] != tile[segs[:-1]]) | (segs[1:] != segs[:-1] + 1)
    first = torch.nonzero(cut)[:, 0]
    s1 = torch.cat([segs[first[1:] - 1], segs[-1:]]) + 1
    return torch.stack([segs[first], s1], dim=1).contiguous()


def _tasks(offs: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """The tasks of the segments wider than LONG_SEG (`SegmentPlan`)."""
    segs = torch.nonzero(width > LONG_SEG)[:, 0]
    count = (width[segs] + TASK_EDGES - 1) // TASK_EDGES
    first = torch.cumsum(count, 0) - count
    seg = torch.repeat_interleave(segs, count)
    k = torch.arange(seg.numel(), device=offs.device) - \
        torch.repeat_interleave(first, count)
    lo = offs[seg] + k * TASK_EDGES
    hi = torch.minimum(lo + TASK_EDGES, offs[seg + 1])
    return torch.stack([seg, lo, hi, torch.repeat_interleave(first, count),
                        torch.repeat_interleave(count, count)],
                       dim=1).contiguous()


def segment_plan(dst: torch.Tensor, num_segments: int) -> SegmentPlan:
    """K24's plan of a shard's sorted dst (`SegmentPlan`): offs by binary
    search (K24's offsets kernel on the card), tiles and tasks cut from
    them with a few tensor operations on dst's device."""
    if _cuda.on_card(dst):
        if dst.dtype is not torch.int32 or dst.dim() != 1 or \
                not dst.is_contiguous():
            raise _cuda.input_error("shard_reduce", "dst", dst, torch.int32)
        offs = torch.empty(num_segments + 1, dtype=torch.int64,
                           device=dst.device)
        _OFFSETS.launch(dst.get_device(), _cuda.ptr(dst), dst.numel(),
                        num_segments, _cuda.ptr(offs))
    else:
        offs = torch.searchsorted(
            dst, torch.arange(num_segments + 1, dtype=torch.int32,
                              device=dst.device)).to(torch.int64)
    width = offs[1:] - offs[:-1]
    tiles, tasks = _tiles(width), _tasks(offs, width)
    n_tasks = tasks.shape[0]
    scratch = torch.zeros(2 * n_tasks, dtype=torch.int32, device=dst.device)
    table = np.array([offs.data_ptr(), tiles.data_ptr(), tiles.shape[0],
                      tasks.data_ptr(), n_tasks, scratch.data_ptr(),
                      scratch.data_ptr() + 4 * n_tasks], dtype=np.int64)
    return SegmentPlan(offs, tiles, tasks, scratch, num_segments, table,
                       table.ctypes.data)


def shard_reduce(form: str, src, dst, mask, x, num_segments: int, w=None,
                 xs=None, plan: SegmentPlan | None = None) -> torch.Tensor:
    """One shard's partial over num_segments segments: gather x[src]
    (clipped to x's range), combine with w (and xs[src]: on the card the
    product x * xs is taken once a node first, the same bits), neutralise
    masked edges, reduce by the sorted dst.  form: "or" (int32 max, clamped at 0),
    "sum" (float32 x[src] * xs[src] * w), "minplus" (float32 min of
    x[src] + w) or "min" (int32 min, masked 2^30).  On the card one launch
    over `plan` (made here when not given; the mesh drivers cache one a
    sharding)."""
    f = FORMS[form]
    if not _cuda.on_card(x, src, dst, mask, w, xs):
        return shard_reduce_plain(f, src, dst, mask, x, num_segments, w, xs)
    fdt = torch.float32 if f in (SUM, MINPLUS) else torch.int32
    i32, f32 = torch.int32, torch.float32
    for name, t, dt in (("src", src, i32), ("dst", dst, i32),
                        ("mask", mask, i32), ("x", x, fdt), ("w", w, f32),
                        ("xs", xs, f32)):
        if t is not None and (t.dtype is not dt or t.dim() != 1 or
                              not t.is_contiguous()):
            raise _cuda.input_error("shard_reduce", name, t, dt)
    if f == MINPLUS and w is None:
        raise ValueError("shard_reduce: minplus needs w")
    if f != SUM and xs is not None:
        raise ValueError("shard_reduce: xs is for the sum form only")
    per = src.numel()
    if dst.numel() != per or mask.numel() != per or (
            w is not None and w.numel() != per) or (
            xs is not None and xs.numel() != x.numel()):
        raise ValueError("shard_reduce: operands of different lengths")
    if plan is None:
        plan = segment_plan(dst, num_segments)
    if plan.num_segments != num_segments:
        raise ValueError("shard_reduce: plan for another segment count")
    dev = x.get_device()
    if plan.offs.get_device() != dev:
        raise ValueError("shard_reduce: plan for another device")
    out = torch.empty(num_segments, dtype=fdt, device=x.device)
    c = torch.empty_like(x) if xs is not None else None  # c = x * xs
    p = _cuda.ptr
    _REDUCE.launch(dev, f, src.data_ptr(), mask.data_ptr(), p(w),
                   x.data_ptr(), p(xs), x.numel(), p(c), plan.table_ptr,
                   out.data_ptr())
    return out


def shard_reduce_plain(f, src, dst, mask, x, num_segments, w=None, xs=None):
    """Plain PyTorch version of `shard_reduce` (the reference's take with
    mode="clip", where, and sorted segment reduce; segment ids outside
    [0, num_segments) are dropped, as XLA's are)."""
    idx = src.to(torch.int64).clamp(0, max(x.numel() - 1, 0))
    on = mask > 0
    seg = dst.to(torch.int64)
    keep = (seg >= 0) & (seg < num_segments)
    if f == OR:
        g = torch.where(on, x[idx], torch.zeros((), dtype=x.dtype))
        out = torch.zeros(num_segments, dtype=x.dtype, device=x.device)
        return out.scatter_reduce(0, seg[keep], g[keep], "amax")
    if f == SUM:
        v = x[idx] if xs is None else x[idx] * xs[idx]
        g = v * w if w is not None else v
        g = torch.where(on, g, torch.zeros((), dtype=g.dtype))
        out = torch.zeros(num_segments, dtype=x.dtype, device=x.device)
        return out.index_add(0, seg[keep], g[keep])
    if f == MINPLUS:
        inf = torch.full((), float("inf"), dtype=x.dtype)
        g = torch.where(on, x[idx] + w, inf)
        out = torch.full((num_segments,), float("inf"), dtype=x.dtype,
                         device=x.device)
        return out.scatter_reduce(0, seg[keep], g[keep], "amin")
    g = torch.where(on, x[idx], torch.full((), BIG, dtype=x.dtype))
    out = torch.full((num_segments,), INT32_MAX, dtype=x.dtype,
                     device=x.device)
    return out.scatter_reduce(0, seg[keep], g[keep], "amin")


# -- K25: the bit-packed frontier -------------------------------------------


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(32 k,) int32 -> (k,) uint32, little-endian within a word: the
    uint32 sum of bits[32 w + i] << i (an OR for 0/1)."""
    if bits.numel() % 32:
        raise ValueError("pack_bits: length not a multiple of 32")
    if not _cuda.on_cuda(bits):
        return pack_bits_plain(bits)
    _cuda.check_input("mesh_bits", "bits", bits, torch.int32)
    words = torch.empty(bits.numel() // 32, dtype=torch.uint32,
                        device=bits.device)
    _launch("mesh_bits", _cuda.lib().fk_mesh_pack, bits, _cuda.ptr(bits),
            words.numel(), _cuda.ptr(words))
    return words


def pack_bits_plain(bits):
    b = bits.to(torch.int64).reshape(-1, 32) & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    s = ((b << shifts) & 0xFFFFFFFF).sum(dim=1) & 0xFFFFFFFF
    return s.to(torch.uint32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(k,) uint32 -> (32 k,) int32 0/1."""
    if not _cuda.on_cuda(words):
        return unpack_bits_plain(words)
    _cuda.check_input("mesh_bits", "words", words, torch.uint32)
    bits = torch.empty(words.numel() * 32, dtype=torch.int32,
                       device=words.device)
    _launch("mesh_bits", _cuda.lib().fk_mesh_unpack, words, _cuda.ptr(words),
            words.numel(), _cuda.ptr(bits))
    return bits


def unpack_bits_plain(words):
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    b = (words.to(torch.int64)[:, None] >> shifts) & 1
    return b.to(torch.int32).reshape(-1)


def or_fold(blocks: torch.Tensor, nblk: int) -> torch.Tensor:
    """(nblk * blk,) uint32 -> (blk,): the OR of the nblk blocks."""
    blk = blocks.numel() // nblk
    if not _cuda.on_cuda(blocks):
        return or_fold_plain(blocks, nblk)
    _cuda.check_input("mesh_bits", "blocks", blocks, torch.uint32,
                      nblk * blk)
    out = torch.empty(blk, dtype=torch.uint32, device=blocks.device)
    _launch("mesh_bits", _cuda.lib().fk_mesh_or_fold, blocks,
            _cuda.ptr(blocks), nblk, blk, _cuda.ptr(out))
    return out


def or_fold_plain(blocks, nblk):
    # in int64: torch has no uint32 bitwise ops on the card
    b = blocks.to(torch.int64).reshape(nblk, -1)
    out = b[0]
    for k in range(1, nblk):
        out = out | b[k]
    return out.to(torch.uint32)


def bits_epilogue(reach: torch.Tensor, levels: torch.Tensor, d: int):
    """fresh = reach & ~pack(levels >= 0); levels = d + 1 where a fresh bit
    meets levels == -1.  Returns (fresh words, new levels, any) with any a
    one-element int32 tensor: 1 where a fresh word is not 0."""
    if levels.numel() != 32 * reach.numel():
        raise ValueError("bits_epilogue: levels must hold 32 per word")
    if not _cuda.on_cuda(reach, levels):
        return bits_epilogue_plain(reach, levels, d)
    _cuda.check_input("mesh_bits", "reach", reach, torch.uint32)
    _cuda.check_input("mesh_bits", "levels", levels, torch.int32)
    fresh = torch.empty_like(reach)
    out = torch.empty_like(levels)
    anyf = torch.empty(1, dtype=torch.int32, device=levels.device)
    p = _cuda.ptr
    _launch("mesh_bits", _cuda.lib().fk_mesh_bits_epilogue, levels, p(reach),
            p(levels), reach.numel(), d + 1, p(fresh), p(out), p(anyf))
    return fresh, out, anyf


def bits_epilogue_plain(reach, levels, d):
    # in int64: torch has few uint32 bitwise ops
    visited = pack_bits_plain((levels >= 0).to(torch.int32)).to(torch.int64)
    fresh = reach.to(torch.int64) & ~visited
    hit = (unpack_bits_plain(fresh) > 0) & (levels == -1)
    out = torch.where(hit, torch.full((), d + 1, dtype=levels.dtype,
                                      device=levels.device), levels)
    return (fresh.to(torch.uint32), out,
            (fresh != 0).any().to(torch.int32).reshape(1))


# -- K26: vector updates after a collective --------------------------------

_BFS_UPDATE = _cuda.Entry("fk_mesh_bfs_update", "mesh_update")
_MIN_UPDATE = _cuda.Entry("fk_mesh_min_update", "mesh_update")
_DOT = _cuda.Entry("fk_mesh_dot", "mesh_update")
_PR_UPDATE = _cuda.Entry("fk_mesh_pagerank_update", "mesh_update")
_SCRATCH: dict = {}  # CUDA device index -> K26's scratch there


def _scratch(dev: int) -> int:
    """The address of K26's scratch on CUDA device `dev` (csrc/
    mesh_update.cu `Scratch`: the block partials, the ticket, a count and
    a flag), zeroed once at its first use there: every launch leaves it
    zero again.  Launches share it in stream order, so K26 runs on one
    stream a device at a time, as the mesh drivers run it."""
    t = _SCRATCH.get(dev)
    if t is None:
        words = -(-_cuda.lib().fk_mesh_scratch_bytes() // 4)
        t = _SCRATCH[dev] = torch.zeros(words, dtype=torch.int32,
                                        device=torch.device("cuda", dev))
    return t.data_ptr()


def _vec(name, t, dtype, n):
    """Raise unless t is a contiguous 1-d tensor of n `dtype` (None passes)."""
    if t is not None and (t.dtype != dtype or t.dim() != 1 or t.numel() != n
                          or not t.is_contiguous()):
        raise _cuda.input_error("mesh_update", name, t, dtype, n)


def bfs_update(reach: torch.Tensor, levels: torch.Tensor, depth: int,
               with_levels: bool = True):
    """fresh = (levels < 0) & (reach > 0) as int32; levels set to depth
    where fresh (None unless with_levels); count, a one-element int32 tensor
    of the fresh nodes."""
    if not _cuda.on_card(reach, levels):
        return bfs_update_plain(reach, levels, depth, with_levels)
    n = reach.numel()
    _vec("reach", reach, torch.int32, n)
    _vec("levels", levels, torch.int32, n)
    dev = levels.get_device()
    fresh = torch.empty_like(levels)
    out = torch.empty_like(levels) if with_levels else None
    count = torch.empty(1, dtype=torch.int32, device=levels.device)
    _BFS_UPDATE.launch(dev, reach.data_ptr(), levels.data_ptr(), n, depth,
                       fresh.data_ptr(), None if out is None
                       else out.data_ptr(), _scratch(dev), count.data_ptr())
    return fresh, out, count


def bfs_update_plain(reach, levels, depth, with_levels=True):
    fresh = ((levels < 0) & (reach > 0)).to(torch.int32)
    out = (torch.where(fresh > 0, torch.full((), depth, dtype=levels.dtype),
                       levels) if with_levels else None)
    return fresh, out, fresh.sum().to(torch.int32).reshape(1)


def min_update(old: torch.Tensor, blocks: torch.Tensor):
    """new = min(old, min over the (k, n) blocks); changed, a one-element
    int32 tensor: 1 where some value dropped."""
    n = old.numel()
    if blocks.numel() % max(n, 1):
        raise ValueError("min_update: blocks must be whole vectors")
    if not _cuda.on_card(old, blocks):
        return min_update_plain(old, blocks)
    if old.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"min_update: no kernel for {old.dtype}")
    _vec("old", old, old.dtype, n)
    flat = blocks.reshape(-1)
    _vec("blocks", flat, old.dtype, flat.numel())
    dev = old.get_device()
    out = torch.empty_like(old)
    changed = torch.empty(1, dtype=torch.int32, device=old.device)
    _MIN_UPDATE.launch(dev, int(old.dtype == torch.float32), old.data_ptr(),
                       flat.data_ptr(), flat.numel() // max(n, 1), n,
                       out.data_ptr(), _scratch(dev), changed.data_ptr())
    return out, changed


def min_update_plain(old, blocks):
    best = blocks.reshape(-1, old.numel()).amin(dim=0)
    new = torch.minimum(old, best)
    return new, (new < old).any().to(torch.int32).reshape(1)


def dot_sum(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """sum(a * b) (or sum(a)) in float32, in a fixed order on the card: a
    one-element tensor."""
    if not _cuda.on_card(a, b):
        return (a * b if b is not None else a).sum().reshape(1)
    n = a.numel()
    _vec("a", a, torch.float32, n)
    _vec("b", b, torch.float32, n)
    dev = a.get_device()
    out = torch.empty(1, dtype=torch.float32, device=a.device)
    _DOT.launch(dev, a.data_ptr(), None if b is None else b.data_ptr(), n,
                _scratch(dev), out.data_ptr())
    return out


def pagerank_update(acc, rank, dsum, n_total: int, damping: float,
                    val=None, l1: bool = False):
    """new = (1-d)/n + d * (acc + dsum/n) in float32 (times val where
    given); with l1, also sum(|new - rank|) as a one-element tensor, else
    None.  dsum: a one-element float32 tensor, the dangling sum."""
    if not _cuda.on_card(acc, rank, dsum, val):
        return pagerank_update_plain(acc, rank, dsum, n_total, damping, val,
                                     l1)
    n = acc.numel()
    _vec("acc", acc, torch.float32, n)
    _vec("rank", rank, torch.float32, n)
    _vec("val", val, torch.float32, n)
    if dsum.dtype != torch.float32 or dsum.numel() != 1:
        raise _cuda.input_error("mesh_update", "dsum", dsum, torch.float32, 1,
                                None)
    dev = acc.get_device()
    out = torch.empty_like(acc)
    l1_out = torch.empty(1, dtype=torch.float32, device=acc.device) \
        if l1 else None
    _PR_UPDATE.launch(dev, acc.data_ptr(), rank.data_ptr(),
                      None if val is None else val.data_ptr(),
                      dsum.data_ptr(), n, n_total, (1.0 - damping) / n_total,
                      damping, out.data_ptr(), _scratch(dev),
                      None if l1_out is None else l1_out.data_ptr())
    return out, l1_out


def pagerank_update_plain(acc, rank, dsum, n_total, damping, val=None,
                          l1=False):
    f32 = torch.float32
    base = torch.tensor((1.0 - damping) / n_total, dtype=f32)
    d = torch.tensor(damping, dtype=f32)
    new = base + d * (acc + dsum / torch.tensor(float(n_total), dtype=f32))
    if val is not None:
        new = val * new
    return new, ((new - rank).abs().sum().reshape(1) if l1 else None)
