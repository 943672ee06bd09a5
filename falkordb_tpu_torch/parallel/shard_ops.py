"""The per-shard kernels of the mesh drivers (parallel/dist.py): K24, the
gather and sorted segment reduce of one edge shard (csrc/shard_reduce.cu);
K25, the bit-packed frontier (csrc/mesh_bits.cu); K26, the updates of a node
vector after a collective (csrc/mesh_update.cu).

Each wrapper takes the plain PyTorch version beside it for CPU tensors and
launches its kernel for CUDA tensors, on the tensors' own device (a ctypes
launch runs on the current device, so each call enters
torch.cuda.device).  Nothing is written in place."""

from __future__ import annotations

import dataclasses

import torch

from falkordb_tpu_torch.native import cuda as _cuda

OR, SUM, MINPLUS, MIN = 0, 1, 2, 3
FORMS = {"or": OR, "sum": SUM, "minplus": MINPLUS, "min": MIN}
BIG = 2**30  # what a masked edge gives the MIN form
INT32_MAX = 2**31 - 1
SHORT_MAX = 32  # a thread a segment up to here, a warp up to LONG_MIN
LONG_MIN = 1024  # wider segments take a block
SUM_BLOCKS = 1024  # K26's fixed grid for float sums


def _launch(name, fn, t, *args):
    """Call entry point `fn` on t's device and stream; count the launch."""
    with torch.cuda.device(t.device):
        rc = fn(*args, _cuda.stream_ptr(t))
    _cuda.check(rc, name)
    _cuda.count_launch(name)


# -- K24: the shard's segment reduce ----------------------------------------


@dataclasses.dataclass
class SegmentPlan:
    """A shard's segments over its sorted dst, found once a sharding:
    offs (num_segments + 1,) int64, and the ids of the segments a warp
    (mid) and a block (long) reduce."""
    offs: torch.Tensor
    mid: torch.Tensor
    long: torch.Tensor
    num_segments: int


def segment_plan(dst: torch.Tensor, num_segments: int) -> SegmentPlan:
    """offs[s] = the first edge whose dst >= s (binary search over the
    shard's sorted dst: K24's offsets kernel on the card)."""
    if _cuda.on_cuda(dst):
        _cuda.check_input("shard_reduce", "dst", dst, torch.int32)
        offs = torch.empty(num_segments + 1, dtype=torch.int64,
                           device=dst.device)
        _launch("shard_reduce", _cuda.lib().fk_shard_offsets, dst,
                _cuda.ptr(dst), dst.numel(), num_segments, _cuda.ptr(offs))
    else:
        offs = torch.searchsorted(
            dst, torch.arange(num_segments + 1, dtype=torch.int32,
                              device=dst.device)).to(torch.int64)
    width = offs[1:] - offs[:-1]
    mid = torch.nonzero((width > SHORT_MAX) & (width <= LONG_MIN))[:, 0]
    lng = torch.nonzero(width > LONG_MIN)[:, 0]
    return SegmentPlan(offs, mid.contiguous(), lng.contiguous(), num_segments)


def shard_reduce(form: str, src, dst, mask, x, num_segments: int, w=None,
                 xs=None, plan: SegmentPlan | None = None) -> torch.Tensor:
    """One shard's partial over num_segments segments: gather x[src]
    (clipped to x's range), combine with w (and xs[src]), neutralise masked
    edges, reduce by the sorted dst.  form: "or" (int32 max, clamped at 0),
    "sum" (float32 x[src] * xs[src] * w), "minplus" (float32 min of
    x[src] + w) or "min" (int32 min, masked 2^30)."""
    f = FORMS[form]
    if not _cuda.on_cuda(src, dst, mask, x, w, xs):
        return shard_reduce_plain(f, src, dst, mask, x, num_segments, w, xs)
    fdt = torch.float32 if f in (SUM, MINPLUS) else torch.int32
    for name, t, dt in (("src", src, torch.int32), ("dst", dst, torch.int32),
                        ("mask", mask, torch.int32), ("x", x, fdt),
                        ("w", w, torch.float32), ("xs", xs, torch.float32)):
        _cuda.check_input("shard_reduce", name, t, dt)
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
    out = torch.empty(num_segments, dtype=fdt, device=x.device)
    p = _cuda.ptr
    _launch("shard_reduce", _cuda.lib().fk_shard_reduce, x, f, p(src),
            p(mask), p(w), p(x), p(xs), x.numel(), p(plan.offs),
            num_segments, SHORT_MAX, p(plan.mid), plan.mid.numel(),
            p(plan.long), plan.long.numel(), p(out))
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


def bfs_update(reach: torch.Tensor, levels: torch.Tensor, depth: int,
               with_levels: bool = True):
    """fresh = (levels < 0) & (reach > 0) as int32; levels set to depth
    where fresh (None unless with_levels); count, a one-element int32 tensor
    of the fresh nodes."""
    if not _cuda.on_cuda(reach, levels):
        return bfs_update_plain(reach, levels, depth, with_levels)
    _cuda.check_input("mesh_update", "reach", reach, torch.int32)
    _cuda.check_input("mesh_update", "levels", levels, torch.int32,
                      reach.numel())
    fresh = torch.empty_like(levels)
    out = torch.empty_like(levels) if with_levels else None
    count = torch.empty(1, dtype=torch.int32, device=levels.device)
    p = _cuda.ptr
    _launch("mesh_update", _cuda.lib().fk_mesh_bfs_update, levels, p(reach),
            p(levels), levels.numel(), depth, p(fresh), p(out), p(count))
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
    if not _cuda.on_cuda(old, blocks):
        return min_update_plain(old, blocks)
    if old.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"min_update: no kernel for {old.dtype}")
    _cuda.check_input("mesh_update", "old", old, old.dtype)
    _cuda.check_input("mesh_update", "blocks", blocks.reshape(-1), old.dtype)
    out = torch.empty_like(old)
    changed = torch.empty(1, dtype=torch.int32, device=old.device)
    p = _cuda.ptr
    _launch("mesh_update", _cuda.lib().fk_mesh_min_update, old,
            int(old.dtype == torch.float32), p(old), p(blocks),
            blocks.numel() // max(n, 1), n, p(out), p(changed))
    return out, changed


def min_update_plain(old, blocks):
    best = blocks.reshape(-1, old.numel()).amin(dim=0)
    new = torch.minimum(old, best)
    return new, (new < old).any().to(torch.int32).reshape(1)


def dot_sum(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """sum(a * b) (or sum(a)) in float32, in a fixed order on the card: a
    one-element tensor."""
    if not _cuda.on_cuda(a, b):
        return (a * b if b is not None else a).sum().reshape(1)
    _cuda.check_input("mesh_update", "a", a, torch.float32)
    _cuda.check_input("mesh_update", "b", b, torch.float32, a.numel())
    partial = torch.empty(SUM_BLOCKS, dtype=torch.float32, device=a.device)
    out = torch.empty(1, dtype=torch.float32, device=a.device)
    p = _cuda.ptr
    _launch("mesh_update", _cuda.lib().fk_mesh_dot, a, p(a), p(b), a.numel(),
            p(partial), p(out))
    return out


def pagerank_update(acc, rank, dsum, n_total: int, damping: float,
                    val=None, l1: bool = False):
    """new = (1-d)/n + d * (acc + dsum/n) in float32 (times val where
    given); with l1, also sum(|new - rank|) as a one-element tensor, else
    None.  dsum: a one-element float32 tensor, the dangling sum."""
    base = (1.0 - damping) / n_total
    if not _cuda.on_cuda(acc, rank, dsum, val):
        return pagerank_update_plain(acc, rank, dsum, n_total, damping, val,
                                     l1)
    for name, t in (("acc", acc), ("rank", rank), ("val", val)):
        _cuda.check_input("mesh_update", name, t, torch.float32, acc.numel())
    _cuda.check_input("mesh_update", "dsum", dsum, torch.float32, 1)
    out = torch.empty_like(acc)
    partial = (torch.empty(SUM_BLOCKS, dtype=torch.float32,
                           device=acc.device) if l1 else None)
    l1_out = torch.empty(1, dtype=torch.float32, device=acc.device) \
        if l1 else None
    p = _cuda.ptr
    _launch("mesh_update", _cuda.lib().fk_mesh_pagerank_update, acc, p(acc),
            p(rank), p(val), p(dsum), acc.numel(), n_total, base, damping,
            p(out), p(partial), p(l1_out))
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
