"""Gather probes of falkordb_tpu_torch on one CUDA card: the port's
counterpart of scripts/prof_pallas_gather.py and scripts/prof_pallas_gather2.py.

    python3 bench_port_gather.py

What does a random gather cost on this card?  The reference's probes asked
it of a TPU's VMEM; here they run as hand-written kernels (falkordb_tpu_torch
.probes: K27-K30) at the reference's own shapes, the lists of both scripts'
main():

  A_sanity        x * 2 over (8, 128) int32                         (K27)
  B_stream        the column OR of 512 MiB of ones, (8192, 16384)   (K27)
  C_take          tab[idx], tab 2^19 int32 words (2 MB), 2^22 idx   (K28)
  D_bittest       packed-frontier bit tests, n = 2^20 bits, 2^22 idx (K29)
  E_gather2d      the lane gather over (4096, 128), 2^22 idx, reps 8 (K30)
  D_bittest_24    D at n = 2^24 bits (a 2 MB table)
  E_gather2d_r32  E at reps 32
  VAR <name>      gather2's nine take_along_axis forms                (K30)

and, beside them, C and D once more at a table past the 50 MB L2 (the same
functions at a larger size argument, as the reference's main varies D's):
C_take_hbm at 2^25 words (128 MiB) and D_bittest_30 at n = 2^30 bits (128
MiB), the size of K9's frontiers, which live in device memory.

Inputs are the reference's: numpy generators of the same seeds, drawn in
the same order, built by one builder a probe (PROBES), which chip_smoke.py's
kernel checks share.  Each result is held against its wrapper's plain
version on the same card tensors, bit for bit, and against the reference's
numpy oracle (B: every column of the OR is 1; a variant with reps > 1
against its OR chain, where the reference printed correct=n/a).  Times:
CUDA events, the best of 5 launches (of 3 for the variants, as the
reference) after a warm-up; with the table in L2 after the warm-up, as the
reference's VMEM table stayed resident.

Prints one `PROBE <name>: OK ...` or `VAR <name>: OK correct=...` line a
probe in the reference's words, each followed by the rate over the bytes
the probe must move (indices and output once, the table once) against the
H100 SXM's 3.35 TB/s, and, for gathers, over the 32-byte sectors its
gathered words touch; the card's name and power limit (nvidia-smi) head
the output.  No card: exits non-zero with no metric.  Exit 1 if a probe
fails or disagrees with its plain version or its oracle.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable

import numpy as np
import torch

from bench_port_kernels import nvidia_smi
from falkordb_tpu_torch import probes as P

ROOF = 3.35e12  # H100 SXM device memory rate, bytes/s (data sheet)
SECTOR = 32  # bytes the memory system moves for one gathered word


@dataclasses.dataclass
class Result:
    kind: str  # "PROBE" or "VAR"
    name: str
    correct: bool
    ms: float
    text: str  # the reference's words after "OK "
    model_bytes: int  # indices + output + table, each once
    sector_bytes: int = 0  # indices + output + 32 B a gathered word
    error: str = ""

    def line(self, card: str) -> str:
        if self.error:
            return f"{self.kind} {self.name}: FAIL {self.error}"
        gbps = self.model_bytes / (self.ms * 1e-3) / 1e9
        tail = (f" | {gbps:.1f} GB/s of bytes once = "
                f"{gbps * 1e9 / ROOF:.2%} of {ROOF / 1e9:.0f} GB/s")
        if self.sector_bytes:
            tail += (f", {self.sector_bytes / (self.ms * 1e-3) / 1e9:.1f} "
                     f"GB/s in sectors")
        head = "OK " if self.kind == "PROBE" else "OK correct="
        return f"{self.kind} {self.name}: {head}{self.text}{tail} | {card}"


def best_ms(fn, reps: int) -> float:
    """The best of `reps` CUDA-event times of fn(), after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def _on(dev, a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@dataclasses.dataclass
class Case:
    """One probe: its inputs on `dev`, the wrapper and its plain version,
    the reference's numpy oracle of the output, the bytes it must move
    (indices and output once, the table once), the bytes of the 32-byte
    sectors its gathered words touch (0 for the streaming probes), and
    words(ok, ms), the reference's words for its line."""
    kernel: str  # the wrapper's launch counter (native/cuda.py KERNELS)
    fn: Callable
    plain: Callable
    args: tuple
    want: np.ndarray
    model_bytes: int
    sector_bytes: int
    words: Callable[[bool, float], str]

    def run(self) -> torch.Tensor:
        return self.fn(*self.args)

    def run_plain(self) -> torch.Tensor:
        return self.plain(*self.args)

    def shape(self) -> str:
        return ", ".join(str(tuple(a.shape)) if torch.is_tensor(a) else
                         str(a) for a in self.args)

    def held(self) -> bool:
        """The wrapper's output equals its plain version's on the same
        tensors, bit for bit, and the numpy oracle."""
        got = self.run()
        return torch.equal(got, self.run_plain()) and np.array_equal(
            got.cpu().numpy(), self.want)


def _rate_words(unit: str, nel: int, extra: str = ""):
    """The reference's `correct=... G<unit>/s (... ns/<unit>)` words."""
    def words(ok, ms):
        dt = ms * 1e-3
        return (f"correct={ok} {nel / dt / 1e9:.2f} G{unit}/s "
                f"({dt / nel * 1e9:.4f} ns/{unit}{extra})")
    return words


# -- prof_pallas_gather.py -------------------------------------------------------


def sanity_case(dev) -> Case:
    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128)
    return Case("probe_stream", P.double, P.double_plain, (_on(dev, x),),
                x * 2, 2 * x.size * 4, 0,
                lambda ok, ms: "correct" if ok else "incorrect")


def stream_case(dev, total_mb=512, seed=None) -> Case:
    """B: (total_mb MiB / 64 KiB, 16384) int32 of the reference's ones, or,
    with a seed, of words of one random bit, about 16 a column and the rest
    zero, so that the column OR is a random word (ones, or dense random
    words, OR to one value in every column)."""
    n = total_mb * (1 << 20) // 4
    blk = 512 * 1024 // 4
    shape = (n // blk * 8, blk // 8)
    if seed is None:
        x = torch.ones(shape, dtype=torch.int32, device=dev)
        want = np.ones(shape[1], dtype=np.int32)
    else:
        g = torch.Generator(device=dev).manual_seed(seed)
        bit = torch.randint(0, 32, shape, generator=g, device=dev,
                            dtype=torch.int32)
        keep = torch.rand(shape, generator=g, device=dev) < 16 / shape[0]
        x = torch.where(keep, torch.ones_like(bit) << bit,
                        torch.zeros_like(bit))
        del bit, keep
        want = np.bitwise_or.reduce(x.cpu().numpy(), axis=0)
    nbytes = x.numel() * 4
    return Case("probe_stream", P.or_rows, P.or_rows_plain, (x,), want,
                nbytes + shape[1] * 4, 0,
                lambda ok, ms: f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s read "
                               f"correct={ok}")


def take_case(dev, tab_words=1 << 19, nidx=1 << 22, seed=0) -> Case:
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, 1 << 30, tab_words, dtype=np.int32)
    idx = rng.integers(0, tab_words, nidx, dtype=np.int32).reshape(-1, 512)
    return Case("probe_take", P.take, P.take_plain,
                (_on(dev, tab), _on(dev, idx)), tab[idx],
                8 * nidx + 4 * tab_words, (8 + SECTOR) * nidx,
                _rate_words("elem", nidx))


def bittest_case(dev, n_nodes=1 << 24, nidx=1 << 22, seed=1) -> Case:
    rng = np.random.default_rng(seed)
    words = n_nodes // 32
    tab = rng.integers(0, 1 << 30, words, dtype=np.int32)
    idx = rng.integers(0, n_nodes, nidx, dtype=np.int32).reshape(-1, 512)
    bits = (tab[idx >> 5] >> (idx & 31)) & 1
    want = bits.reshape(-1, 4, 128).sum(axis=1)
    out_bytes = want.size * 4
    return Case("probe_bittest", P.bittest, P.bittest_plain,
                (_on(dev, tab), _on(dev, idx)), want,
                4 * nidx + out_bytes + 4 * words,
                (4 + SECTOR) * nidx + out_bytes, _rate_words("edge", nidx))


def gather2d_case(dev, rows=4096, nidx=1 << 22, reps=8, seed=2) -> Case:
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, 1 << 30, (rows, 128), dtype=np.int32)
    idx = rng.integers(0, rows, nidx, dtype=np.int32).reshape(-1, 512)
    lane = np.arange(512) % 128
    want = np.zeros_like(idx)
    for k in range(reps):
        want |= tab[(idx + k) & (rows - 1), lane[None, :]]
    return Case("probe_lane_gather", P.take_along_or, P.take_along_or_plain,
                (_on(dev, tab), _on(dev, idx), 0, reps), want,
                8 * nidx + tab.size * 4, 8 * nidx + SECTOR * nidx * reps,
                _rate_words("elem", nidx * reps, f", reps={reps}"))


# -- prof_pallas_gather2.py ------------------------------------------------------


def variant_case(dev, src_shape, idx_rows, axis, reps=1) -> Case:
    rng = np.random.default_rng(0)
    src = rng.integers(0, 100, src_shape, dtype=np.int32)
    lim = src_shape[axis]
    idx_shape = (idx_rows, src_shape[1]) if axis == 0 \
        else (src_shape[0], idx_rows)
    idx = rng.integers(0, lim, idx_shape, dtype=np.int32)
    want = np.take_along_axis(src, idx, axis=axis)
    for k in range(1, reps):
        want = want | np.take_along_axis(src, (idx + k) & (lim - 1),
                                         axis=axis)
    nel = idx.size * reps
    return Case("probe_lane_gather", P.take_along_or, P.take_along_or_plain,
                (_on(dev, src), _on(dev, idx), axis, reps), want,
                8 * idx.size + 4 * src.size, 8 * idx.size + SECTOR * nel,
                lambda ok, ms: f"{ok} {nel / (ms * 1e-3) / 1e9:.3f} Gelem/s "
                               f"({ms:.4f} ms total)")


VARIANTS = (  # prof_pallas_gather2.py:81-92
    ("sameshape_8x128_ax0", (8, 128), 8, 0, 1),
    ("sameshape_512x128_ax0", (512, 128), 512, 0, 1),
    ("sameshape_4096x128_ax0", (4096, 128), 4096, 0, 1),
    ("tall_idx8_tab512_ax0", (512, 128), 8, 0, 1),
    ("tall_idx512_tab4096_ax0", (4096, 128), 512, 0, 1),
    ("ax1_8x128", (8, 128), 128, 1, 1),
    ("ax1_8x2048", (8, 2048), 2048, 1, 1),
    ("perf_4096x128_r16", (4096, 128), 4096, 0, 16),
    ("perf_4096x128_r64", (4096, 128), 4096, 0, 64),
)

# (kind, name, build(dev) -> Case): the reference scripts' main() lists in
# their order, then C and D at tables past the L2
PROBES = (
    ("PROBE", "A_sanity", sanity_case),
    ("PROBE", "B_stream", lambda dev: stream_case(dev, 512)),
    ("PROBE", "C_take", lambda dev: take_case(dev, nidx=1 << 22)),
    ("PROBE", "D_bittest", lambda dev: bittest_case(dev, n_nodes=1 << 20)),
    ("PROBE", "E_gather2d", gather2d_case),
    ("PROBE", "D_bittest_24", lambda dev: bittest_case(dev, n_nodes=1 << 24)),
    ("PROBE", "E_gather2d_r32", lambda dev: gather2d_case(dev, reps=32)),
) + tuple(("VAR", v[0], lambda dev, v=v: variant_case(dev, *v[1:]))
          for v in VARIANTS) + (
    ("PROBE", "C_take_hbm", lambda dev: take_case(dev, tab_words=1 << 25)),
    ("PROBE", "D_bittest_30", lambda dev: bittest_case(dev,
                                                       n_nodes=1 << 30)),
)


def run(dev, card: str) -> list:
    """Every probe once, each line printed as it ends; the Results."""
    results = []
    for kind, name, build in PROBES:
        try:
            c = build(dev)
            ok = c.held()
            ms = best_ms(c.run, 3 if kind == "VAR" else 5)
            r = Result(kind, name, ok, ms, c.words(ok, ms), c.model_bytes,
                       c.sector_bytes)
            del c
        except Exception as e:  # noqa: BLE001 - the reference's FAIL line
            msg = str(e).split("\n")[0][:300]
            r = Result(kind, name, False, float("nan"), "", 0,
                       error=f"{type(e).__name__}: {msg}")
        print(r.line(card), flush=True)
        results.append(r)
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_port_gather: no CUDA device; no measurement",
              file=sys.stderr)
        return 1
    card = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | roof "
          f"{ROOF / 1e9:.0f} GB/s", flush=True)
    results = run(torch.device("cuda", 0), card)
    return 0 if all(r.correct for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
