"""K3 (top-k, csrc/topk.cu) on the card against its plain PyTorch version,
`topk_smallest_plain` (a stable sort), with torch.equal: the radix select
must give the same indices, ties to the lower index, at every k from 1 to
n, with all keys equal, with keys that differ only in their lowest mantissa
bits (every radix pass runs), with -0.0 beside +0.0 and +-inf, and at n
that is no multiple of any block size.

The kernel has no CPU mode, so these tests skip without a card.  This file
imports neither JAX nor falkordb_tpu (the card's machine has no JAX), and
tests/conftest.py does, so run it there with the conftest off:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels_card.py
"""

import numpy as np
import pytest
import torch

from falkordb_tpu_torch.native import cuda
from falkordb_tpu_torch.runtime.ops import (TOPK_MAX_K, topk_smallest,
                                            topk_smallest_plain)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cuda.reset_launches()
    yield torch.device("cuda", 0)
    cuda.reset_launches()


def keys(kind, n, rng):
    if kind == "ties":
        return rng.integers(0, 50, n).astype(np.float64)
    if kind == "equal":
        return np.full(n, 2.5)
    if kind == "ulps":  # one exponent, the last 3 mantissa bits differ
        return 1.0 + rng.integers(0, 8, n) * np.finfo(np.float64).eps
    if kind == "zeros_inf":  # -0.0 beside +0.0, nulls folded in as +-inf
        return rng.choice([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0], n)
    if kind == "normal":
        return rng.standard_normal(n)
    raise ValueError(kind)


def hold(c, k):
    got = topk_smallest(c, k)
    torch.cuda.synchronize()
    want = topk_smallest_plain(c, k)
    assert got.dtype == torch.int64 and got.shape == (k,)
    assert torch.equal(got, want), f"n={c.numel()} k={k}"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ties", "equal", "ulps", "zeros_inf",
                                  "normal"])
@pytest.mark.parametrize("n", [1, 3000, 4097, 20_011, 430_000])
def test_card_topk_equals_plain(kind, n, dev):
    rng = np.random.default_rng(n)
    c = torch.from_numpy(keys(kind, n, rng)).to(dev)
    for k in sorted({1, 10, TOPK_MAX_K - 1, TOPK_MAX_K}):
        if k <= n:
            hold(c, k)
    if n <= TOPK_MAX_K:
        hold(c, n)  # k = n: every key survives
    assert cuda.KERNELS["topk"].launches > 0


@pytest.mark.cuda
def test_card_topk_mantissa_and_signs(dev):
    """Keys one ulp apart at every scale, both signs, so that the select
    narrows through all six digits; a view at an offset of 8 bytes."""
    rng = np.random.default_rng(7)
    base = rng.choice([-3e-300, -1.0, 0.5, 7e10, 1e308], 12_345)
    steps = rng.integers(0, 4, base.size)
    c_np = np.nextafter(base, np.inf)
    for _ in range(3):
        c_np = np.where(steps > 0, np.nextafter(c_np, np.inf), c_np)
        steps -= 1
    c = torch.from_numpy(c_np).to(dev)
    for k in (1, 10, 100, 4096):
        hold(c, k)
    buf = torch.empty(c.numel() + 1, dtype=torch.float64, device=dev)
    view = buf[1:]
    view.copy_(c)
    hold(view, 4096)


@pytest.mark.cuda
def test_card_topk_same_run_twice(dev):
    rng = np.random.default_rng(3)
    c = torch.from_numpy(keys("ties", 300_001, rng)).to(dev)
    assert torch.equal(topk_smallest(c, 4096), topk_smallest(c, 4096))
    with pytest.raises(ValueError):
        topk_smallest(c, TOPK_MAX_K + 1)
