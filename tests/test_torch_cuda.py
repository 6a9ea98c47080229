"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small ragged shapes (edges that the slice's shapes do not reach: batch
and hidden sizes off the tile multiples, unaligned widths, a dropout mask).

Marked ``cuda``: they skip where no card is visible.  On a host with a card
and no JAX (the tests' conftest imports jax), run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from vqa_counterexamples_tpu_torch.ops.cuda import (
    gru_kernel, mixture_kernel, vfeat_kernel)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(gen, dev, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen) * scale).to(dtype).to(dev)


@pytest.mark.parametrize("seq,batch,dim_h,masked", [
    (3, 5, 20, False), (4, 70, 72, True), (2, 65, 36, True)])
def test_gru_kernel_matches_plain(dev, seq, batch, dim_h, masked):
    gen = torch.Generator().manual_seed(dim_h)
    xp = _randn(gen, dev, seq, batch, 3 * dim_h)
    w = _randn(gen, dev, 3 * dim_h, dim_h, scale=dim_h ** -0.5)
    b = _randn(gen, dev, 3 * dim_h, scale=0.1, dtype=torch.float32)
    mask = (((torch.rand(batch, dim_h, generator=gen) > 0.3) * 1.5)
            .to(torch.bfloat16).to(dev) if masked else None)
    before = gru_kernel.gru_recurrence.launches
    s1, h1 = gru_kernel.gru_recurrence(xp, w, b, mask, want_hproj=True)
    s2, h2 = gru_kernel.gru_recurrence_plain(xp, w, b, mask, want_hproj=True)
    torch.cuda.synchronize()
    assert gru_kernel.gru_recurrence.launches == before + 1
    torch.testing.assert_close(s1.float(), s2.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(h1.float(), h2.float(), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("n_rows,dim_v,batch,knn,dim_h", [
    (40, 40, 5, 6, 20), (50, 36, 3, 24, 70), (100, 128, 70, 24, 300)])
def test_vfeat_kernel_matches_plain(dev, n_rows, dim_v, batch, knn, dim_h):
    gen = torch.Generator().manual_seed(dim_v)
    table = _randn(gen, dev, n_rows, dim_v)
    idx = torch.randint(0, n_rows, (batch, knn + 1), generator=gen).to(
        torch.int32).to(dev)
    w_o = _randn(gen, dev, dim_h, dim_v, scale=dim_v ** -0.5)
    w_m = _randn(gen, dev, dim_h, dim_v, scale=dim_v ** -0.5)
    h1, d1 = vfeat_kernel.vfeat_scores(table, idx, w_o, w_m)
    h2, d2 = vfeat_kernel.vfeat_scores_plain(table, idx, w_o, w_m)
    torch.cuda.synchronize()
    torch.testing.assert_close(h1.float(), h2.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(d1, d2, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("rows,dim_z,n_ans", [
    (70, 24, 50), (129, 36, 100), (300, 360, 2000)])
def test_mixture_kernel_matches_plain(dev, rows, dim_z, n_ans):
    gen = torch.Generator().manual_seed(n_ans)
    z = _randn(gen, dev, rows, dim_z)
    w = _randn(gen, dev, n_ans, dim_z, scale=0.3)
    b = _randn(gen, dev, n_ans)
    p1 = mixture_kernel.classify_softmax(z, w, b)
    p2 = mixture_kernel.classify_softmax_plain(z, w, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(p1.float(), p2.float(), atol=2e-3, rtol=2e-2)


def test_wrappers_refuse_bad_operands(dev):
    with pytest.raises(ValueError):
        mixture_kernel.classify_softmax(
            torch.zeros(4, 8, device=dev),  # f32, not bf16
            torch.zeros(3, 8, dtype=torch.bfloat16, device=dev),
            torch.zeros(3, dtype=torch.bfloat16, device=dev))
    with pytest.raises(ValueError):
        vfeat_kernel.vfeat_scores(
            torch.zeros(4, 8, dtype=torch.bfloat16, device=dev),
            torch.zeros(2, 3, dtype=torch.int64, device=dev),  # not int32
            torch.zeros(5, 8, dtype=torch.bfloat16, device=dev),
            torch.zeros(5, 8, dtype=torch.bfloat16, device=dev))
