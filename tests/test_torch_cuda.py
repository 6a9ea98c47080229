"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small ragged shapes (edges that the slice's shapes do not reach: batch
and hidden sizes off the tile multiples, unaligned widths, a dropout mask)
and, for the vfeat backward, at the flagship shape too.

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


def _vfeat_bwd_inputs(dev, n_rows, dim_v, batch, knn, dim_h):
    gen = torch.Generator().manual_seed(dim_v + batch)
    table = _randn(gen, dev, n_rows, dim_v)
    idx = torch.randint(0, n_rows, (batch, knn + 1), generator=gen).to(
        torch.int32).to(dev)
    g = _randn(gen, dev, batch, knn, dim_h, scale=1e-2)
    return table, idx, g


# f32 sums over B*K rows in another order than the plain f32 GEMM: the
# bound is relative to the largest gradient entry
def _assert_grads_close(got, ref, rel=1e-4):
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("n_rows,dim_v,batch,knn,dim_h", [
    (40, 40, 5, 6, 20), (50, 36, 3, 24, 70), (100, 128, 71, 23, 300),
    (1024, 2048, 768, 24, 300)])
def test_vfeat_bwd_kernel_matches_plain(dev, n_rows, dim_v, batch, knn,
                                        dim_h):
    table, idx, g = _vfeat_bwd_inputs(dev, n_rows, dim_v, batch, knn, dim_h)
    before = vfeat_kernel.vfeat_weight_grads.launches
    dwo, dwm = vfeat_kernel.vfeat_weight_grads(table, idx, g)
    ro, rm = vfeat_kernel.vfeat_weight_grads_plain(table, idx, g)
    torch.cuda.synchronize()
    assert vfeat_kernel.vfeat_weight_grads.launches == before + 1
    assert dwo.dtype == torch.float32 and dwo.shape == (dim_h, dim_v)
    _assert_grads_close(dwo, ro)
    _assert_grads_close(dwm, rm)
    # a fixed reduction order: the same inputs give the same bits
    dwo2, dwm2 = vfeat_kernel.vfeat_weight_grads(table, idx, g)
    assert torch.equal(dwo, dwo2) and torch.equal(dwm, dwm2)


def test_vfeat_function_grads_match_plain_autograd(dev):
    """The autograd Function (both kernels) against autograd through the
    plain forward: the weight grads reach the f32 leaves the same way.
    Both round an f32 sum to bf16 once; the sums' order differs, so an
    entry may land one bf16 step apart."""
    table, idx, g = _vfeat_bwd_inputs(dev, 100, 256, 33, 24, 300)
    gen = torch.Generator().manual_seed(3)
    leaves = [(torch.randn(300, 256, generator=gen) * 0.05).to(dev)
              .requires_grad_() for _ in range(2)]
    grads = []
    for fn in (vfeat_kernel.vfeat_scores, vfeat_kernel.vfeat_scores_plain):
        h, dist = fn(table, idx, *(w.to(torch.bfloat16) for w in leaves))
        assert not dist.requires_grad
        (h.float() * g.float()).sum().backward()
        grads.append([w.grad.clone() for w in leaves])
        for w in leaves:
            w.grad = None
    torch.cuda.synchronize()
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=1e-2 * ref.abs().max(),
                                   rtol=1e-2)


def test_forward_only_wrappers_refuse_grad(dev):
    w = torch.zeros(6, 2, dtype=torch.bfloat16, device=dev,
                    requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        gru_kernel.gru_recurrence(
            torch.zeros(2, 3, 6, dtype=torch.bfloat16, device=dev), w,
            torch.zeros(6, device=dev))
    with pytest.raises(RuntimeError, match="forward-only"):
        mixture_kernel.classify_softmax(
            torch.zeros(3, 4, dtype=torch.bfloat16, device=dev),
            torch.zeros(7, 4, dtype=torch.bfloat16, device=dev,
                        requires_grad=True),
            torch.zeros(7, dtype=torch.bfloat16, device=dev))


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
