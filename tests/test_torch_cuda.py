"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small ragged shapes (edges that the slice's shapes do not reach: batch
and hidden sizes off the tile multiples, unaligned widths, dropout masks
shared or per gate) and, for the vfeat forward and backward, the GRU
backward and kNN, at their paths' full shapes too (vfeat also over
COCO-train's 82,783-row table); and the captured CUDA graphs of the train
and eval steps against the eager steps, bit for bit (CX, MutanNoAtt,
MutanAtt, MLBNoAtt with UniSkip and with the LSTM encoders, and MLBAtt at
small sizes), the generators' reseeding under replay, a resume after a
captured epoch, UniSkip's no-mask GRU pair at full width, and the native
store's prefetch into the pinned buffers.

Marked ``cuda``: they skip where no card is visible.  On a host with a card
and no JAX (the tests' conftest imports jax), run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from vqa_counterexamples_tpu_torch.core import spans
from vqa_counterexamples_tpu_torch.ops.cuda import (
    gru_kernel, mixture_kernel, mutan_kernel, vfeat_kernel, xproj_kernel)

pytestmark = pytest.mark.cuda


def launches() -> dict:
    """Every kernel wrapper's launch count in the port's counter store
    (``core/spans``), by wrapper name."""
    return {k[len("kernels.launches."):]: n
            for k, n in spans.counters().items()
            if k.startswith("kernels.launches.")}


def launched(name: str) -> int:
    return launches()[name]


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
    before = launched("gru")
    s1, h1 = gru_kernel.gru_recurrence(xp, w, b, mask, want_hproj=True)
    s2, h2 = gru_kernel.gru_recurrence_plain(xp, w, b, mask, want_hproj=True)
    torch.cuda.synchronize()
    assert launched("gru") == before + 1
    torch.testing.assert_close(s1.float(), s2.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(h1.float(), h2.float(), atol=5e-2, rtol=5e-2)


# the small ragged shapes; B K off the forward's 128-row tile and the
# backward's 64-row chunk with H off the 152-column tile (158: two column
# tiles, the second of 6); the CX path's shape over chip_smoke's table and
# over COCO-train's 82,783 rows (339 MB, beyond L2)
@pytest.mark.parametrize("n_rows,dim_v,batch,knn,dim_h", [
    (40, 40, 5, 6, 20), (50, 36, 3, 24, 70), (100, 128, 70, 24, 300),
    (300, 256, 45, 7, 158), (1024, 2048, 768, 24, 300),
    (82783, 2048, 768, 24, 300)])
def test_vfeat_kernel_matches_plain(dev, n_rows, dim_v, batch, knn, dim_h):
    gen = torch.Generator().manual_seed(dim_v)
    table = _randn(gen, dev, n_rows, dim_v)
    idx = torch.randint(0, n_rows, (batch, knn + 1), generator=gen).to(
        torch.int32).to(dev)
    w_o = _randn(gen, dev, dim_h, dim_v, scale=dim_v ** -0.5)
    w_m = _randn(gen, dev, dim_h, dim_v, scale=dim_v ** -0.5)
    before = launched("vfeat")
    h1, d1 = vfeat_kernel.vfeat_scores(table, idx, w_o, w_m)
    h2, d2 = vfeat_kernel.vfeat_scores_plain(table, idx, w_o, w_m)
    torch.cuda.synchronize()
    assert launched("vfeat") == before + 1
    torch.testing.assert_close(h1.float(), h2.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(d1, d2, atol=1e-4, rtol=1e-4)
    # fixed sums: the same inputs give the same bits
    h3, d3 = vfeat_kernel.vfeat_scores(table, idx, w_o, w_m)
    assert torch.equal(h1, h3) and torch.equal(d1, d3)


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
    (300, 256, 45, 7, 158), (1024, 2048, 768, 24, 300),
    (82783, 2048, 768, 24, 300)])
def test_vfeat_bwd_kernel_matches_plain(dev, n_rows, dim_v, batch, knn,
                                        dim_h):
    table, idx, g = _vfeat_bwd_inputs(dev, n_rows, dim_v, batch, knn, dim_h)
    before = launched("vfeat_bwd")
    dwo, dwm = vfeat_kernel.vfeat_weight_grads(table, idx, g)
    ro, rm = vfeat_kernel.vfeat_weight_grads_plain(table, idx, g)
    torch.cuda.synchronize()
    assert launched("vfeat_bwd") == before + 1
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


# ragged against the kernel's tiles (64 rows, 256-answer tiles, a cluster
# of CTAs splitting the answers, 64-deep chunks): A below one tile, odd, at
# the path's 2000 and past one cluster of two; M off and on 64; dz 360 and
# off 8 (no TMA: the producer fills the stages by hand)
@pytest.mark.parametrize("rows,dim_z,n_ans", [
    (70, 24, 50), (129, 36, 100), (300, 360, 2000), (64, 360, 2000),
    (200, 360, 1999), (65, 20, 7), (130, 100, 333), (3, 44, 129),
    (96, 360, 4500)])
def test_mixture_kernel_matches_plain(dev, rows, dim_z, n_ans):
    gen = torch.Generator().manual_seed(n_ans)
    z = _randn(gen, dev, rows, dim_z)
    w = _randn(gen, dev, n_ans, dim_z, scale=0.3)
    b = _randn(gen, dev, n_ans)
    before = launched("mixture")
    p1 = mixture_kernel.classify_softmax(z, w, b)
    p2 = mixture_kernel.classify_softmax_plain(z, w, b)
    again = mixture_kernel.classify_softmax(z, w, b)
    torch.cuda.synchronize()
    assert launched("mixture") == before + 2
    # bit-equal to the plain version, no tolerance (a probability is about
    # 5e-4 at A 2000, so an atol would hide a lost answer tile): the same
    # rounding points, and the product summed in the order cuBLAS sums it
    # where the logits' rows are whole 16-byte chunks (A % 8 == 0)
    differ = (p1 != p2).sum().item()
    if n_ans % 8 == 0:
        assert differ == 0, "%d of %d differ" % (differ, p1.numel())
    else:
        # off 16 bytes cuBLAS takes another kernel, which sums the product
        # in another order, so a few bf16 logits round the other way.  Held
        # bit-equal instead to the plain version with the answers padded to
        # a multiple of 8 by answers of bias -inf (probability 0), and at A
        # itself only those few entries may differ
        pad = -n_ans % 8
        w_pad = torch.cat([w, torch.zeros(pad, dim_z, dtype=w.dtype,
                                          device=dev)])
        b_pad = torch.cat([b, torch.full((pad,), float("-inf"),
                                         dtype=b.dtype, device=dev)])
        p3 = mixture_kernel.classify_softmax_plain(z, w_pad, b_pad)
        assert torch.equal(p1, p3[:, :n_ans])
        assert differ <= 1e-4 * p1.numel(), "%d of %d differ" % (
            differ, p1.numel())
    # the row sums in one fixed order: the same inputs give the same bits
    assert torch.equal(p1, again)


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


def _gru_inputs(dev, seq, batch, dim_h, mask_kind, seed=0):
    """xp, W_hh, b_hh and a mask: None, shared (B, H) or per gate
    (3, B, H), with the 0.25-dropout scale 256/192 rounded to bf16."""
    gen = torch.Generator().manual_seed(seed + dim_h)
    xp = _randn(gen, dev, seq, batch, 3 * dim_h)
    w = _randn(gen, dev, 3 * dim_h, dim_h, scale=dim_h ** -0.5)
    b = _randn(gen, dev, 3 * dim_h, scale=0.1, dtype=torch.float32)
    shape = {"none": None, "shared": (batch, dim_h),
             "per_gate": (3, batch, dim_h)}[mask_kind]
    mask = None if shape is None else (
        (torch.rand(*shape, generator=gen) < 0.75) * (256.0 / 192)).to(
            torch.bfloat16).to(dev)
    return xp, w, b, mask


def _assert_rel(got, ref, rel, name=""):
    """max |got - ref| within ``rel`` of ref's largest entry."""
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all(), name
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    assert err <= rel * scale, (name, err, scale)


@pytest.mark.parametrize("seq,batch,dim_h", [(3, 5, 20), (4, 70, 72),
                                             (2, 65, 36)])
def test_gru_pg_kernel_matches_plain(dev, seq, batch, dim_h):
    xp, w, b, mask = _gru_inputs(dev, seq, batch, dim_h, "per_gate")
    before = (launched("gru"), launched("gru_pg"))
    s1, h1 = gru_kernel.gru_recurrence(xp, w, b, mask, want_hproj=True)
    s2, h2 = gru_kernel.gru_recurrence_plain(xp, w, b, mask, want_hproj=True)
    torch.cuda.synchronize()
    assert (launched("gru"), launched("gru_pg")) == (before[0],
                                                     before[1] + 1)
    torch.testing.assert_close(s1.float(), s2.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(h1.float(), h2.float(), atol=5e-2, rtol=5e-2)


def test_gru_pg_with_equal_masks_is_bit_equal_to_shared(dev):
    """Three equal per-gate masks give the shared-mask path's bits, in both
    directions: the gate stride cannot have changed the shared path."""
    xp, w, b, mask = _gru_inputs(dev, 5, 70, 72, "shared")
    mask3 = mask.expand(3, -1, -1).contiguous()
    s1, h1 = gru_kernel.gru_recurrence(xp, w, b, mask, want_hproj=True)
    s3, h3 = gru_kernel.gru_recurrence(xp, w, b, mask3, want_hproj=True)
    assert torch.equal(s1, s3) and torch.equal(h1, h3)
    ds = _randn(torch.Generator().manual_seed(1), dev, *s1.shape)
    g1 = gru_kernel.gru_recurrence_bwd(xp, w, mask, s1, h1, ds)
    g3 = gru_kernel.gru_recurrence_bwd(xp, w, mask3, s3, h3, ds)
    torch.cuda.synchronize()
    for a, c in zip(g1, g3):
        assert torch.equal(a, c)


@pytest.mark.parametrize("mask_kind", ["none", "shared", "per_gate"])
def test_gru_fwd_full_width_matches_plain(dev, mask_kind):
    """The forward at MutanAtt's full width (T 26, B 128, H 2400) against
    its plain version, states and h_proj within 5e-2, through the TMA
    tile, and bit-equal on a rerun."""
    xp, w, b, mask = _gru_inputs(dev, 26, 128, 2400, mask_kind)
    assert gru_kernel.forward_tile(xp, w, b, mask).tma
    got = gru_kernel.gru_recurrence(xp, w, b, mask, want_hproj=True)
    ref = gru_kernel.gru_recurrence_plain(xp, w, b, mask, want_hproj=True)
    again = gru_kernel.gru_recurrence(xp, w, b, mask, want_hproj=True)
    torch.cuda.synchronize()
    for g, r, a in zip(got, ref, again):
        torch.testing.assert_close(g.float(), r.float(), atol=5e-2,
                                   rtol=5e-2)
        assert torch.equal(g, a)


@pytest.mark.parametrize("mask_kind", ["none", "shared", "per_gate"])
def test_gru_fwd_every_tile_gives_the_same_bits(dev, mask_kind):
    """Every TMA tile of the forward and the plain-load tile, at a batch
    off every tile's rows (B 70: 64 and 128 leave ragged row blocks) and H
    off their units, give the same bits: they sum K in one order.  And
    they agree with the plain version."""
    xp, w, b, mask = _gru_inputs(dev, 5, 70, 104, mask_kind, seed=3)
    ref = gru_kernel.gru_recurrence_plain(xp, w, b, mask, want_hproj=True)
    gates = gru_kernel._mask_gates(mask)
    tiles = [gru_kernel.FwdTile(*gru_kernel.RAGGED_TILE, 3, False)] + [
        gru_kernel.FwdTile(*t, min(3, gru_kernel.fwd_max_stages(gates, *t)),
                           True) for t in gru_kernel.FWD_TILES]
    first = None
    for tile in tiles:
        got = gru_kernel._gru_fwd(xp, w, b, mask, True, tile)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            torch.testing.assert_close(g.float(), r.float(), atol=5e-2,
                                       rtol=5e-2)
        if first is None:
            first = got
        assert all(torch.equal(g, f) for g, f in zip(got, first)), tile


@pytest.mark.parametrize("mask_kind", ["none", "shared", "per_gate"])
@pytest.mark.parametrize("seq,batch,dim_h", [
    (3, 5, 20), (4, 70, 72), (3, 65, 100), (3, 70, 176), (26, 128, 2400),
    (26, 512, 2400), (26, 64, 2400), (26, 768, 2400)])
def test_gru_bwd_kernel_matches_plain(dev, seq, batch, dim_h, mask_kind):
    """The reverse sweep against its plain version: dxp, dW, db within 2e-2
    of each tensor's largest entry (bf16 cotangents from f32 carries
    summed in another order), and bit-equal on a rerun; at ragged shapes
    (off the tiles' rows and units; H 20, 72 and 100 off the 16-unit rule
    of the TMA path, H 176 on it) and at full width (T 26, H 2400):
    MutanAtt's B 128, the pretraining cell's B 512, the CX CLI's B 64 and
    the trainable CX step's B 768."""
    xp, w, b, mask = _gru_inputs(dev, seq, batch, dim_h, mask_kind)
    states, hproj = gru_kernel.gru_recurrence_plain(xp, w, b, mask,
                                                    want_hproj=True)
    ds = _randn(torch.Generator().manual_seed(2), dev, *states.shape)
    before = launched("gru_bwd")
    got = gru_kernel.gru_recurrence_bwd(xp, w, mask, states, hproj, ds)
    ref = gru_kernel.gru_recurrence_bwd_plain(xp, w, mask, states, hproj, ds)
    again = gru_kernel.gru_recurrence_bwd(xp, w, mask, states, hproj, ds)
    torch.cuda.synchronize()
    assert launched("gru_bwd") == before + 2
    assert got[1].dtype == torch.bfloat16 and got[2].dtype == torch.float32
    for name, a, r, c in zip(("dxp", "dW", "db"), got, ref, again):
        assert a.shape == r.shape, name
        _assert_rel(a, r, 2e-2, name)
        assert torch.equal(a, c), name


@pytest.mark.parametrize("mask_kind", ["none", "shared", "per_gate"])
def test_gru_bwd_every_tile_gives_the_same_bits(dev, mask_kind):
    """Every TMA tile of the backward and the plain-load tile, at a batch
    off every tile's rows (B 70) and H off their units (176: on the TMA
    path's 16-unit rule, off 48 and 80), at rings of 2 to 4 stages,
    give the same bits: they sum K in one order.  And they agree with the
    plain version."""
    xp, w, b, mask = _gru_inputs(dev, 5, 70, 176, mask_kind, seed=3)
    states, hproj = gru_kernel.gru_recurrence_plain(xp, w, b, mask,
                                                    want_hproj=True)
    ds = _randn(torch.Generator().manual_seed(6), dev, *states.shape)
    args = (xp, w, mask, states, hproj, ds)
    ref = gru_kernel.gru_recurrence_bwd_plain(*args)
    tiles = [gru_kernel.BwdTile(*gru_kernel.BWD_RAGGED_TILE, 2, False)] + [
        gru_kernel.BwdTile(*t, stages, True) for t in gru_kernel.BWD_TILES
        for stages in (2, gru_kernel.bwd_max_stages(*t))]
    first = None
    for tile in tiles:
        got = gru_kernel._gru_bwd(*args, tile)
        torch.cuda.synchronize()
        for name, g, r in zip(("dxp", "dW", "db"), got, ref):
            _assert_rel(g, r, 2e-2, name)
        if first is None:
            first = got
        assert all(torch.equal(g, f) for g, f in zip(got, first)), tile


def test_gru_function_grads_match_plain_autograd(dev):
    """:class:`GRURecurrence` (both kernels) against the same Function with
    the plain versions swapped in: the gradients reaching f32 leaves
    through the casts."""
    xp, w, b, mask = _gru_inputs(dev, 4, 33, 40, "per_gate", seed=5)
    leaves = [t.float().requires_grad_() for t in (xp, w, b)]
    g = torch.randn(4, 33, 40, generator=torch.Generator().manual_seed(3)
                    ).to(dev)
    grads = []
    for plain in (False, True):
        saved = (gru_kernel.gru_recurrence, gru_kernel.gru_recurrence_bwd)
        if plain:
            gru_kernel.gru_recurrence = gru_kernel.gru_recurrence_plain
            gru_kernel.gru_recurrence_bwd = \
                gru_kernel.gru_recurrence_bwd_plain
        try:
            states = gru_kernel.gru_recurrence_train(
                leaves[0].to(torch.bfloat16), leaves[1].to(torch.bfloat16),
                leaves[2], mask)
            (states.float() * g).sum().backward()
        finally:
            gru_kernel.gru_recurrence, gru_kernel.gru_recurrence_bwd = saved
        grads.append([t.grad.clone() for t in leaves])
        for t in leaves:
            t.grad = None
    torch.cuda.synchronize()
    for name, got, ref in zip(("xp", "w_hh", "b_hh"), *grads):
        _assert_rel(got, ref, 2e-2, name)


def _tucker_inputs(dev, batch, dhv, dhq, rank, dmm):
    gen = torch.Generator().manual_seed(batch + dmm)
    xv = _randn(gen, dev, batch, dhv)
    xq = _randn(gen, dev, batch, dhq)
    wv = _randn(gen, dev, rank * dmm, dhv, scale=dhv ** -0.5)
    wq = _randn(gen, dev, rank * dmm, dhq, scale=dhq ** -0.5)
    bv = _randn(gen, dev, rank * dmm, scale=0.1, dtype=torch.float32)
    bq = _randn(gen, dev, rank * dmm, scale=0.1, dtype=torch.float32)
    return xv, xq, wv, bv, wq, bq


# 16-byte copies (widths % 8 == 0), 4-byte ones (70, 40, 36: and 37, 62,
# 30 with R 7, seven CTAs a cluster), plain loads (odd widths); B 513 (a
# row block of one), MutanAtt's classifier (128, 620, 310, 5, 510)
_TUCKER_SHAPES = [(5, 24, 24, 3, 24), (70, 40, 36, 2, 50),
                  (513, 360, 360, 10, 360), (128, 620, 310, 5, 510),
                  (37, 62, 30, 7, 70), (9, 21, 23, 4, 33)]


@pytest.mark.parametrize("batch,dhv,dhq,rank,dmm", _TUCKER_SHAPES)
def test_tucker_kernel_matches_plain(dev, batch, dhv, dhq, rank, dmm):
    xv, xq, wv, bv, wq, bq = _tucker_inputs(dev, batch, dhv, dhq, rank, dmm)
    before = launched("mutan")
    got = mutan_kernel.tucker_fusion(xv, xq, wv, bv, wq, bq, rank)
    ref = mutan_kernel.tucker_fusion_plain(xv, xq, wv, bv, wq, bq, rank)
    torch.cuda.synchronize()
    assert launched("mutan") == before + 1
    assert got.dtype == torch.float32 and got.shape == (batch, dmm)
    # f32 sums of exact bf16 products in another order
    torch.testing.assert_close(got, ref, atol=1e-4 * ref.abs().max().item(),
                               rtol=1e-4)


@pytest.mark.parametrize("batch,dhv,dhq,rank,dmm", [
    (512, 360, 360, 10, 360), (128, 620, 310, 5, 510)])
def test_tucker_kernel_reruns_bit_equal(dev, batch, dhv, dhq, rank, dmm):
    """The ranks' products are summed in one fixed order (no atomics)."""
    args = _tucker_inputs(dev, batch, dhv, dhq, rank, dmm) + (rank,)
    first = mutan_kernel.tucker_fusion(*args)
    again = mutan_kernel.tucker_fusion(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_new_wrappers_forward_only_and_refuse_bad_operands(dev):
    bf = torch.bfloat16
    x = torch.zeros(3, 8, dtype=bf, device=dev)
    w = torch.zeros(6, 8, dtype=bf, device=dev, requires_grad=True)
    b = torch.zeros(6, device=dev)
    with pytest.raises(RuntimeError, match="forward-only"):
        mutan_kernel.tucker_fusion(x, x, w, b, w, b, 2)
    with pytest.raises(ValueError):
        mutan_kernel.tucker_fusion(x, x, w.detach().float(), b, w.detach(),
                                   b, 2)
    xp = torch.zeros(2, 3, 6, dtype=bf, device=dev)
    with pytest.raises(ValueError):  # a (2, B, H) mask is neither form
        gru_kernel.gru_recurrence(xp, w.detach()[:, :2].contiguous(),
                                  torch.zeros(6, device=dev),
                                  torch.ones(2, 3, 2, dtype=bf, device=dev))


def _attmutan_inputs(dev, batch, k, dh, rank, m, seed=0):
    """x_v (B, K, Dh) and w (R*M, Dh) bf16, b (R*M,) f32, hq (B, R, M) f32
    and a cotangent g (B, K, M) bf16."""
    gen = torch.Generator().manual_seed(seed + k + dh + m)
    xv = _randn(gen, dev, batch, k, dh)
    w = _randn(gen, dev, rank * m, dh, scale=dh ** -0.5)
    b = _randn(gen, dev, rank * m, scale=0.1, dtype=torch.float32)
    hq = _randn(gen, dev, batch, rank, m, dtype=torch.float32)
    g = _randn(gen, dev, batch, k, m, scale=0.1)
    return xv, w, b, hq, g


# ragged against the 64-wide tiles and the 8-element vector loads; the
# last is MutanAtt's attention shape
_ATT_SHAPES = [(3, 5, 20, 2, 24), (5, 70, 72, 3, 130), (2, 65, 40, 1, 64),
               (128, 196, 310, 5, 510)]

# the backward also at B 1 (seven empty example groups), at a B whose last
# group is short (13 over 8 groups of 2), at odd widths (plain loads, no
# cp.async) and at R 7 (two launches of the dweff kernel, 5 ranks each)
_ATT_BWD_SHAPES = _ATT_SHAPES + [(1, 196, 310, 5, 510), (13, 37, 42, 3, 66),
                                 (3, 9, 21, 2, 25), (2, 20, 30, 7, 40)]

# the forward at every backward shape, and at Dh whose weff slice fits
# only the narrower configurations (128, then 64 of M a CTA)
_ATT_FWD_SHAPES = _ATT_BWD_SHAPES + [(2, 9, 400, 2, 40), (2, 9, 1536, 2, 40)]


@pytest.mark.parametrize("batch,k,dh,rank,m", _ATT_FWD_SHAPES)
def test_attmutan_kernel_matches_plain(dev, batch, k, dh, rank, m):
    """5f: bf16 outputs from f32 sums of the same exact bf16 products in
    another order (one bf16 step of the output, 2^-8 relative)."""
    from vqa_counterexamples_tpu_torch.ops.cuda import attmutan_kernel

    xv, w, b, hq, _ = _attmutan_inputs(dev, batch, k, dh, rank, m)
    before = launched("attmutan")
    got = attmutan_kernel.folded_mutan(xv, w, b, hq)
    ref = attmutan_kernel.folded_mutan_plain(xv, w, b, hq)
    torch.cuda.synchronize()
    assert launched("attmutan") == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (batch, k, m)
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                               rtol=8e-3)


@pytest.mark.parametrize("batch,k,dh,rank,m", [
    (5, 70, 72, 3, 130), (3, 9, 21, 2, 25), (128, 196, 310, 5, 510)])
def test_attmutan_fwd_every_config_gives_the_same_bits(dev, batch, k, dh,
                                                       rank, m):
    """5f reruns bit-equal, and every configuration of ``FWD_CONFIGS``
    (each CTA's share of M and its warpgroups) gives the plan's bits: each
    sum has one order whatever the tiling."""
    from vqa_counterexamples_tpu_torch.ops.cuda import attmutan_kernel

    xv, w, b, hq, _ = _attmutan_inputs(dev, batch, k, dh, rank, m)
    first = attmutan_kernel.folded_mutan(xv, w, b, hq)
    again = attmutan_kernel.folded_mutan(xv, w, b, hq)
    each = [attmutan_kernel._fwd_launch(xv, w, b, hq, config[:2])
            for config in attmutan_kernel.FWD_CONFIGS]
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    for config, out in zip(attmutan_kernel.FWD_CONFIGS, each):
        assert torch.equal(out, first), config


@pytest.mark.parametrize("batch,k,dh,rank,m", _ATT_BWD_SHAPES)
def test_attmutan_bwd_kernel_matches_plain(dev, batch, k, dh, rank, m):
    """5b: dx_v and dhq (bf16 from f32 sums) and dw, db (f32 sums over
    every example, another order) within 1e-2 of each tensor's largest
    entry, and bit-equal on a rerun."""
    from vqa_counterexamples_tpu_torch.ops.cuda import attmutan_kernel

    xv, w, b, hq, g = _attmutan_inputs(dev, batch, k, dh, rank, m, seed=1)
    before = launched("attmutan_bwd")
    got = attmutan_kernel.folded_mutan_bwd(xv, w, b, hq, g)
    ref = attmutan_kernel.folded_mutan_bwd_plain(xv, w, b, hq, g)
    again = attmutan_kernel.folded_mutan_bwd(xv, w, b, hq, g)
    torch.cuda.synchronize()
    assert launched("attmutan_bwd") == before + 2
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16]
    for name, a, r, c in zip(("dx_v", "dw", "db", "dhq"), got, ref, again):
        assert a.shape == r.shape, name
        _assert_rel(a, r, 1e-2, name)
        assert torch.equal(a, c), name


def test_folded_function_grads_match_plain_autograd(dev):
    """:class:`FoldedMutan` (both kernels) against autograd through the
    plain forward, on f32 leaves behind the casts."""
    from vqa_counterexamples_tpu_torch.ops import fusion as fusion_ops
    from vqa_counterexamples_tpu_torch.ops.cuda import attmutan_kernel

    xv, w, b, hq, g = _attmutan_inputs(dev, 6, 37, 40, 3, 50, seed=2)
    leaves = [t.float().requires_grad_() for t in (xv, w, b, hq)]
    grads = []
    for fn in (lambda *a: fusion_ops.FoldedMutan.apply(*a),
               attmutan_kernel.folded_mutan_plain):
        out = fn(leaves[0].to(torch.bfloat16), leaves[1].to(torch.bfloat16),
                 leaves[2], leaves[3])
        (out.float() * g.float()).sum().backward()
        grads.append([t.grad.clone() for t in leaves])
        for t in leaves:
            t.grad = None
    torch.cuda.synchronize()
    for name, got, ref in zip(("x_v", "w", "b", "hq"), *grads):
        _assert_rel(got, ref, 2e-2, name)


@pytest.mark.parametrize("bq,n,dim,k", [
    (5, 40, 12, 3), (70, 1000, 37, 25), (130, 4099, 64, 32),
    (200, 20000, 64, 100), (1024, 82783, 2048, 25)])
def test_knn_kernel_matches_plain(dev, bq, n, dim, k):
    """Kernel 6 against ``knn_chunk_plain``: distances within rtol 1e-4
    (f32 sums in another order; 2e-2 absolute at the self-distances, which
    are f32 cancellation noise of about sqrt(eps |q|^2)), the same
    neighbours wherever adjacent distances are further apart than that."""
    from vqa_counterexamples_tpu_torch.ops.cuda import knn_kernel

    gen = torch.Generator().manual_seed(n)
    corpus = torch.randn(n, dim, generator=gen).to(dev)
    pick = torch.randperm(n, generator=gen)[:bq].to(dev)
    queries = corpus[pick].contiguous()
    before = launched("knn")
    d1, i1 = knn_kernel.knn_chunk(queries, corpus, k)
    d2, i2 = knn_kernel.knn_chunk_plain(queries, corpus, k)
    again = knn_kernel.knn_chunk(queries, corpus, k)
    torch.cuda.synchronize()
    assert launched("knn") == before + 2
    # a fixed summation order: the same inputs give the same bits
    assert torch.equal(d1, again[0]) and torch.equal(i1, again[1])
    assert i1.dtype == torch.int32 and d1.shape == (bq, k)
    assert torch.equal(i1[:, 0], pick.to(torch.int32))
    torch.testing.assert_close(d1, d2, atol=2e-2, rtol=1e-4)
    assert (d1[:, 1:] >= d1[:, :-1]).all()
    gap = torch.cat([d2[:, 1:] - d2[:, :-1],
                     torch.full((bq, 1), float("inf"), device=dev)], 1)
    prev = torch.cat([torch.full((bq, 1), float("inf"), device=dev),
                      gap[:, :-1]], 1)
    clear = (gap > 2e-2) & (prev > 2e-2)
    assert torch.equal(i1[clear], i2[clear])


def test_knn_kernel_takes_any_k_up_to_n(dev):
    """k 1000 on a 3000-row corpus (too many lists for shared memory: they
    live in the scratch; every slice shorter than k) agrees with the plain
    version on the neighbours and distances; k above N raises."""
    from vqa_counterexamples_tpu_torch.ops.cuda import knn_kernel

    gen = torch.Generator().manual_seed(1)
    corpus = torch.randn(3000, 40, generator=gen).to(dev)
    queries = corpus[:65].contiguous()
    d1, i1 = knn_kernel.knn_chunk(queries, corpus, 1000)
    d2, i2 = knn_kernel.knn_chunk_plain(queries, corpus, 1000)
    torch.cuda.synchronize()
    assert torch.equal(i1[:, 0].long(), torch.arange(65, device=dev))
    torch.testing.assert_close(d1, d2, atol=2e-2, rtol=1e-4)
    assert (d1[:, 1:] >= d1[:, :-1]).all()
    gap = torch.cat([d2[:, 1:] - d2[:, :-1],
                     torch.full((65, 1), float("inf"), device=dev)], 1)
    prev = torch.cat([torch.full((65, 1), float("inf"), device=dev),
                      gap[:, :-1]], 1)
    clear = (gap > 2e-2) & (prev > 2e-2)
    assert torch.equal(i1[clear], i2[clear])
    with pytest.raises(ValueError, match="outside"):
        knn_kernel.knn_chunk(queries, corpus, 3001)


def test_knn_kernel_ties_go_to_the_smallest_index(dev):
    """Duplicated corpus rows tie exactly: the smaller index wins, in every
    slice of the corpus and across them."""
    from vqa_counterexamples_tpu_torch.ops.cuda import knn_kernel

    gen = torch.Generator().manual_seed(0)
    base = torch.randn(300, 16, generator=gen)
    corpus = torch.cat([base] * 20).to(dev)          # row i == row i + 300
    d, i = knn_kernel.knn_chunk(corpus[:7].contiguous(), corpus, 20)
    torch.cuda.synchronize()
    want = torch.arange(7, device=dev)[:, None] + 300 * torch.arange(
        20, device=dev)[None]
    assert torch.equal(i.long(), want)
    assert torch.equal(d, d[:, :1].expand(-1, 20))


def test_pinned_att_batches_match_host_path(dev):
    """Att-map batches gathered into the pinned ping-pong buffers and
    copied on the side stream: the host path's batches, bit for bit, each
    still intact after the buffers were reused."""
    from vqa_counterexamples_tpu_torch.data.features import FeatureStore
    from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays

    rng = np.random.default_rng(0)
    feats = rng.normal(size=(20, 3, 3, 8)).astype(np.float32)
    names = ["n%d" % i for i in range(20)]
    examples = [{"question_id": i, "question_wids": [1, 2, 0],
                 "image_name": names[int(rng.integers(0, 20))],
                 "answer_aid": i % 3, "answers_aid": [i % 3, 1],
                 "answers_count": [3, 2]} for i in range(37)]
    arrays = VQAArrays(examples, FeatureStore(feats, names),
                       samplingans=True)
    host = list(arrays.batches(8, rng=np.random.default_rng(1)))
    card = list(arrays.batches(8, rng=np.random.default_rng(1), device=dev))
    torch.cuda.synchronize()
    assert len(card) == len(host) == 5
    for c, h in zip(card, host):
        assert c["visual"].device.type == "cuda"
        np.testing.assert_array_equal(c["visual"].cpu().numpy(),
                                      h["visual"])
        for k in ("question", "answer", "question_id"):
            np.testing.assert_array_equal(c[k], h[k])


# ------------------------------------------------- captured steps (graphs)
#
# The train and eval steps are captured CUDA graphs on a card by default
# (``core/graphs``).  Each test runs the same steps from one starting state
# through the captured step and the eager one (``capture=False``) under
# the bf16 policy, dropout on, and holds them bit-equal: the same kernels
# on the same buffers, the masks from generators reseeded from (seed, step,
# name) before each call.

CX_SPEC = dict(dim_h=24, n_layers=2, drop_p=0.25, dim_a=40, v_emb=True,
               v_mult=True, v_dist=True, v_rank=True, q_emb=True,
               a_emb=True, z_emb=True, pretrained_emb=False,
               trainable_vqa=False)


def _tiny_cx(dev, seed=5):
    """A small NeuralCX on the card (dim_v 128, K 6, GRU 32), its caches
    (bf16-resident, table form) and 40 examples: B 16 leaves a padded
    third batch of 8."""
    from vqa_counterexamples_tpu_torch.data import synthetic, vqacx
    from vqa_counterexamples_tpu_torch.engines import cx_engine
    from vqa_counterexamples_tpu_torch.models import factory

    dataset, store = synthetic.make_synthetic_cx(
        n_examples=40, n_images=24, dim_v=128, knn_size=6, n_words=20,
        n_answers=20, seed=9)
    opt = synthetic.tiny_vqa_options(dim_v=128, nans=20, dim_q=32)
    opt["seq2vec"] = {"arch": "skipthoughts", "type": "BayesianUniSkip",
                      "dropout": 0.25, "fixed_emb": False, "emb_size": 16,
                      "hidden_size": 32}
    model = factory.factory_cx(
        "NeuralModel", factory.factory_vqa(opt, dataset["vocab_words"],
                                           dataset["vocab_answers"]),
        knn_size=6, model_spec=CX_SPEC)
    model = cx_engine.init_cx_params(model, seed=seed).to(dev)
    arrays = vqacx.CXArrays.from_examples(dataset["examples_list"],
                                          dataset["name_to_index"])
    features = store.to_device(dev)
    q, _, z, _ = cx_engine.build_frozen_caches(model, features, arrays)
    tables = cx_engine.make_tables_bf16_resident(features, q, None, z)
    return model, arrays, tables


def _adam_tensors(optimizer):
    return [v for p in (p for g in optimizer.param_groups
                        for p in g["params"])
            for v in optimizer.state[p].values()]


def _assert_same_training(model_a, opt_a, model_b, opt_b):
    for (n, a), (_, b) in zip(model_a.named_parameters(),
                              model_b.named_parameters()):
        assert torch.equal(a, b), n
    moments_a, moments_b = _adam_tensors(opt_a), _adam_tensors(opt_b)
    assert len(moments_a) == len(moments_b) > 0
    for a, b in zip(moments_a, moments_b):
        assert torch.equal(a, b)


def _cx_run(model, arrays, tables, capture, epochs=2, batch_size=16,
            mesh=None):
    """``epochs`` epochs of ``train_epoch`` (3 steps each) -> (state,
    per-step (loss, correct), the step, the launch counts); ``mesh``: the
    step's ``parallel.Mesh``."""
    from vqa_counterexamples_tpu_torch.engines import cx_engine

    feats, q, _, z = tables
    state = cx_engine.init_cx_state(model, lr=1e-3)
    step = cx_engine.make_cx_train_step(model, state.optimizer,
                                        base_seed=3, use_z_cache=True,
                                        capture=capture, mesh=mesh)
    before = launches()
    metrics = []
    rng = np.random.default_rng(0)
    for _ in range(epochs):
        state, _ = cx_engine.train_epoch(
            step, state, feats, arrays, batch_size, rng=rng, q_table=q,
            z_table=z, print_freq=1,
            log_fn=lambda b, m: metrics.append((m["loss"], m["recall"])))
    torch.cuda.synchronize()
    return state, metrics, step, {k: n - before[k]
                                  for k, n in launches().items()}


def test_captured_cx_train_step_equals_eager(dev, monkeypatch):
    import copy

    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    model, arrays, tables = _tiny_cx(dev)
    assert model.wants_table_features()
    eager_model = copy.deepcopy(model)
    s_cap, m_cap, step_cap, n_cap = _cx_run(model, arrays, tables, None)
    s_eag, m_eag, step_eag, n_eag = _cx_run(eager_model, arrays, tables,
                                            False)
    assert step_cap.graphed.capture and not step_eag.graphed.capture
    assert step_cap.graphed.n_graphs == 1   # one layout: the last batch
    assert s_cap.step == s_eag.step == 6    # is padded to B
    assert m_cap == m_eag and all(np.isfinite(m[0]) for m in m_cap)
    # the launch counters count the steps' kernels, replays included
    assert n_cap == n_eag and max(n_cap.values()) >= 6
    _assert_same_training(model, s_cap.optimizer, eager_model,
                          s_eag.optimizer)


def _nccl_one_rank_equals_unmeshed():
    """One spawned rank (``parallel.spawn`` gives it torchrun's
    environment): the captured CX steps with no mesh, then under a
    one-rank NCCL mesh, trained bit for bit alike."""
    import copy

    from vqa_counterexamples_tpu_torch import parallel

    dev = torch.device("cuda", 0)
    model, arrays, tables = _tiny_cx(dev)
    ranked_model = copy.deepcopy(model)
    s_one, m_one, _, n_one = _cx_run(model, arrays, tables, None)
    with parallel.mesh_from_env({"data": 1}, dev) as mesh:
        assert mesh.backend == "nccl"
        s_nccl, m_nccl, step, n_nccl = _cx_run(ranked_model, arrays, tables,
                                               None, mesh=mesh)
        assert step.graphed.capture and step.graphed.n_graphs == 1
    assert m_nccl == m_one and n_nccl == n_one
    _assert_same_training(model, s_one.optimizer, ranked_model,
                          s_nccl.optimizer)
    return True


def test_nccl_one_rank_captured_step_equals_unmeshed(dev, monkeypatch):
    """A one-rank NCCL mesh: the step is still captured, its gradients'
    all-reduce inside the graph, and it trains bit for bit as the step
    with no mesh.  It runs in a process of its own: a process that has
    had an NCCL group invalidated a later capture with no mesh (global
    capture mode) in this file, three runs in three on an H100."""
    from vqa_counterexamples_tpu_torch import parallel

    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    assert parallel.spawn(_nccl_one_rank_equals_unmeshed, world=1,
                          timeout=600)


def test_captured_cx_eval_step_equals_eager(dev, monkeypatch):
    from vqa_counterexamples_tpu_torch.engines import cx_engine

    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    lesioned = dict(CX_SPEC, v_rank=False)    # lesion placeholders drawn
    model, arrays, (feats, q, _, z) = _tiny_cx(dev)
    for spec in (CX_SPEC, lesioned):
        model.model_spec = spec
        results = [cx_engine.eval_model(
            cx_engine.make_cx_eval_step(model, use_z_cache=True,
                                        capture=capture),
            feats, arrays, 16, q_table=q, z_table=z)
            for capture in (None, False)]
        assert results[0] == results[1]
        assert 0.0 <= results[0]["recall_1"] <= results[0]["recall"] <= 1.0


def _tiny_vqa(dev, arch):
    """A small MutanNoAtt or MutanAtt on the card and 36 synthetic
    examples (B 8: four full batches and a short one of 4)."""
    import os

    from vqa_counterexamples_tpu_torch.core import config as config_lib
    from vqa_counterexamples_tpu_torch.data import synthetic
    from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays
    from vqa_counterexamples_tpu_torch.engines import vqa_engine
    from vqa_counterexamples_tpu_torch.models import factory

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    name = "mutan_att_train.yaml" if arch == "att" else \
        "mutan_noatt_train.yaml"
    opt = config_lib.load_options_file(
        os.path.join(repo, "configs", "vqa2", name))["model"]
    opt["seq2vec"].update(emb_size=16, hidden_size=48)
    if arch == "att":
        opt.update(dim_v=24, dim_q=48)
        opt["attention"].update(dim_hv=20, dim_hq=20, dim_mm=18, R=3)
        opt["fusion"].update(dim_hv=40, dim_hq=20, dim_mm=18, R=3)
        dim_v = 24
    else:
        opt["fusion"].update(dim_v=24, dim_q=48, dim_hv=24, dim_hq=24,
                             dim_mm=24, R=3)
        dim_v = 24
    examples, store, words, answers = synthetic.make_synthetic_vqa(
        36, 30, 10, dim_v=dim_v, spatial=arch == "att", seed=2)
    model = factory.factory_vqa(opt, words, answers)
    vqa_engine.init_vqa_params(model, seed=4)
    return model.to(dev), VQAArrays(examples, store, samplingans=True)


@pytest.mark.parametrize("arch", ["noatt", "att"])
def test_captured_vqa_train_step_equals_eager(dev, monkeypatch, arch):
    import copy

    from vqa_counterexamples_tpu_torch.engines import vqa_engine

    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    model, arrays = _tiny_vqa(dev, arch)
    feats = arrays.store.to_device(dev) if arch == "noatt" else None
    runs = []
    for capture, m in ((None, model), (False, copy.deepcopy(model))):
        state = vqa_engine.init_vqa_state(m, lr=1e-3)
        step = vqa_engine.make_vqa_train_step(m, state.optimizer,
                                              base_seed=7, capture=capture)
        rng = np.random.default_rng(1)
        metrics = []
        for _ in range(2):
            for batch in arrays.batches(8, rng=rng, device_features=feats,
                                        device=dev):
                state, out = step(state, batch)
                metrics.append([float(out[k]) for k in
                                ("loss", "acc1", "acc5")])
        runs.append((m, state, step, metrics))
    (m_cap, s_cap, step_cap, met_cap), (m_eag, s_eag, _, met_eag) = runs
    assert step_cap.graphed.n_graphs == 2   # B 8 and the short B 4
    assert s_cap.step == s_eag.step == 10
    assert met_cap == met_eag and np.isfinite(met_cap).all()
    _assert_same_training(m_cap, s_cap.optimizer, m_eag, s_eag.optimizer)


def test_port_embedding_backward_reruns_bit_equal(dev):
    """The word embedding's backward at a MutanNoAtt batch's 13,312 ids
    over a small vocabulary (most of them padding): the port's lookup
    (``models/seq2vec.embedding``) gives the same bits on every call, and
    both paths equal the f64 sums to f32 rounding: the padding row sums
    some 9,500 N(0, 1) rows (|sum| ~ 100), and two f32 summation orders
    differ there by ~2e-4."""
    from vqa_counterexamples_tpu_torch.models import seq2vec

    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(81, 620, generator=gen, device=dev)
    ids = torch.randint(0, 81, (512, 26), generator=gen, device=dev)
    ids[:, 8:] = 0
    cot = torch.randn(512, 26, 620, generator=gen, device=dev)
    grads = {}
    for name, fn in (("port", seq2vec.embedding),
                     ("default", torch.nn.functional.embedding)):
        grads[name] = []
        for _ in range(5):
            t = table.clone().requires_grad_(True)
            fn(ids, t).backward(cot)
            grads[name].append(t.grad)
    assert all(torch.equal(g, grads["port"][0]) for g in grads["port"])
    exact = torch.zeros(81, 620, dtype=torch.float64, device=dev).index_add_(
        0, ids.flatten(), cot.reshape(-1, 620).double())
    for name in grads:
        torch.testing.assert_close(grads[name][0].double(), exact, rtol=0,
                                   atol=1e-3)


def test_captured_masks_depend_on_seed_step_name_only(dev):
    """Every mask consumer of a step (the GRU's variational masks, the
    scorer's keep-masks, the lesion placeholders) drawn inside a graph from
    registered generators reseeded before each replay: bit-equal to the
    draws of freshly seeded eager generators at steps 0-3, again at step 2
    after them (a restore), and whatever the replay count."""
    from vqa_counterexamples_tpu_torch.core import graphs, rng
    from vqa_counterexamples_tpu_torch.ops import rnn

    gens = rng.StepGenerators(("dropout", "lesion"), dev)
    out = {}

    def draws(dropout, lesion):
        mx, mh = rnn.variational_masks(dropout, 0.25, 5, 7, 9)
        keep, _ = rng.keep_mask((5, 6, 11), 0.75, dropout)
        place = torch.rand((5, 6), generator=lesion, device=dev)
        return mx, mh, keep, place

    def body(inputs):
        got = draws(gens["dropout"], gens["lesion"])
        if not out:
            out.update(bufs=[torch.empty_like(t) for t in got])
        for buf, t in zip(out["bufs"], got):
            buf.copy_(t)
        return {"x": inputs["x"].sum()}

    run = graphs.GraphedStep(body, dev, generators=gens)
    for step in (0, 1, 2, 3, 2, 0):
        run({"x": np.ones(3, np.float32)}, seed=11, step=step)
        fresh = rng.step_generators(11, step, ("dropout", "lesion"), dev)
        want = draws(fresh["dropout"], fresh["lesion"])
        torch.cuda.synchronize()
        for buf, ref in zip(out["bufs"], want):
            assert torch.equal(buf, ref), step
    assert run.n_graphs == 1


def test_resume_after_captured_epoch_continues_as_eager(dev, monkeypatch,
                                                        tmp_path):
    """An epoch of captured steps, a checkpoint, a fresh state resumed
    from it (``load_cx_checkpoint``) and an epoch more, against the same
    through eager steps; and the state the captured step trained, loaded
    in place: the Adam tensors move, the step captures again and goes on
    as the eager run does."""
    import copy

    from vqa_counterexamples_tpu_torch.core import checkpoint as ckpt_lib
    from vqa_counterexamples_tpu_torch.engines import cx_engine

    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    model, arrays, (feats, q, _, z) = _tiny_cx(dev)
    start = copy.deepcopy(model)
    finals = []
    for capture in (None, False):
        save_dir = str(tmp_path / str(capture))
        m = copy.deepcopy(start)
        state = cx_engine.init_cx_state(m, lr=1e-3)
        step = cx_engine.make_cx_train_step(m, state.optimizer,
                                            use_z_cache=True,
                                            capture=capture)
        state, _ = cx_engine.train_epoch(step, state, feats, arrays, 16,
                                         rng=np.random.default_rng(0),
                                         q_table=q, z_table=z)
        ckpt_lib.save_cx_checkpoint(state, [{"recall": 0.5}], save_dir)
        resumed = cx_engine.init_cx_state(copy.deepcopy(start), lr=1e-3)
        resumed, _, epoch, _ = ckpt_lib.load_cx_checkpoint(resumed,
                                                           save_dir)
        assert epoch == 2 and resumed.step == 3
        step2 = cx_engine.make_cx_train_step(resumed.model,
                                             resumed.optimizer,
                                             use_z_cache=True,
                                             capture=capture)
        resumed, _ = cx_engine.train_epoch(step2, resumed, feats, arrays, 16,
                                           rng=np.random.default_rng(1),
                                           q_table=q, z_table=z)
        # the first state, reloaded in place under its captured step
        before = [t.data_ptr() for t in _adam_tensors(state.optimizer)]
        ckpt_lib.load_cx_checkpoint(state, save_dir)
        assert before != [t.data_ptr() for t in
                          _adam_tensors(state.optimizer)]
        state, _ = cx_engine.train_epoch(step, state, feats, arrays, 16,
                                         rng=np.random.default_rng(1),
                                         q_table=q, z_table=z)
        torch.cuda.synchronize()
        finals.append((resumed, state))
    (res_cap, again_cap), (res_eag, again_eag) = finals
    for a, b in ((res_cap, res_eag), (again_cap, again_eag),
                 (res_cap, again_cap)):
        assert a.step == b.step == 6
        _assert_same_training(a.model, a.optimizer, b.model, b.optimizer)


@pytest.mark.parametrize("batch", [768, 64])
def test_gru_pg_and_bwd_at_the_trainable_cx_batches(dev, batch):
    """The per-gate forward and the backward at the trainable CX step's
    shapes (T 26, H 2400; B 768 as chip_smoke trains it, B 64 the CLI's
    default) against their plain versions: states and h_proj within 5e-2,
    dxp, dW, db within 2e-2 of each tensor's largest entry, both
    bit-equal on a rerun."""
    xp, w, b, mask = _gru_inputs(dev, 26, batch, 2400, "per_gate", seed=7)
    got = gru_kernel.gru_recurrence(xp, w, b, mask, want_hproj=True)
    ref = gru_kernel.gru_recurrence_plain(xp, w, b, mask, want_hproj=True)
    again = gru_kernel.gru_recurrence(xp, w, b, mask, want_hproj=True)
    for g, r, a in zip(got, ref, again):
        torch.testing.assert_close(g.float(), r.float(), atol=5e-2,
                                   rtol=5e-2)
        assert torch.equal(g, a)
    states, hproj = ref
    ds = _randn(torch.Generator().manual_seed(4), dev, *states.shape)
    bwd = gru_kernel.gru_recurrence_bwd(xp, w, mask, states, hproj, ds)
    bwd_ref = gru_kernel.gru_recurrence_bwd_plain(xp, w, mask, states,
                                                  hproj, ds)
    bwd_again = gru_kernel.gru_recurrence_bwd(xp, w, mask, states, hproj, ds)
    torch.cuda.synchronize()
    for name, a, r, c in zip(("dxp", "dW", "db"), bwd, bwd_ref, bwd_again):
        _assert_rel(a, r, 2e-2, name)
        assert torch.equal(a, c), name


def _tiny_backbone(n_answers=20):
    """A small MutanNoAtt option tree: dim_v 128, GRU 16 -> 32 with
    per-gate masks at 0.25, MUTAN R 3 at 24 with dropout_v / dropout_q 0.5
    and a classifier dropout of 0.5 (the trainable config's rates)."""
    from vqa_counterexamples_tpu_torch.data import synthetic

    opt = synthetic.tiny_vqa_options(dim_v=128, nans=n_answers, dim_q=32)
    opt["seq2vec"] = {"arch": "skipthoughts", "type": "BayesianUniSkip",
                      "dropout": 0.25, "fixed_emb": False, "emb_size": 16,
                      "hidden_size": 32}
    opt["fusion"].update(dropout_v=0.5, dropout_q=0.5)
    opt["classif"] = {"dropout": 0.5}
    return opt


def _tiny_zoo(dev, name, trainable=False, seed=5):
    """A small CX model of ``name`` on the card over 40 synthetic examples
    (K 6)."""
    from vqa_counterexamples_tpu_torch.data import synthetic, vqacx
    from vqa_counterexamples_tpu_torch.engines import cx_engine
    from vqa_counterexamples_tpu_torch.models import factory

    dataset, store = synthetic.make_synthetic_cx(
        n_examples=40, n_images=24, dim_v=128, knn_size=6, n_words=20,
        n_answers=20, seed=9)
    vqa = factory.factory_vqa(_tiny_backbone(), dataset["vocab_words"],
                              dataset["vocab_answers"])
    model = factory.factory_cx(name, vqa, knn_size=6, trainable_vqa=trainable,
                               model_spec=CX_SPEC)
    model = cx_engine.init_cx_params(model, seed=seed).to(dev)
    arrays = vqacx.CXArrays.from_examples(dataset["examples_list"],
                                          dataset["name_to_index"])
    return model, arrays, store.to_device(dev)


def test_captured_trainable_cx_step_equals_eager(dev, monkeypatch):
    """NeuralCX over a trainable backbone, every dropout live (the GRU's
    per-gate masks, the fusion's input dropouts, the classifier's, the
    head's): two epochs of captured steps against eager ones from one
    starting state, bit-equal in the losses and in every parameter and
    Adam moment, the backbone's included; the per-gate GRU forward, its
    backward and MUTAN launched once a step."""
    import copy

    from vqa_counterexamples_tpu_torch.engines import cx_engine

    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    model, arrays, feats = _tiny_zoo(dev, "NeuralModel", trainable=True)
    assert not model.wants_table_features() and not model._fused_head_ok()
    start = copy.deepcopy(model)
    runs = []
    for capture in (None, False):
        m = copy.deepcopy(start)
        state = cx_engine.init_cx_state(m, lr=1e-3)
        step = cx_engine.make_cx_train_step(m, state.optimizer, base_seed=3,
                                            capture=capture)
        before = launches()
        losses = []
        rng = np.random.default_rng(0)
        for _ in range(2):
            state, _ = cx_engine.train_epoch(
                step, state, feats, arrays, 16, rng=rng, print_freq=1,
                log_fn=lambda b, mt: losses.append(mt["loss"]))
        torch.cuda.synchronize()
        moved = {k: n - before[k] for k, n in launches().items()}
        runs.append((m, state, losses, moved))
    (m_cap, s_cap, l_cap, n_cap), (m_eag, s_eag, l_eag, n_eag) = runs
    assert l_cap == l_eag and all(np.isfinite(l_cap))
    assert n_cap == n_eag
    assert n_cap["gru_pg"] == n_cap["gru_bwd"] == n_cap["mutan"] == 6
    _assert_same_training(m_cap, s_cap.optimizer, m_eag, s_eag.optimizer)
    assert not torch.equal(m_cap.vqa_model.seq2vec.gru_cell.weight_hh,
                           start.vqa_model.seq2vec.gru_cell.weight_hh.to(dev))


def test_captured_contrastive_step_equals_eager(dev, monkeypatch):
    """The contrastive train step (q/v caches on) and its eval step,
    captured against eager from one starting state: bit-equal."""
    import copy

    from vqa_counterexamples_tpu_torch.data import vqacx
    from vqa_counterexamples_tpu_torch.engines import contrastive_engine
    from vqa_counterexamples_tpu_torch.engines import cx_engine

    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    model, arrays, feats = _tiny_zoo(dev, "ContrastiveModel")
    q, v, _, _ = cx_engine.build_frozen_caches(model, feats, arrays,
                                               use_q=True, use_v=True,
                                               use_z=False)
    start = copy.deepcopy(model)
    runs = []
    for capture in (None, False):
        m = copy.deepcopy(start)
        state = cx_engine.init_cx_state(m, lr=1e-3)
        step = contrastive_engine.make_contrastive_train_step(
            m, state.optimizer, base_seed=3, capture=capture)
        rng = np.random.default_rng(0)
        metrics = []
        for _ in range(2):
            pw = arrays.pairwise_view(rng)
            for idx, n_valid in vqacx.batch_indices(pw.size, 16,
                                                    shuffle=True, rng=rng):
                state, mt = step(state, feats, vqacx.gather_batch(pw, idx),
                                 n_valid, q_table=q, v_table=v)
                metrics.append(torch.stack(list(mt.values())))
        eval_step = contrastive_engine.make_contrastive_eval_step(
            m, capture=capture)
        evals = [eval_step(feats, vqacx.gather_batch(arrays, idx), n_valid,
                           i, q_table=q, v_table=v)
                 for i, (idx, n_valid) in enumerate(vqacx.batch_indices(
                     arrays.size, 16, shuffle=False))]
        torch.cuda.synchronize()
        runs.append((m, state, torch.stack(metrics),
                     [torch.stack(list(e.values())) for e in evals]))
    (m_cap, s_cap, met_cap, ev_cap), (m_eag, s_eag, met_eag, ev_eag) = runs
    assert torch.equal(met_cap, met_eag)
    assert torch.isfinite(met_cap).all() and s_cap.step == 6
    assert all(torch.equal(a, b) for a, b in zip(ev_cap, ev_eag))
    _assert_same_training(m_cap, s_cap.optimizer, m_eag, s_eag.optimizer)


# ------------------------------------------------ the demo server's graphs

def _serving_engine(dev, capture, attention=False):
    """A DemoEngine at narrow widths on the card (the ResNet-50 name at
    depth (1, 1, 1, 1), 64 x 64 images, skip-thoughts 16 -> 48)."""
    import os

    from vqa_counterexamples_tpu_torch.core import config as port_config
    from vqa_counterexamples_tpu_torch.data import synthetic
    from vqa_counterexamples_tpu_torch.engines import vqa_engine
    from vqa_counterexamples_tpu_torch.models import convnets, factory
    from vqa_counterexamples_tpu_torch.serve.demo_server import DemoEngine

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    opt = port_config.load_options_file(os.path.join(
        repo, "configs", "vqa2", "mutan_att_train.yaml" if attention
        else "mutan_noatt_train.yaml"))
    opt["model"]["seq2vec"].update(emb_size=16, hidden_size=48,
                                   dir_st="/no_st")
    if attention:
        opt["model"].update(dim_q=48)
        opt["model"]["attention"].update(dim_hv=24, dim_hq=24, dim_mm=16,
                                         R=3)
        opt["model"]["fusion"].update(dim_hv=48, dim_hq=24, dim_mm=16, R=3)
    else:
        opt["model"]["fusion"].update(dim_q=48, dim_hv=24, dim_hq=24,
                                      dim_mm=24, R=3)
    opt["vqa"].update(maxlength=8, nans=6)
    opt["coco"].update(arch="resnet50", size=64)
    words, answers = synthetic.synthetic_vocab(30, 6)
    model = factory.factory_vqa(opt["model"], words, answers)
    vqa_engine.init_vqa_params(model, seed=0)
    cnn = convnets.init_resnet(convnets.ResNet(depths=(1, 1, 1, 1)))
    return DemoEngine(opt, model.to(dev), cnn, words, answers, attention,
                      capture=capture)


def _serving_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8),
            rng.integers(0, 31, (n, 8)).astype(np.int32))


@pytest.mark.parametrize("attention", [False, True], ids=["noatt", "att"])
def test_captured_serving_buckets_equal_eager(dev, monkeypatch, attention):
    """One graph per bucket, bit-equal to the eager forward; a hot swap
    copies into the captured tensors (no recapture) and swapping back
    gives the first answers again, bit for bit."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    captured = _serving_engine(dev, None, attention)
    eager = _serving_engine(dev, False, attention)
    assert captured.prewarm(max_bucket=8) == [1, 2, 4, 8]
    assert captured.n_graphs == 4 and eager.n_graphs == 0
    for n in (1, 3, 8):
        images, wids = _serving_inputs(n, seed=n)
        got = captured.predict_prepared(images, wids)
        want = eager.predict_prepared(images, wids)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    images, wids = _serving_inputs(2)
    first = captured.predict_prepared(images, wids)
    original = {k: v.detach().clone()
                for k, v in captured.vqa_model.state_dict().items()}
    captured.set_params({k: v + 0.25 for k, v in original.items()})
    swapped = captured.predict_prepared(images, wids)
    assert not np.array_equal(swapped[0], first[0])
    captured.set_params(original)
    back = captured.predict_prepared(images, wids)
    assert all(np.array_equal(a, b) for a, b in zip(back, first))
    assert captured.n_graphs == 4


def test_unmeshed_captures_after_an_nccl_group_equal_eager(dev,
                                                          monkeypatch):
    """In one process: a one-rank NCCL group (torchrun's environment
    faked) trains a meshed captured step; then, with the group alive and
    again after it is destroyed, a captured CX train step with no mesh and
    a serving bucket's ``GraphedCall`` each give their eager results bit
    for bit (the capture is thread-local while the group exists)."""
    import copy
    import socket

    from vqa_counterexamples_tpu_torch import parallel
    from vqa_counterexamples_tpu_torch.core import graphs

    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)

    def unmeshed():
        model, arrays, tables = _tiny_cx(dev)
        eager_model = copy.deepcopy(model)
        s_cap, m_cap, step, n_cap = _cx_run(model, arrays, tables, None)
        s_eag, m_eag, _, n_eag = _cx_run(eager_model, arrays, tables, False)
        assert step.graphed.capture and step.graphed.n_graphs == 1
        assert m_cap == m_eag and n_cap == n_eag
        _assert_same_training(model, s_cap.optimizer, eager_model,
                              s_eag.optimizer)
        captured = _serving_engine(dev, None)
        eager = _serving_engine(dev, False)
        images, wids = _serving_inputs(3, seed=5)
        got = captured.predict_prepared(images, wids)
        assert captured.n_graphs == 1
        for a, b in zip(got, eager.predict_prepared(images, wids)):
            assert np.array_equal(a, b)

    with parallel.mesh_from_env({"data": 1}, dev) as mesh:
        assert mesh.backend == "nccl"
        model, arrays, tables = _tiny_cx(dev, seed=6)
        _, _, step, _ = _cx_run(model, arrays, tables, None, mesh=mesh)
        assert step.graphed.capture
        assert graphs.capture_kwargs() == {
            "capture_error_mode": "thread_local"}
        unmeshed()
    assert graphs.capture_kwargs() == {}
    unmeshed()


def test_captured_serving_from_many_threads(dev, monkeypatch):
    """Sixteen threads predicting at once on two buckets get what a lone
    caller gets, bit for bit (fill, replay and copy-out under the bucket's
    lock)."""
    import threading

    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    engine = _serving_engine(dev, None)
    inputs = [_serving_inputs(1 + i % 2, seed=i) for i in range(16)]
    want = [engine.predict_prepared(*x) for x in inputs]
    got = [None] * len(inputs)

    def worker(i):
        for _ in range(4):
            got[i] = engine.predict_prepared(*inputs[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))
    assert engine.n_graphs == 2


@pytest.mark.parametrize("batch", [512, 128])
def test_gru_no_mask_train_pair_at_uniskip_batches(dev, batch):
    """UniSkip's training path (MLBNoAtt at B 512, its val and the MLBAtt
    batch B 128): the forward with h_proj out and no mask, then the
    backward with no mask, at full width (T 26, H 2400) against their
    plain versions, bit-equal on a rerun, and through
    ``gru_recurrence_train`` the gradients against the same Function with
    the plain versions swapped in."""
    xp, w, b, _ = _gru_inputs(dev, 26, batch, 2400, "none", seed=batch)
    got = gru_kernel.gru_recurrence(xp, w, b, None, want_hproj=True)
    ref = gru_kernel.gru_recurrence_plain(xp, w, b, None, want_hproj=True)
    assert got[1] is not None and gru_kernel.forward_tile(xp, w, b,
                                                          None).tma
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.float(), r.float(), atol=5e-2,
                                   rtol=5e-2)
    ds = _randn(torch.Generator().manual_seed(2), dev, 26, batch, 2400)
    bwd = gru_kernel.gru_recurrence_bwd(xp, w, None, *got, ds)
    bwd_ref = gru_kernel.gru_recurrence_bwd_plain(xp, w, None, *got, ds)
    again = gru_kernel.gru_recurrence_bwd(xp, w, None, *got, ds)
    torch.cuda.synchronize()
    for name, a, r, c in zip(("dxp", "dW", "db"), bwd, bwd_ref, again):
        _assert_rel(a, r, 2e-2, name)
        assert torch.equal(a, c), name
    leaves = [t.float().requires_grad_() for t in (xp, w, b)]
    grads = []
    for plain in (False, True):
        saved = (gru_kernel.gru_recurrence, gru_kernel.gru_recurrence_bwd)
        if plain:
            gru_kernel.gru_recurrence = gru_kernel.gru_recurrence_plain
            gru_kernel.gru_recurrence_bwd = \
                gru_kernel.gru_recurrence_bwd_plain
        try:
            states = gru_kernel.gru_recurrence_train(
                leaves[0].to(torch.bfloat16), leaves[1].to(torch.bfloat16),
                leaves[2], None)
            (states.float() * ds.float()).sum().backward()
        finally:
            gru_kernel.gru_recurrence, gru_kernel.gru_recurrence_bwd = saved
        grads.append([t.grad.clone() for t in leaves])
        for t in leaves:
            t.grad = None
    torch.cuda.synchronize()
    for name, got_g, ref_g in zip(("xp", "w_hh", "b_hh"), *grads):
        _assert_rel(got_g, ref_g, 2e-2, name)


def _tiny_mlb(dev, name, seq2vec=None):
    """A small MLB model from a ``configs/vqa2`` YAML (its arch, encoder
    type, glimpses, dropouts and activations; narrow widths) on the card,
    or with another encoder, and 36 synthetic examples (B 8: four full
    batches and a short one of 4)."""
    import os

    from vqa_counterexamples_tpu_torch.core import config as config_lib
    from vqa_counterexamples_tpu_torch.data import synthetic
    from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays
    from vqa_counterexamples_tpu_torch.engines import vqa_engine
    from vqa_counterexamples_tpu_torch.models import factory

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    opt = config_lib.load_options_file(
        os.path.join(repo, "configs", "vqa2", name))["model"]
    opt["seq2vec"] = seq2vec or dict(opt["seq2vec"], emb_size=16,
                                     hidden_size=48)
    dim_q = 2 * 48 if opt["seq2vec"]["arch"] == "2-lstm" else 48
    att = opt["arch"] == "MLBAtt"
    if att:
        opt.update(dim_v=24, dim_q=dim_q)
        opt["attention"]["dim_h"] = 32
        opt["fusion"]["dim_h"] = 32
    else:
        opt["fusion"].update(dim_v=24, dim_q=dim_q, dim_h=32)
    examples, store, words, answers = synthetic.make_synthetic_vqa(
        36, 30, 10, dim_v=24, spatial=att, seed=2)
    model = factory.factory_vqa(opt, words, answers)
    vqa_engine.init_vqa_params(model, seed=4)
    return model.to(dev), VQAArrays(examples, store, samplingans=True)


@pytest.mark.parametrize("name,seq2vec", [
    ("default.yaml", None), ("mlb_att_trainval.yaml", None),
    ("default.yaml", {"arch": "lstm", "emb_size": 16, "hidden_size": 48}),
    ("default.yaml", {"arch": "2-lstm", "emb_size": 16, "hidden_size": 48})],
    ids=["mlb_noatt", "mlb_att", "lstm", "2-lstm"])
def test_captured_mlb_train_step_equals_eager(dev, monkeypatch, name,
                                              seq2vec):
    """MLBNoAtt (UniSkip: the no-mask GRU pair), MLBAtt (BayesianUniSkip,
    4 glimpses) and MLBNoAtt over the LSTM encoders: two epochs of
    captured steps against eager ones from one start, dropout on, bit for
    bit (metrics, parameters, Adam moments)."""
    import copy

    from vqa_counterexamples_tpu_torch.engines import vqa_engine

    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    model, arrays = _tiny_mlb(dev, name, seq2vec)
    att = type(model).__name__ == "MLBAtt"
    feats = None if att else arrays.store.to_device(dev)
    runs = []
    for capture, m in ((None, model), (False, copy.deepcopy(model))):
        state = vqa_engine.init_vqa_state(m, lr=1e-3)
        step = vqa_engine.make_vqa_train_step(m, state.optimizer,
                                              base_seed=7, capture=capture)
        rng = np.random.default_rng(1)
        metrics = []
        for _ in range(2):
            for batch in arrays.batches(8, rng=rng, device_features=feats,
                                        device=dev):
                state, out = step(state, batch)
                metrics.append([float(out[k]) for k in
                                ("loss", "acc1", "acc5")])
        runs.append((m, state, step, metrics))
    (m_cap, s_cap, step_cap, met_cap), (m_eag, s_eag, _, met_eag) = runs
    assert step_cap.graphed.n_graphs == 2   # B 8 and the short B 4
    assert met_cap == met_eag and np.isfinite(met_cap).all()
    _assert_same_training(m_cap, s_cap.optimizer, m_eag, s_eag.optimizer)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pinned_native_batches_match_host_path(dev, tmp_path, dtype):
    """Att-map batches of an ``.att.npy`` store (f32, and bf16 as its
    uint16 bit-view) through the native store's prefetch tickets into the
    pinned buffers: the host path's batches bit for bit, no ticket left
    when the pass ends or when the generator is closed after one batch."""
    import ml_dtypes

    from vqa_counterexamples_tpu_torch.data.features import FeatureStore
    from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays

    rng = np.random.default_rng(0)
    feats = rng.normal(size=(20, 3, 3, 8)).astype(np.float32)
    if dtype == "bfloat16":
        feats = feats.astype(ml_dtypes.bfloat16)
    names = ["n%d" % i for i in range(20)]
    prefix = str(tmp_path / "trainset")
    np.save(prefix + ".att.npy", feats.view(np.uint16)
            if dtype == "bfloat16" else feats)
    with open(prefix + ".txt", "w") as f:
        f.write("\n".join(names) + "\n")
    examples = [{"question_id": i, "question_wids": [1, 2, 0],
                 "image_name": names[int(rng.integers(0, 20))],
                 "answer_aid": i % 3, "answers_aid": [i % 3, 1],
                 "answers_count": [3, 2]} for i in range(37)]
    store = FeatureStore.load(prefix, dataset="att")
    arrays = VQAArrays(examples, store, samplingans=True)
    assert arrays.gather_path == "native"
    host = list(arrays.batches(8, rng=np.random.default_rng(1)))
    card = list(arrays.batches(8, rng=np.random.default_rng(1), device=dev))
    torch.cuda.synchronize()
    assert len(card) == len(host) == 5 and store.outstanding == 0
    for c, h in zip(card, host):
        assert c["visual"].dtype == (torch.bfloat16 if dtype == "bfloat16"
                                     else torch.float32)
        got = c["visual"].cpu()
        if dtype == "bfloat16":
            got = got.view(torch.int16).numpy().view(np.uint16)
            want = np.asarray(h["visual"]).view(np.uint16)
        else:
            got, want = got.numpy(), h["visual"]
        np.testing.assert_array_equal(got, want)
    gen = arrays.batches(8, shuffle=False, device=dev)
    next(gen)
    assert store.outstanding == 1
    gen.close()
    assert store.outstanding == 0


# ------------------------------------------- the GRU's input projection
#
# The three kernels (``csrc/xproj.cu``, ``ops/cuda/xproj_kernel.py``)
# against their plain versions.  The kernels sum the same exact bf16 products in another
# order than cuBLAS's f32 SGEMM, so an entry may differ where that f32 sum
# lands near a rounding boundary: each bf16 rounding may move by one bf16
# step (2^-7 of the value at most), and an f32 sum by a few f32 steps of
# the sum of its terms' magnitudes (2^-20 of it here), which outweighs one
# bf16 step only where the terms cancel.  Outside those bounds nothing may
# differ, and only a small share of entries may differ at all.

BF16_STEP, F32_SLACK = 2.0 ** -7, 2.0 ** -20


def _xproj_inputs(dev, batch, seq_len, dim_in, dim_h, mask_kind, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(batch, seq_len, dim_in, generator=gen, device=dev) * .02
    w = (torch.randn(3 * dim_h, dim_in, generator=gen, device=dev)
         * (3 * dim_h) ** -0.5)
    b = torch.randn(3 * dim_h, generator=gen, device=dev) * 0.02
    lead = {"none": None, "shared": (), "per_gate": (3,)}[mask_kind]
    mask = None if lead is None else (torch.rand(
        lead + (batch, dim_in), generator=gen, device=dev) > 0.25
        ).float() * (1 / 0.75)
    dout = (torch.randn(seq_len, batch, 3 * dim_h, generator=gen,
                        device=dev) * 1e-3).to(torch.bfloat16)
    return x, w, b, mask, dout


def _within(name, got, ref, steps, slack, share):
    """|got - ref| <= steps + slack everywhere; at most ``share`` of the
    entries differ at all."""
    diff = (got.float() - ref.float()).abs()
    out = (diff > steps + slack).sum().item()
    off = (diff > 0).float().mean().item()
    assert out == 0 and off <= share, (name, out, off, diff.max().item())


@pytest.mark.parametrize("batch,seq_len,dim_in,dim_h,mask_kind", [
    (3, 4, 20, 12, "per_gate"), (5, 7, 36, 40, "shared"),
    (70, 3, 100, 24, "none"), (70, 3, 100, 24, "per_gate"),
    (512, 26, 620, 2400, "per_gate"), (512, 26, 620, 2400, "none"),
    (2048, 26, 620, 2400, "none"), (128, 26, 620, 2400, "per_gate"),
    (1, 26, 620, 2400, "none"), (32, 26, 620, 2400, "none")])
def test_xproj_kernels_match_plain(dev, batch, seq_len, dim_in, dim_h,
                                   mask_kind):
    """The forward, dX and dW / db kernels against the plain versions at
    small ragged shapes and at the paths' shapes (MutanNoAtt's train and
    val batches, the q cache's B 2,048, MutanAtt's B 128, the server's B 1
    and B 32); the forward's bf16(x * m) bit-equal to the plain operand;
    reruns bit-equal; the autograd Function giving the kernels' bits, one
    launch of each counted."""
    x, w, b, mask, dout = _xproj_inputs(dev, batch, seq_len, dim_in, dim_h,
                                        mask_kind)
    before = [launched(n) for n in ("xproj", "xproj_dx", "xproj_dw")]
    out, xm, wp = xproj_kernel._fwd(x, mask, w, b)
    assert torch.equal(wp, w.to(torch.bfloat16))
    dx = xproj_kernel.x_proj_dx(dout, mask, wp)
    dw, db = xproj_kernel.x_proj_dw(dout, xm)
    xm_ref = xproj_kernel.x_proj_operand_plain(x, mask)
    assert torch.equal(xm, xm_ref)
    assert torch.equal(xproj_kernel._fwd(x, mask, w, b)[0], out)
    rows, gates = batch * seq_len, xm.shape[0]
    xf, w16 = xm_ref.float(), w.to(torch.bfloat16).float()
    dg = dout.reshape(rows, 3 * dim_h).float()
    cols = 3 * dim_h // gates
    # the forward: |x m| |W| summed, per output entry
    mag = torch.cat([xf[g].abs() @ w16[g * cols:(g + 1) * cols].abs().t()
                     for g in range(gates)], 1) + b.abs()
    ref = xproj_kernel.x_proj_plain(x, mask, w, b)
    _within("out", out, ref, BF16_STEP * ref.float().abs(),
            F32_SLACK * mag.reshape(ref.shape), 0.01)
    # dX: each gate's rounded product, masked
    masks = xproj_kernel._gate_masks(mask, seq_len)
    dg_cols = 3 * dim_h // gates
    steps = slack = 0
    for g in range(gates):
        part = dg[:, g * dg_cols:(g + 1) * dg_cols]
        wg = w16[g * dg_cols:(g + 1) * dg_cols]
        m = 1.0 if masks[g] is None else masks[g]
        steps = steps + BF16_STEP * (part @ wg).abs() * m
        slack = slack + F32_SLACK * (part.abs() @ wg.abs()) * m
    dx_ref = xproj_kernel.x_proj_dx_plain(dout, mask, w)
    to_bt = lambda t: t.reshape(seq_len, batch, -1).transpose(0, 1)
    _within("dx", dx, dx_ref, to_bt(steps) + 1e-5 * dx_ref.abs(),
            to_bt(slack), 0.02)
    dw_ref, db_ref = xproj_kernel.x_proj_dw_plain(dout, xm_ref)
    dw_mag = torch.cat([dg[:, g * cols:(g + 1) * cols].abs().t()
                        @ xf[g].abs() for g in range(gates)])
    _within("dW", dw, dw_ref, BF16_STEP * dw_ref.abs(), F32_SLACK * dw_mag,
            0.05)
    # db is an f32 sum over every row, in another order: most of its
    # entries differ in their last bits, so only the bound holds it
    _within("db", db, db_ref, 1e-5 * db_ref.abs(),
            F32_SLACK * dg.abs().sum(0), 1.0)
    again = (xproj_kernel.x_proj_dx(dout, mask, wp),
             xproj_kernel.x_proj_dw(dout, xm))
    assert torch.equal(again[0], dx) and torch.equal(again[1][0], dw)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    got = xproj_kernel.x_proj(*leaves[:1], mask, *leaves[1:])
    got.backward(dout)
    torch.cuda.synchronize()
    assert torch.equal(got, out)
    for leaf, want in zip(leaves, (dx, dw, db)):
        assert torch.equal(leaf.grad, want)
    after = [launched(n) for n in ("xproj", "xproj_dx", "xproj_dw")]
    assert [a - c for a, c in zip(after, before)] == [3, 3, 3]


def test_xproj_under_no_grad_launches_the_forward_alone(dev):
    """Evaluation (grad off) launches the forward and writes no operand
    for dW; an operand that requires grad with grad mode on goes through
    the Function, whose backward launches dX only when x needs it."""
    x, w, b, mask, dout = _xproj_inputs(dev, 8, 5, 24, 16, "per_gate")
    counters = ("xproj", "xproj_dx", "xproj_dw")
    before = [launched(n) for n in counters]
    with torch.no_grad():
        out = xproj_kernel.x_proj(x, mask, w.requires_grad_(True), b)
    assert not out.requires_grad
    out = xproj_kernel.x_proj(x, mask, w, b)
    out.backward(dout)
    torch.cuda.synchronize()
    assert [launched(f) - n for f, n in zip(counters, before)] == [2, 0, 1]
    assert w.grad is not None and w.grad.dtype == torch.float32


def test_captured_mutan_noatt_step_at_full_width_equals_eager(dev,
                                                              monkeypatch):
    """MutanNoAtt at ``mutan_noatt_train.yaml``'s widths (BayesianUniSkip
    620 -> 2400 with per-gate masks, MUTAN R 10 at 360, dim_v 2048), B 64:
    the captured train step (its graph holding the projection's forward,
    dX and dW kernels) against the eager step from one starting state,
    dropout on: losses, every parameter and Adam moment bit-equal, the
    projection's kernels counted once a step each."""
    import copy
    import os

    from vqa_counterexamples_tpu_torch.core import config as config_lib
    from vqa_counterexamples_tpu_torch.data import synthetic
    from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays
    from vqa_counterexamples_tpu_torch.engines import vqa_engine
    from vqa_counterexamples_tpu_torch.models import factory

    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    opt = config_lib.load_options_file(os.path.join(
        repo, "configs", "vqa2", "mutan_noatt_train.yaml"))["model"]
    examples, store, words, answers = synthetic.make_synthetic_vqa(
        160, 50, 26, dim_v=opt["fusion"]["dim_v"], seed=3)
    model = factory.factory_vqa(opt, words, answers)
    vqa_engine.init_vqa_params(model, seed=5)
    model = model.to(dev)
    arrays = VQAArrays(examples, store, samplingans=True)
    feats = store.to_device(dev)
    runs = []
    for capture, m in ((None, model), (False, copy.deepcopy(model))):
        state = vqa_engine.init_vqa_state(m, lr=1e-3)
        step = vqa_engine.make_vqa_train_step(m, state.optimizer,
                                              base_seed=11, capture=capture)
        before = launched("xproj_dw")
        rng = np.random.default_rng(4)
        metrics = []
        for batch in arrays.batches(64, rng=rng, device_features=feats,
                                    device=dev):
            state, out = step(state, batch)
            metrics.append([float(out[k]) for k in ("loss", "acc1")])
        torch.cuda.synchronize()
        runs.append((m, state, metrics,
                     launched("xproj_dw") - before))
    (m_cap, s_cap, met_cap, n_cap), (m_eag, s_eag, met_eag, n_eag) = runs
    assert s_cap.step == s_eag.step == 3 and n_cap == n_eag == 3
    assert met_cap == met_eag and np.isfinite(met_cap).all()
    _assert_same_training(m_cap, s_cap.optimizer, m_eag, s_eag.optimizer)
