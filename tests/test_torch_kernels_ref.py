"""Each CUDA kernel's plain PyTorch version against the TPU kernel it
replaces, run as the JAX package's own tests run it on the CPU (Mosaic
interpret mode).  Inputs are made with numpy from a seed and handed to
both; the plain versions are what the kernel wrappers run on a CPU tensor.

Tolerances (bf16 kernels) follow the JAX kernel tests: GRU states 5e-2
(tests/test_pallas_gru.py), vfeat h 3e-2 and dist 1e-4
(tests/test_vfeat_kernel.py), mixture rtol 2e-2 / atol 2e-3
(tests/test_fused_head.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_counterexamples_tpu.ops.pallas.gru_kernel import (
    LANE, gru_fwd_pallas, interleave_gates)
from vqa_counterexamples_tpu.ops.pallas.mixture_kernel import (
    classify_softmax_pallas)
from vqa_counterexamples_tpu.ops.pallas.vfeat_kernel import (
    vfeat_scores_pallas)
from vqa_counterexamples_tpu_torch.core import spans
from vqa_counterexamples_tpu_torch.ops.cuda import (
    gru_kernel, mixture_kernel, vfeat_kernel)


def _bf16(a):
    """numpy f32 values rounded to bf16 (so both sides see equal inputs)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _to_jax_gates(a, dim_h, hp):
    """(..., 3H) gate-major -> (..., 3Hp) padded, gate-interleaved."""
    a3 = a.reshape(a.shape[:-1] + (3, dim_h))
    pad = [(0, 0)] * (a3.ndim - 1) + [(0, hp - dim_h)]
    return np.asarray(interleave_gates(jnp.asarray(np.pad(a3, pad))))


def _from_jax_gates(a, dim_h, hp):
    """Inverse of :func:`_to_jax_gates`."""
    j = hp // LANE
    a = a.reshape(a.shape[:-1] + (j, 3, LANE))
    a = np.swapaxes(a, -3, -2).reshape(a.shape[:-3] + (3, hp))
    return a[..., :dim_h].reshape(a.shape[:-2] + (3 * dim_h,))


@pytest.mark.parametrize("seq,batch,dim_h,with_mask", [
    (5, 4, 20, False), (5, 4, 20, True), (7, 9, 130, True)])
def test_gru_plain_matches_pallas(seq, batch, dim_h, with_mask):
    rng = np.random.default_rng(seq * 100 + dim_h)
    hp = -(-dim_h // LANE) * LANE
    xp = _bf16(rng.normal(size=(seq, batch, 3 * dim_h)))
    w_hh = _bf16(rng.normal(size=(dim_h, 3 * dim_h)) * 0.2)  # (H, 3H)
    b_hh = (rng.normal(size=(3 * dim_h,)) * 0.1).astype(np.float32)
    mask = (_bf16((rng.random((batch, dim_h)) > 0.3) * 1.25)
            if with_mask else np.ones((batch, dim_h), np.float32))

    w_j = np.pad(_to_jax_gates(w_hh, dim_h, hp), ((0, hp - dim_h), (0, 0)))
    states_j, hproj_j = gru_fwd_pallas(
        jnp.asarray(_to_jax_gates(xp, dim_h, hp), jnp.bfloat16),
        jnp.asarray(w_j, jnp.bfloat16),
        jnp.asarray(_to_jax_gates(b_hh, dim_h, hp))[None],
        jnp.asarray(np.pad(mask, ((0, 0), (0, hp - dim_h))), jnp.bfloat16),
        interpret=True)

    states_p, hproj_p = gru_kernel.gru_recurrence(
        torch.from_numpy(xp).to(torch.bfloat16),
        torch.from_numpy(w_hh.T.copy()).to(torch.bfloat16),
        torch.from_numpy(b_hh),
        torch.from_numpy(mask).to(torch.bfloat16) if with_mask else None,
        want_hproj=True)
    assert states_p.dtype == torch.bfloat16
    assert tuple(states_p.shape) == (seq, batch, dim_h)
    np.testing.assert_allclose(
        states_p.float().numpy(),
        np.asarray(states_j[:, :, :dim_h], np.float32), atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(
        hproj_p.float().numpy(),
        _from_jax_gates(np.asarray(hproj_j, np.float32), dim_h, hp),
        atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("n_rows,dim_v,batch,knn,dim_h", [
    (40, 128, 32, 5, 16), (70, 256, 64, 3, 40)])
def test_vfeat_plain_matches_pallas(n_rows, dim_v, batch, knn, dim_h):
    rng = np.random.default_rng(dim_v + knn)
    table = _bf16(rng.normal(size=(n_rows, dim_v)))
    idx = rng.integers(0, n_rows, size=(batch, knn + 1)).astype(np.int32)
    w_o = _bf16(rng.normal(size=(dim_h, dim_v)) * 0.1)  # (H, Dv)
    w_m = _bf16(rng.normal(size=(dim_h, dim_v)) * 0.1)

    xk3 = np.transpose(table[idx[:, 1:]], (1, 0, 2))   # K-major (K, B, Dv)
    h_j, d_j = vfeat_scores_pallas(
        jnp.asarray(xk3, jnp.bfloat16), jnp.asarray(table[idx[:, 0]],
                                                     jnp.bfloat16),
        jnp.asarray(w_o, jnp.bfloat16), jnp.asarray(w_m, jnp.bfloat16),
        0, True)

    h_p, d_p = vfeat_kernel.vfeat_scores(
        torch.from_numpy(table).to(torch.bfloat16), torch.from_numpy(idx),
        torch.from_numpy(w_o).to(torch.bfloat16),
        torch.from_numpy(w_m).to(torch.bfloat16))
    assert tuple(h_p.shape) == (batch, knn, dim_h)
    assert h_p.dtype == torch.bfloat16 and d_p.dtype == torch.float32
    np.testing.assert_allclose(
        h_p.float().numpy(),
        np.transpose(np.asarray(h_j, np.float32), (1, 0, 2)),
        rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(
        d_p.numpy(), np.transpose(np.asarray(d_j)[..., 0], (1, 0)),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rows,dim_z,n_ans", [(70, 24, 50), (33, 40, 130),
                                             (40, 360, 2000)])
def test_mixture_plain_matches_pallas(rows, dim_z, n_ans):
    rng = np.random.default_rng(rows + n_ans)
    z = _bf16(rng.normal(size=(rows, dim_z)))
    w = (rng.normal(size=(dim_z, n_ans)) * 0.3).astype(np.float32)
    b = rng.normal(size=(n_ans,)).astype(np.float32)
    out_j = classify_softmax_pallas(jnp.asarray(z, jnp.bfloat16),
                                    jnp.asarray(w), jnp.asarray(b), 32, True)
    out_p = mixture_kernel.classify_softmax(
        torch.from_numpy(z).to(torch.bfloat16),
        torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    assert out_p.dtype == torch.bfloat16
    np.testing.assert_allclose(out_p.float().numpy(),
                               np.asarray(out_j, np.float32),
                               rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(out_p.float().numpy().sum(1), np.ones(rows),
                               rtol=2e-2)


@pytest.mark.parametrize("dim_z,n_ans", [
    (360, 2000), (24, 50), (20, 7), (100, 333), (360, 1999), (360, 4500),
    (512, 2000), (36, 8000)])
def test_mixture_plan_covers_the_answers_and_fits(dim_z, n_ans):
    """The mixture kernel's plan: its cluster's CTAs cover every answer
    (cl * cw >= A, each CTA's columns a whole number of 256-answer tiles,
    no CTA wholly past A beyond the tiles' rounding), a W ring of 2 to
    MAX_STAGES stages, one CTA's shared memory within the H100's 232,448
    bytes; at the CX path's (dz 360, A 2000) four CTAs of 512 answers and
    3 stages."""
    cl, cw, stages = mixture_kernel.mixture_plan(dim_z, n_ans)
    assert cl in (2, 4, 8) and cw % 256 == 0
    assert 2 <= stages <= mixture_kernel.MAX_STAGES
    assert cl * cw >= n_ans and cw - 256 < -(-n_ans // cl)
    assert mixture_kernel.mixture_smem(-(-dim_z // 64), cw,
                                       stages) <= 232448
    if (dim_z, n_ans) == (360, 2000):
        assert (cl, cw, stages) == (4, 512, 3)


@pytest.mark.parametrize("sections,message", [
    ("mixture,mutan,attmutan_fwd,attmutan_bwd", "no CUDA device"), ("mixture,bogus", None),
    ("vfeat", "no CUDA device")])
def test_probe_kernels_needs_a_card_and_known_sections(monkeypatch, capsys,
                                                       sections, message):
    """``cli/probe_kernels`` runs only the sections it knows and only on a
    card: a known pick without a card stops with its message, an unknown
    one is refused by the parser (exit 2) before the card is asked for."""
    from vqa_counterexamples_tpu_torch.cli import probe_kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as stop:
        probe_kernels.main(["--sections", sections, "--out", "unused.json"])
    if message is None:
        assert stop.value.code == 2
        assert "--sections" in capsys.readouterr().err
    else:
        assert message in str(stop.value.code)


# (B, K, dim_v, H): the CX path's, the card tests' ragged ones, and K 2
_VFEAT_SHAPES = [(768, 24, 2048, 300), (5, 6, 40, 20), (3, 24, 36, 70),
                 (70, 24, 128, 300), (71, 23, 128, 300), (45, 7, 256, 158),
                 (33, 2, 256, 300), (3000, 24, 4096, 600)]


def _distinct_examples(rows, k, tile):
    """The most examples any ``tile`` consecutive GEMM rows (from a tile
    boundary) touch."""
    return max((min(rows, r0 + tile) - 1) // k - r0 // k + 1
               for r0 in range(0, rows, tile))


@pytest.mark.parametrize("batch,k,dim_v,dim_h", _VFEAT_SHAPES)
def test_vfeat_fwd_plan_covers_the_rows_and_fits(batch, k, dim_v, dim_h):
    """The vfeat forward's plan: 128-row x 152-column CTAs cover every
    candidate row and output column with no CTA wholly outside, a stage
    holds every distinct o row a tile touches, the ring (2 or 3 stages)
    fits the H100's 232,448 bytes of shared memory and a consumer's f32
    accumulators (both products' m64 x 152 fragments) its register budget;
    at the CX path's shape 144 x 2 CTAs with 7 o rows and 3 stages."""
    rows = batch * k
    row_tiles, col_tiles, n_o, stages, smem = vfeat_kernel.fwd_plan(
        batch, k, dim_v, dim_h)
    assert (row_tiles - 1) * 128 < rows <= row_tiles * 128
    assert (col_tiles - 1) * 152 < dim_h <= col_tiles * 152
    assert _distinct_examples(rows, k, 128) <= n_o <= 128
    assert stages in (2, 3)
    assert smem == vfeat_kernel.fwd_smem(n_o, stages) <= 232448
    assert vfeat_kernel.ACC_PER_THREAD <= vfeat_kernel.ACC_MAX
    if (batch, k, dim_v, dim_h) == (768, 24, 2048, 300):
        assert (row_tiles, col_tiles, n_o, stages) == (144, 2, 7, 3)


# clusters of 1 to 8 backward CTAs (about 200 KB of shared memory each)
# that an H100 80GB HBM3 (132 SMs) holds at once, as
# cudaOccupancyMaxActiveClusters reports them
_H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


@pytest.mark.parametrize("batch,k,dim_v,dim_h", _VFEAT_SHAPES)
def test_vfeat_bwd_plan_covers_the_tile_and_fits(batch, k, dim_v, dim_h):
    """The vfeat backward's plan on an H100's cluster occupancy: 64 (d) x
    304 (h) tiles cover both weight gradients; the cluster's CTAs split the
    64-row chunks so that every CTA has at least one and their ranges cover
    all of them; the split takes the fewest chunks a CTA times waves of
    clusters; a stage holds every distinct o row a chunk touches; the ring
    (which also stages the f32 partials) fits shared memory at 2 or 3
    stages.  At the CX path's shape: 32 x 1 tiles in clusters of 3, one
    wave of 96 CTAs (clusters of 4 would take two waves: the card holds 30),
    4 o rows, 3 stages."""
    rows = batch * k
    d_tiles, h_tiles, cl, n_o, stages, smem = vfeat_kernel.bwd_plan(
        batch, k, dim_v, dim_h, _H100_CLUSTERS.get)
    assert (d_tiles - 1) * 64 < dim_v <= d_tiles * 64
    assert (h_tiles - 1) * 304 < dim_h <= h_tiles * 304
    chunks = -(-rows // 64)
    assert 1 <= cl <= min(8, chunks)
    ranges = [(r * chunks // cl, (r + 1) * chunks // cl) for r in range(cl)]
    assert ranges[0][0] == 0 and ranges[-1][1] == chunks
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))

    def cost(c):
        return -(-d_tiles * h_tiles // _H100_CLUSTERS[c]) * -(-chunks // c)

    assert cost(cl) == min(cost(c) for c in range(1, min(8, chunks) + 1))
    assert _distinct_examples(rows, k, 64) <= n_o <= 64
    assert stages in (2, 3)
    assert smem == vfeat_kernel.bwd_smem(n_o, stages) <= 232448
    if (batch, k, dim_v, dim_h) == (768, 24, 2048, 300):
        assert (d_tiles, h_tiles, cl, n_o, stages) == (32, 1, 3, 4, 3)


def test_vfeat_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="even"):
        vfeat_kernel.fwd_plan(4, 24, 37, 300)
    with pytest.raises(ValueError, match="even"):
        vfeat_kernel.bwd_plan(4, 24, 2048, 301, _H100_CLUSTERS.get)
    # K 1: 128 distinct o rows a stage still fit a 2-stage ring
    assert vfeat_kernel.fwd_plan(768, 1, 2048, 300)[2:4] == (128, 2)


def test_mixture_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        mixture_kernel.mixture_plan(2048, 2000)


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers take the plain version and count no
    launch (the count is of kernel launches only)."""
    before = spans.counters()
    gru_kernel.gru_recurrence(torch.zeros(2, 3, 6, dtype=torch.bfloat16),
                              torch.zeros(6, 2, dtype=torch.bfloat16),
                              torch.zeros(6))
    vfeat_kernel.vfeat_scores(torch.zeros(4, 8, dtype=torch.bfloat16),
                              torch.zeros(2, 3, dtype=torch.int32),
                              torch.zeros(5, 8, dtype=torch.bfloat16),
                              torch.zeros(5, 8, dtype=torch.bfloat16))
    mixture_kernel.classify_softmax(torch.zeros(3, 4, dtype=torch.bfloat16),
                                    torch.zeros(7, 4, dtype=torch.bfloat16),
                                    torch.zeros(7, dtype=torch.bfloat16))
    after = spans.counters()
    for name in ("gru", "vfeat", "mixture"):
        key = "kernels.launches." + name
        assert type(after[key]) is int and after[key] == before[key]


@pytest.mark.parametrize("gates", [0, 1, 3])
@pytest.mark.parametrize("dim_h", [20, 36, 2400])
@pytest.mark.parametrize("batch", [5, 65, 128, 512, 2048])
def test_gru_fwd_tile_chooser(batch, dim_h, gates):
    """The forward's tile for each (B, H, gates) on the H100's 132 SMs: H
    off TMA's 8-element rule takes the plain-load tile, the rest a TMA
    tile of the kernel's table; the ring fits the block's shared memory at
    3 or more stages; at the paths' width, one wave of 120 blocks at B 128
    (64 x 40) and B 512 (128 x 80), and 128 x 80 at B 2048; 128-byte
    stages where three fit (per-gate masks at 128 x 80 take 64-byte
    ones)."""
    tile = gru_kernel.fwd_tile(batch, dim_h, gates, 132, dim_h % 8 == 0)
    assert tile.tma == (dim_h % 8 == 0)
    shape = (tile.bm, tile.bj, tile.bk)
    assert shape in (gru_kernel.FWD_TILES if tile.tma
                     else (gru_kernel.RAGGED_TILE,))
    assert 3 <= tile.stages <= (gru_kernel.MAX_STAGES_PER_GATE if gates == 3
                                else gru_kernel.MAX_STAGES)
    assert (tile.stages * gru_kernel.fwd_stage_bytes(gates, *shape)
            <= gru_kernel.SMEM_BLOCK)
    grid = -(-dim_h // tile.bj) * -(-batch // tile.bm)
    if dim_h == 2400:
        bk = 32 if gates == 3 else 64
        want = {128: ((64, 40, 64), 120), 512: ((128, 80, bk), 120),
                2048: ((128, 80, bk), 480)}.get(batch)
        if want is not None:
            assert (shape, grid) == want
    # a forced plain-load tile stays the plain-load one
    assert not gru_kernel.fwd_tile(batch, dim_h, gates, 132, False).tma


def test_gru_fwd_tiles_match_the_kernels_instances():
    """FWD_TILES and RAGGED_TILE name exactly the instances csrc/gru.cu
    compiles (VQACX_FWD_TILES), each for one and for three gate masks."""
    import re
    from pathlib import Path

    src = (Path(gru_kernel.__file__).resolve().parents[2] / "csrc"
           / "gru.cu").read_text()
    table = src[src.index("#define VQACX_FWD_TILES"):]
    table = table[:table.index("\n\n")]
    got = {(int(ng), 64 * int(wg), int(bj), int(bk), tma == "true")
           for ng, wg, bj, bk, tma in re.findall(
               r"X\((\d), (\d), (\d+), (\d+), (true|false)\)", table)}
    want = {(ng, bm, bj, bk, True) for bm, bj, bk in gru_kernel.FWD_TILES
            for ng in (1, 3)}
    want |= {(ng,) + gru_kernel.RAGGED_TILE + (False,) for ng in (1, 3)}
    assert got == want


@pytest.mark.parametrize("dim_h", [64, 72, 2400])
@pytest.mark.parametrize("batch", [16, 64, 128, 512, 768])
def test_gru_bwd_tile_chooser(batch, dim_h):
    """The backward's tile for each (B, H) on the H100's 132 SMs: H off
    the 16-unit rule takes the plain-load tile, the rest the TMA tile of
    the kernel's table that pulls the fewest bytes from L2 per SM, at 2 to
    BWD_MAX_STAGES stages that fit the block's shared memory.  Where a
    tile's grid covers 90% of the SMs (B 512 and B 768 at H 2400), the
    chosen one's first wave does too: 120 blocks of 128 x 80 at B 512, 132
    of its 180 at B 768; B 128 takes 64 x 48 (100 blocks, the most any
    tile of the table gives there)."""
    tile = gru_kernel.bwd_tile(batch, dim_h, 132, dim_h % 16 == 0)
    assert tile.tma == (dim_h % 16 == 0)
    shape = (tile.bm, tile.bn)
    assert shape in (gru_kernel.BWD_TILES if tile.tma
                     else (gru_kernel.BWD_RAGGED_TILE,))
    assert 2 <= tile.stages <= gru_kernel.BWD_MAX_STAGES
    assert (tile.stages * gru_kernel.bwd_stage_bytes(*shape)
            <= gru_kernel.SMEM_BLOCK)

    def grid(bm, bn):
        return gru_kernel.bwd_waves(batch, dim_h, bm, bn, 132)

    if tile.tma:
        costs = [grid(*t)[1] * sum(t) for t in gru_kernel.BWD_TILES]
        assert grid(*shape)[1] * sum(shape) == min(costs)
        if max(grid(*t)[0] for t in gru_kernel.BWD_TILES) >= 0.9 * 132:
            assert min(grid(*shape)[0], 132) >= 0.9 * 132
    if dim_h == 2400:
        want = {64: ((64, 48), 50), 128: ((64, 48), 100),
                512: ((128, 80), 120), 768: ((128, 80), 180)}.get(batch)
        if want is not None:
            assert (shape, grid(*shape)[0]) == want
    # a forced plain-load tile stays the plain-load one
    assert not gru_kernel.bwd_tile(batch, dim_h, 132, False).tma


def test_gru_bwd_tiles_match_the_kernels_instances():
    """BWD_TILES and BWD_RAGGED_TILE name exactly the instances csrc/gru.cu
    compiles (VQACX_BWD_TILES)."""
    import re
    from pathlib import Path

    src = (Path(gru_kernel.__file__).resolve().parents[2] / "csrc"
           / "gru.cu").read_text()
    table = src[src.index("#define VQACX_BWD_TILES"):]
    table = table[:table.index("\n\n")]
    got = {(64 * int(wg), int(bn), tma == "true")
           for wg, bn, tma in re.findall(
               r"X\((\d), (\d+), (true|false)\)", table)}
    want = {t + (True,) for t in gru_kernel.BWD_TILES}
    want.add(gru_kernel.BWD_RAGGED_TILE + (False,))
    assert got == want
