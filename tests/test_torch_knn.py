"""The kNN builder in the PyTorch port against the JAX package: the fused
kernel's plain version against ``topk.knn_chunk`` and the Pallas kernel
(interpret mode), the kernel's split-TF32 scores (emulated) and corpus
slicing, the chunk loop ``ops/topk.knn``, the ``.npy`` + ``.txt``
feature store, and ``cli/knn.py`` (the results file and the VQA-format
json), with its device rule and the flags that are not ported.

Tolerances: the same indices; distances within rtol 1e-4 and atol 5e-3,
as ``tests/test_pallas_knn.py`` (f32 sums in another order; the
self-distance is f32 cancellation noise around 0 on both sides).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_counterexamples_tpu.cli import knn as jax_knn_cli
from vqa_counterexamples_tpu.data.features import FeatureStore as JaxStore
from vqa_counterexamples_tpu.ops import topk as jax_topk
from vqa_counterexamples_tpu.ops.pallas.knn_kernel import knn_chunk_pallas
from vqa_counterexamples_tpu_torch.cli import knn as port_knn_cli
from vqa_counterexamples_tpu_torch.core import spans
from vqa_counterexamples_tpu_torch.data.features import FeatureStore
from vqa_counterexamples_tpu_torch.ops import topk as port_topk
from vqa_counterexamples_tpu_torch.ops.cuda import knn_kernel

TOL = dict(rtol=1e-4, atol=5e-3)


def _corpus(n, dim, seed):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(
        np.float32)


@pytest.mark.parametrize("n,dim,bq,k,self_query", [
    (300, 32, 24, 5, True), (197, 16, 9, 7, False), (129, 40, 33, 25, True)])
def test_knn_chunk_plain_matches_jax(n, dim, bq, k, self_query):
    """``knn_chunk_plain`` (and the wrapper, plain on CPU tensors) against
    ``topk.knn_chunk`` and ``knn_chunk_pallas`` in interpret mode (a corpus
    off the 128-column tile: its padding never wins)."""
    corpus = _corpus(n, dim, seed=n)
    queries = (corpus[:bq] if self_query
               else _corpus(bq, dim, seed=n + 1))
    d_ref, i_ref = jax_topk.knn_chunk(jnp.asarray(queries),
                                      jnp.asarray(corpus), k)
    d_pal, i_pal = knn_chunk_pallas(jnp.asarray(queries), jnp.asarray(corpus),
                                    k, tile_n=128, interpret=True)
    before = spans.counters()["kernels.launches.knn"]
    for fn in (knn_kernel.knn_chunk_plain, knn_kernel.knn_chunk):
        dist, idx = fn(torch.from_numpy(queries), torch.from_numpy(corpus), k)
        assert dist.dtype == torch.float32 and idx.dtype == torch.int32
        assert dist.shape == idx.shape == (bq, k)
        for d_j, i_j in ((d_ref, i_ref), (d_pal, i_pal)):
            np.testing.assert_array_equal(idx.numpy(), np.asarray(i_j))
            np.testing.assert_allclose(dist.numpy(), np.asarray(d_j), **TOL)
        assert int(idx.max()) < n
        if self_query:
            np.testing.assert_array_equal(idx[:, 0].numpy(), np.arange(bq))
    # the CPU: plain
    assert spans.counters()["kernels.launches.knn"] == before


def _knn_split_tf32(queries, corpus, k):
    """``knn_chunk_plain`` with the dot products as the kernel forms them:
    lo.hi + hi.lo + hi.hi of the split operands, f32 sums (each product of
    two TF32 values is exact in f32); only the sums' order and the tensor
    cores' rounding differ from the kernel's selection."""
    (qh, ql), (ch, cl) = (knn_kernel.split_tf32(queries),
                          knn_kernel.split_tf32(corpus))
    dots = ql @ ch.t() + qh @ cl.t() + qh @ ch.t()
    neg = (2.0 * dots - (queries * queries).sum(1, keepdim=True)
           - (corpus * corpus).sum(1)[None, :])
    top, idx = torch.topk(neg, k, dim=1)
    return torch.sqrt(torch.clamp(-top, min=0.0)), idx.to(torch.int32)


@pytest.mark.parametrize("n,dim,bq,k", [(5000, 256, 64, 25),
                                        (3000, 2048, 32, 25)])
def test_split_tf32_scores_keep_the_neighbour_contract(n, dim, bq, k):
    """The kernel's split TF32 (three TF32 products per f32 one),
    emulated, selects what the plain f32 version selects, under
    chip_smoke.check_knn's contract: rank 0 is the query itself, the same
    neighbour at every rank whose plain distance is further than twice the
    tolerance (rtol 1e-4) from both of its neighbours, and those distances
    within it; at a COCO-like shape and at the builder's width.  The
    self-distance (0 up to f32 noise) is the kernel's rescoring pass's,
    held on the card (tests/test_torch_cuda.py)."""
    corpus = torch.from_numpy(_corpus(n, dim, seed=dim))
    pick = torch.from_numpy(
        np.random.default_rng(1).choice(n, bq, replace=False))
    queries = corpus[pick].contiguous()
    dist, idx = _knn_split_tf32(queries, corpus, k)
    ref_d, ref_i = knn_kernel.knn_chunk_plain(queries, corpus, k + 1)
    assert dist.dtype == torch.float32 and idx.dtype == torch.int32
    assert torch.equal(idx[:, 0].long(), pick.long())
    tol = 1e-4 * ref_d.abs()
    assert ((dist - ref_d[:, :k]).abs() <= tol[:, :k])[:, 1:].all()
    gap = ref_d[:, 1:] - ref_d[:, :-1]
    prev = torch.cat([torch.full_like(gap[:, :1], float("inf")),
                      gap[:, :-1]], 1)
    clear = (gap > 2 * tol[:, 1:]) & (prev > 2 * tol[:, :k])
    assert clear.float().mean() > 0.3   # not vacuous
    assert torch.equal(idx[clear], ref_i[:, :k][clear])


def test_split_tf32_is_two_tf32_values_summing_to_x():
    """hi and lo carry 10 mantissa bits each (the low 13 are clear), hi is
    x rounded to nearest, and x - hi - lo is below 2^-21 of |x|."""
    x = torch.from_numpy(_corpus(1000, 8, seed=5).ravel() * 1e3)
    hi, lo = knn_kernel.split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()
    assert ((x - hi - lo).abs() <= 2.0 ** -21 * x.abs()).all()


@pytest.mark.parametrize("bq,n", [(1024, 82783), (7, 6000), (65, 3000),
                                  (200, 20000), (5, 40), (4096, 82783)])
def test_knn_slices_cover_the_corpus_and_fill_the_card(bq, n):
    """The corpus split: whole 128-row tiles, no empty slice, at most 256
    slices, the corpus covered exactly once; at the builder's shape
    (1024 queries, COCO-train) at least one block per SM of an H100 and
    within a wave's rounding of the ideal finish."""
    width, slices = knn_kernel._slices(bq, n, 132)
    assert width % 128 == 0 and 1 <= slices <= 256
    assert width * (slices - 1) < n <= width * slices
    qblocks = -(-bq // 128)
    if (bq, n) == (1024, 82783):
        assert qblocks * slices >= 132
        waves = -(-qblocks * slices // 132)
        ideal = qblocks * -(-n // 128) / 132
        assert waves * width / 128 <= ideal + width / 128


def test_knn_chunk_plain_takes_the_corpus_norms():
    corpus = _corpus(50, 8, seed=0)
    c = torch.from_numpy(corpus)
    a = knn_kernel.knn_chunk_plain(c[:5], c, 4)
    b = knn_kernel.knn_chunk_plain(c[:5], c, 4, corpus_sqnorm=(c * c).sum(1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("engine", ["cuda", "plain"])
@pytest.mark.parametrize("queries", [False, True])
def test_knn_driver_matches_jax(engine, queries):
    """``ops/topk.knn`` against the JAX driver: 230 queries in chunks of
    64 (the last window shifted back, its overlap dropped), self-kNN and
    separate queries; the engines are the same function on the CPU."""
    corpus = _corpus(230, 24, seed=3)
    q = _corpus(150, 24, seed=4) if queries else None
    d_ref, i_ref = jax_topk.knn(corpus, k=6, queries=q, batch_size=64)
    dist, idx = port_topk.knn(corpus, k=6, queries=q, batch_size=64,
                              engine=engine, device="cpu")
    assert isinstance(dist, np.ndarray) and idx.dtype == np.int32
    assert dist.shape == (150 if queries else 230, 6)
    np.testing.assert_array_equal(idx, i_ref)
    np.testing.assert_allclose(dist, d_ref, **TOL)


def test_knn_defaults_to_the_card(monkeypatch):
    """A numpy corpus with no ``device`` goes to the card; where none is
    visible the call raises and names ``device="cpu"`` instead of running
    on the CPU unasked.  A tensor corpus keeps its own device."""
    corpus = _corpus(20, 4, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_topk.knn(corpus, k=3)
    dist, idx = port_topk.knn(torch.from_numpy(corpus), k=3)
    d_ref, i_ref = port_topk.knn(corpus, k=3, device="cpu")
    np.testing.assert_array_equal(idx, i_ref)
    np.testing.assert_array_equal(dist, d_ref)


def test_knn_windows_match_jax_chunking():
    from vqa_counterexamples_tpu.ops import chunking

    for n, chunk in ((230, 64), (64, 64), (10, 64), (129, 32)):
        assert list(port_topk.windows(n, chunk)) == list(
            chunking.windows(n, chunk))


def test_knn_refuses_what_is_not_ported(monkeypatch):
    """``approx`` runs on the plain route (at 20 rows nothing is reduced:
    the exact result) and raises ``ValueError`` naming ``--engine plain``
    on the kernel's route and under a mesh, where JAX ignores it; a corpus
    sharded over a mesh runs (two gloo ranks: the one-rank result bit for
    bit), and refuses shards of fewer than k rows, as JAX's does."""
    from vqa_counterexamples_tpu_torch import parallel

    import torch_parallel_ranks

    corpus = _corpus(20, 4, seed=0)
    with pytest.raises(ValueError, match="--engine plain"):
        port_topk.knn(corpus, k=3, approx=True, device="cpu")
    exact = port_topk.knn(corpus, k=3, engine="plain", device="cpu")
    approx = port_topk.knn(corpus, k=3, engine="plain", approx=True,
                           device="cpu")
    for a, b in zip(approx, exact):
        assert a.tobytes() == b.tobytes()
    monkeypatch.setenv("VQACX_DIST_TIMEOUT", "120")
    ref = port_topk.knn(corpus, k=3, device="cpu")
    got = parallel.spawn(torch_parallel_ranks.knn_run,
                         (corpus, 3, 1024, {"data": 2}), world=2,
                         timeout=600)
    for a, b in zip(got, ref):
        assert a.tobytes() == b.tobytes()
    mesh = parallel.Mesh({"data": 8}, 0, 8, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="at least k rows"):
        port_topk.knn(corpus, k=3, mesh=mesh)
    with pytest.raises(ValueError, match="engine"):
        port_topk.knn(corpus, k=3, engine="xla")


# ------------------------------------------------------------- the store

def _names(n):
    return ["COCO_train2014_%012d.jpg" % (7 * i + 1) for i in range(n)]


def test_feature_store_round_trip_with_jax(tmp_path):
    """The port's ``save`` read by JAX's ``load`` and the other way round:
    the same matrix and names; ``noatt`` eager, att maps memory-mapped."""
    feats = _corpus(12, 6, seed=1)
    FeatureStore(feats, _names(12)).save(str(tmp_path / "port"))
    JaxStore(feats, _names(12)).save(str(tmp_path / "jax"))
    for prefix in ("port", "jax"):
        p = FeatureStore.load(str(tmp_path / prefix))
        j = JaxStore.load(str(tmp_path / prefix))
        assert type(p.features) is np.ndarray
        np.testing.assert_array_equal(p.features, j.features)
        np.testing.assert_array_equal(p.features, feats)
        assert p.names == j.names == _names(12)
    maps = np.random.default_rng(2).normal(size=(12, 2, 2, 3)).astype(
        np.float32)
    np.save(str(tmp_path / "port.att.npy"), maps)
    att = FeatureStore.load(str(tmp_path / "port"), dataset="att")
    assert isinstance(att.features, np.memmap) and att.row_shape == (2, 2, 3)
    np.testing.assert_array_equal(att.gather_rows(np.array([3, 0])),
                                  maps[[3, 0]])


def test_feature_store_refuses_hdf5_and_bf16(tmp_path):
    """The store reads HDF5 and bf16 now (tests/test_torch_store.py):
    what it refuses is a prefix with neither file, and an ``.npy`` of
    another element type; a uint16 ``.npy`` is read as bf16 rows, as
    JAX's ``load`` reads it."""
    (tmp_path / "f.txt").write_text("a\nb\n")
    with pytest.raises(FileNotFoundError, match="hdf5"):
        FeatureStore.load(str(tmp_path / "f"))
    np.save(str(tmp_path / "f.npy"), np.zeros((2, 3), np.int32))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FeatureStore.load(str(tmp_path / "f"))
    bits = np.arange(6, dtype=np.uint16).reshape(2, 3) + 16256  # 1.0, ...
    np.save(str(tmp_path / "f.npy"), bits)
    got, ref = (S.load(str(tmp_path / "f")) for S in (FeatureStore, JaxStore))
    assert got.dtype == ref.dtype and got.dtype.itemsize == 2
    np.testing.assert_array_equal(got.features.view(np.uint16), bits)
    np.testing.assert_array_equal(got.features.view(np.uint16),
                                  ref.features.view(np.uint16))


# ---------------------------------------------------------------- the CLI

def _store(tmp_path, n=70, dim=20):
    prefix = str(tmp_path / "trainset")
    FeatureStore(_corpus(n, dim, seed=n), _names(n)).save(prefix)
    return prefix


def test_knn_cli_matches_jax(tmp_path):
    """The port's CLI and the JAX CLI on one tiny store: the same
    ``knn_results.npy`` dict (indices equal, distances close) and the same
    VQA-format json (self dropped, k - 1 neighbour image ids)."""
    prefix = _store(tmp_path)
    args = ["--path_features", prefix, "-k", "6", "-b", "32"]
    jax_knn_cli.main(args + ["--out", str(tmp_path / "j.npy"),
                             "--json-out", str(tmp_path / "j.json")])
    dist, idx = port_knn_cli.main(args + [
        "--out", str(tmp_path / "p.npy"), "--json-out",
        str(tmp_path / "p.json"), "--device", "cpu"])
    got = np.load(tmp_path / "p.npy", allow_pickle=True).item()
    ref = np.load(tmp_path / "j.npy", allow_pickle=True).item()
    assert set(got) == set(ref) == {"indices", "distances"}
    np.testing.assert_array_equal(got["indices"], ref["indices"])
    np.testing.assert_array_equal(got["indices"], idx)
    np.testing.assert_allclose(got["distances"], ref["distances"], **TOL)
    table = json.loads((tmp_path / "p.json").read_text())
    assert table == json.loads((tmp_path / "j.json").read_text())
    assert len(table) == 70 and all(len(v) == 5 for v in table.values())
    assert "1" in table and 1 not in table["1"]


def test_knn_cli_bf16_store_matches_jax(tmp_path):
    """A bf16 feature file, as ``cli/extract.py --feat-dtype bfloat16``
    writes it (uint16 bits): the port casts it to f32 on the device, JAX's
    CLI with ``np.asarray(features, np.float32)``; the same json and
    indices."""
    import ml_dtypes

    prefix = str(tmp_path / "trainset")
    bf16 = _corpus(60, 20, seed=3).astype(ml_dtypes.bfloat16)
    np.save(prefix + ".npy", bf16.view(np.uint16))
    with open(prefix + ".txt", "w") as f:
        f.write("".join(name + "\n" for name in _names(60)))
    args = ["--path_features", prefix, "-k", "6", "-b", "32"]
    jax_knn_cli.main(args + ["--out", str(tmp_path / "j.npy"),
                             "--json-out", str(tmp_path / "j.json")])
    dist, idx = port_knn_cli.main(args + [
        "--out", str(tmp_path / "p.npy"), "--json-out",
        str(tmp_path / "p.json"), "--device", "cpu"])
    ref = np.load(tmp_path / "j.npy", allow_pickle=True).item()
    np.testing.assert_array_equal(idx, ref["indices"])
    np.testing.assert_allclose(dist, ref["distances"], **TOL)
    assert (tmp_path / "p.json").read_text() == (
        tmp_path / "j.json").read_text()


def test_knn_cli_default_out_and_engines(tmp_path):
    prefix = _store(tmp_path, n=40)
    runs = [port_knn_cli.main(["--path_features", prefix, "-k", "4",
                               "--engine", e, "--device", "cpu"])
            for e in ("cuda", "plain", "xla", "pallas")]
    for dist, idx in runs[1:]:
        np.testing.assert_array_equal(idx, runs[0][1])
    saved = np.load(prefix + "_knn_results.npy", allow_pickle=True).item()
    np.testing.assert_array_equal(saved["indices"], runs[-1][1])


def test_knn_cli_device_rule_and_unported_flags(tmp_path, monkeypatch):
    prefix = _store(tmp_path, n=30)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_knn_cli.main(["--path_features", prefix])
    # --approx: the plain route's files at 30 rows (nothing reduced), and
    # a ValueError naming --engine plain on the kernel's route
    with pytest.raises(ValueError, match="--engine plain"):
        port_knn_cli.main(["--path_features", prefix, "--device", "cpu",
                           "--approx"])
    files = []
    for extra in ([], ["--approx"]):
        out = str(tmp_path / ("approx.npy" if extra else "exact.npy"))
        port_knn_cli.main(["--path_features", prefix, "--device", "cpu",
                           "--engine", "plain", "--out", out] + extra)
        files.append(open(out, "rb").read())
    assert files[0] == files[1]
    # --mesh and --distributed run now: the .npy and the json byte for
    # byte the one-rank run's
    monkeypatch.setenv("VQACX_DIST_TIMEOUT", "120")
    outs = {}
    for name, extra in (("one", []), ("mesh", ["--mesh", "data=4"]),
                        ("distributed", ["--distributed"])):
        if name == "distributed":    # torchrun's environment, one rank
            import socket

            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                         "MASTER_ADDR": "127.0.0.1",
                         "MASTER_PORT": str(port)}.items():
                monkeypatch.setenv(k, v)
        out = tmp_path / name
        port_knn_cli.main(["--path_features", prefix, "-k", "5", "--device",
                           "cpu", "--out", str(out) + ".npy", "--json-out",
                           str(out) + ".json", *extra])
        outs[name] = [(tmp_path / (name + s)).read_bytes()
                      for s in (".npy", ".json")]
    assert outs["mesh"] == outs["one"] == outs["distributed"]


# ------------------------------------------------------------------ approx

def test_approx_reduction_size_matches_jaxlib():
    """``approx_reduction_size`` is XLA's
    ``ApproxTopKReductionOutputSize`` (rank 2, aggregate_to_topk False)
    on a grid of sizes, k and recall targets."""
    from jax._src.lib import _jax

    rng = np.random.default_rng(0)
    sizes = [1, 128, 129, 1000, 1025, 32768, 47975, 47976, 65536, 82783,
             *rng.integers(1, 3_000_000, 25).tolist(),
             *range(120, 2200, 37)]
    for n in sizes:
        for k in (1, 2, 5, 25, 100, 1000):
            for recall in (0.5, 0.9, 0.95, 0.99, 0.999):
                want = _jax.approx_top_k_reduction_output_size(
                    n, 2, k, recall, False)
                assert port_topk.approx_reduction_size(
                    n, k, recall) == tuple(want), (n, k, recall)
    assert port_topk.approx_reduction_size(82783, 25) == (41472, 1)
    assert port_topk.approx_reduction_size(65536, 25) == (32768, 1)
    assert port_topk.approx_reduction_size(32768, 25) == (32768, 0)


@pytest.fixture(scope="module")
def gaussian():
    """512 queries of a Gaussian corpus of 65,536 x 64 (the formula halves
    it to 32,768 bins at k 25), exact and approximate."""
    rng = np.random.default_rng(1)
    corpus = torch.from_numpy(rng.normal(size=(65536, 64)).astype(
        np.float32))
    queries = corpus[:512]
    exact = knn_kernel.knn_chunk_plain(queries, corpus, 25)
    approx = port_topk.approx_chunk(queries, corpus, 25)
    return corpus, queries, exact, approx


def test_approx_recall_against_exact(gaussian):
    _, _, (_, exact), (dist, idx) = gaussian
    hits = [len(set(a) & set(b)) for a, b in zip(idx.numpy(),
                                                  exact.numpy())]
    assert np.mean(hits) / 25 >= 0.99
    assert bool((dist[:, 1:] >= dist[:, :-1]).all())
    assert bool((idx[:, 0] == torch.arange(512)).all())   # self first


def test_approx_distances_are_the_plain_routes(gaussian):
    """The distances of the winners are the plain route's f32 distances of
    those indices, bit for bit (the f32 rescoring)."""
    corpus, queries, _, (dist, idx) = gaussian
    neg = knn_kernel.neg_sqdist_plain(queries, corpus)
    want = torch.sqrt(torch.clamp(-torch.gather(neg, 1, idx.long()),
                                  min=0.0))
    assert dist.numpy().tobytes() == want.numpy().tobytes()


def test_approx_bins_fold_columns_modulo_the_bin_count():
    """The bin layout: at N 300, k 2 and recall 0.5 (256 bins of two, by
    the formula) the winners are the best of columns b and b + 256; a
    planted pair sharing a bin loses its second, which the exact route
    keeps."""
    assert port_topk.approx_reduction_size(300, 2, 0.5) == (256, 1)
    corpus = torch.full((300, 2), 50.0)
    for row, d in ((5, 0.1), (5 + 256, 0.2), (100, 0.3)):
        corpus[row] = torch.tensor([d, 0.0])
    query = torch.zeros(1, 2)
    _, exact = knn_kernel.knn_chunk_plain(query, corpus, 2)
    _, approx = port_topk.approx_chunk(query, corpus, 2, recall_target=0.5)
    assert exact.tolist() == [[5, 261]]
    assert approx.tolist() == [[5, 100]]
