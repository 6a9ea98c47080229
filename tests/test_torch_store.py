"""The port's feature store against the JAX package's: the native C++ store
(``vqa_counterexamples_tpu_torch/native/feature_store.cpp``, built by
``data/native_store.py`` with g++ into ``_build/``) against numpy and
JAX's ``NativeFeatureStore``; ``FeatureStore.load`` of bf16 ``.npy`` and
HDF5 files against JAX's; ``VQAArrays.batches`` through the native path
against JAX's; the tickets of a generator closed early; the numpy path
where the build is refused; the extract CLI's bf16 files read back.

Tolerance: none.  The stores copy bytes, so every comparison is bit for
bit (bf16 rows compared as their uint16 bits).
"""

import gc
import os
import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

from vqa_counterexamples_tpu.data import native_store as jax_native
from vqa_counterexamples_tpu.data.features import FeatureStore as JaxStore
from vqa_counterexamples_tpu.data.vqa_dataset import VQAArrays as JaxArrays
from vqa_counterexamples_tpu.models import convnets as jax_convnets
from vqa_counterexamples_tpu_torch.cli import extract as port_extract
from vqa_counterexamples_tpu_torch.cli import train as port_cli
from vqa_counterexamples_tpu_torch.data import features as port_features
from vqa_counterexamples_tpu_torch.data import native_store as nst
from vqa_counterexamples_tpu_torch.data.features import FeatureStore
from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays
from vqa_counterexamples_tpu_torch.models import convnets

BF16 = np.dtype(ml_dtypes.bfloat16)


@pytest.fixture(scope="module")
def lib():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no g++ to build the native store")
    lib = nst.load_library()
    assert lib is not None, "g++ is here: the native store must build"
    return lib


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _matrix(rows, shape, dtype, seed=0):
    a = np.random.default_rng(seed).normal(size=(rows,) + shape).astype(
        np.float32)
    return a.astype(BF16) if dtype == "bfloat16" else a


def _names(n):
    return ["COCO_train2014_%012d.jpg" % (3 * i + 1) for i in range(n)]


def _save_npy(path, matrix):
    """A store file as the extract CLI writes it (bf16 as uint16 bits)."""
    np.save(path, _bits(matrix))
    return path


def test_build_is_keyed_and_loaded(lib):
    path = nst.library_path()
    assert path.exists() and path.parent == nst.BUILD_DIR
    assert path.name.startswith("libfeature_store_")
    assert nst.build() == path          # a second build is the same file
    assert lib.fs_abi_version() == 2


@pytest.mark.parametrize("row_shape", [(3, 4), (64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_and_prefetch_match_numpy_and_jax(tmp_path, lib, dtype,
                                                 row_shape):
    """``gather`` and ``prefetch`` / ``wait`` with repeated rows, bit for
    bit against numpy's take and JAX's store on the same file; small rows
    (one job a gather) and rows of 16 / 32 KB (split over the pool's
    threads, at least 1 MB a job); the ticket count goes back to 0."""
    matrix = _matrix(300, row_shape, dtype, seed=1)
    cols = int(np.prod(row_shape))
    path = _save_npy(str(tmp_path / "m.att.npy"), matrix)
    store = nst.NativeFeatureStore.open_npy(path, n_threads=3)
    assert (store.rows, store.cols, store.row_shape) == (300, cols,
                                                         row_shape)
    assert store.dtype == matrix.dtype
    jax_store = jax_native.NativeFeatureStore.open_npy(path)
    flat = matrix.reshape(300, -1)
    rng = np.random.default_rng(2)
    for n in (1, 7, 257):
        idx = rng.integers(0, 300, n)
        got = store.gather(idx)
        np.testing.assert_array_equal(_bits(got), _bits(flat[idx]))
        np.testing.assert_array_equal(_bits(got),
                                      _bits(jax_store.gather(idx)))
    idx = np.array([5, 5, 299, 0, 17, 5] * 30)
    outs = [np.empty((len(idx), cols), matrix.dtype) for _ in range(2)]
    tickets = [store.prefetch(idx, outs[0]), store.prefetch(idx[::-1].copy(),
                                                            outs[1])]
    assert store.outstanding == 2
    for t in tickets:
        store.wait(t)
    assert store.outstanding == 0
    np.testing.assert_array_equal(_bits(outs[0]), _bits(flat[idx]))
    np.testing.assert_array_equal(_bits(outs[1]), _bits(flat[idx[::-1]]))
    jax_store.close()
    store.close()


def test_native_store_refuses_bad_buffers_and_rows(tmp_path, lib):
    path = _save_npy(str(tmp_path / "m.npy"), _matrix(10, (4,), "float32"))
    store = nst.NativeFeatureStore.open_npy(path)
    with pytest.raises(ValueError, match="C-contiguous"):
        store.gather([1, 2], np.empty((2, 4), np.float64))
    with pytest.raises(ValueError, match="C-contiguous"):
        store.prefetch([1, 2], np.empty((3, 4), np.float32))
    with pytest.raises(IndexError):
        store.gather([10])
    with pytest.raises(OSError, match="fs_open"):
        nst.NativeFeatureStore.open_raw(path, 100, 4)   # the file is short
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        nst.npy_header_bytes(_save_npy(str(tmp_path / "i.npy"),
                                       np.zeros((2, 2), np.int32)))
    store.close()
    # the FeatureStore hooks refuse a strided buffer (a reshape would copy
    # it, and the rows would land in the copy)
    with open(str(tmp_path / "m.txt"), "w") as f:
        f.write("\n".join(_names(10)) + "\n")
    fs = FeatureStore.load(str(tmp_path / "m"))
    strided = np.empty((2, 8), np.float32)[:, ::2]
    for call in (fs.gather_rows, fs.prefetch_rows):
        with pytest.raises(ValueError, match="C-contiguous"):
            call(np.array([1, 2]), strided)
    assert fs.outstanding == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dataset", ["noatt", "att"])
def test_load_npy_matches_jax(tmp_path, lib, dtype, dataset):
    """``FeatureStore.load`` of f32 and bf16 stores, noatt (read in) and
    att maps (kept on disk), against JAX's load: the same dtype, rows and
    names; ``gather_rows`` through the native store; ``to_device`` gives
    bf16 tensors for bf16 rows; ``save`` writes the bit-view back."""
    shape = (6,) if dataset == "noatt" else (2, 2, 3)
    matrix = _matrix(9, shape, dtype, seed=3)
    prefix = str(tmp_path / "trainset")
    suffix = ".npy" if dataset == "noatt" else ".att.npy"
    _save_npy(prefix + suffix, matrix)
    with open(prefix + ".txt", "w") as f:
        f.write("\n".join(_names(9)) + "\n")
    got = FeatureStore.load(prefix, dataset=dataset)
    ref = JaxStore.load(prefix, dataset=dataset)
    assert got.dtype == ref.dtype == matrix.dtype
    assert isinstance(got.features, np.memmap) == (dataset == "att")
    assert got.names == ref.names == _names(9)
    assert got.row_shape == shape and got.gather_path == "native"
    rows = np.array([8, 0, 8, 3])
    np.testing.assert_array_equal(_bits(got.gather_rows(rows)),
                                  _bits(ref.gather_rows(rows)))
    np.testing.assert_array_equal(_bits(got.gather_rows(rows)),
                                  _bits(matrix[rows]))
    dev = got.to_device("cpu")
    assert dev.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    np.testing.assert_array_equal(dev.float().numpy(),
                                  matrix.astype(np.float32))
    if dataset == "noatt":
        got.save(str(tmp_path / "again"))
        np.testing.assert_array_equal(np.load(str(tmp_path / "again.npy")),
                                      _bits(matrix))


@pytest.mark.parametrize("lazy", [None, False])
def test_load_hdf5_matches_jax(tmp_path, lazy):
    """The reference's ``.hdf5`` (no ``.npy`` beside it): lazy (an open
    dataset, duplicate rows allowed) and read in, against JAX's; numpy
    serves the gather."""
    import h5py

    att = _matrix(7, (2, 2, 3), "float32", seed=4)
    noatt = att.mean(axis=(1, 2))
    prefix = str(tmp_path / "valset")
    with h5py.File(prefix + ".hdf5", "w") as f:
        f.create_dataset("att", data=att)
        f.create_dataset("noatt", data=noatt)
    with open(prefix + ".txt", "w") as f:
        f.write("\n".join(_names(7)) + "\n")
    for dataset, matrix in (("att", att), ("noatt", noatt)):
        got = FeatureStore.load(prefix, dataset=dataset, lazy=lazy)
        ref = JaxStore.load(prefix, dataset=dataset, lazy=lazy)
        assert got.gather_path == "numpy"
        rows = np.array([6, 1, 1, 0])
        np.testing.assert_array_equal(got.gather_rows(rows),
                                      ref.gather_rows(rows))
        np.testing.assert_array_equal(got.gather_rows(rows), matrix[rows])
        out = np.empty((4,) + matrix.shape[1:], np.float32)
        assert got.gather_rows(rows, out=out) is out
        np.testing.assert_array_equal(out, matrix[rows])
        np.testing.assert_array_equal(got.to_device("cpu").numpy(), matrix)


def test_load_without_h5py_or_files(tmp_path, monkeypatch):
    """No ``.npy`` and no ``.hdf5``: ``FileNotFoundError``; an ``.hdf5``
    where h5py does not import: ``ImportError`` naming h5py and the
    ``.npy`` route."""
    import builtins

    prefix = str(tmp_path / "f")
    (tmp_path / "f.txt").write_text("a\nb\n")
    with pytest.raises(FileNotFoundError, match="f.hdf5"):
        FeatureStore.load(prefix)
    (tmp_path / "f.hdf5").write_bytes(b"")
    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("no h5py")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    for lazy in (None, False, True):
        with pytest.raises(ImportError, match="h5py.*npy"):
            FeatureStore.load(prefix, lazy=lazy)


def _att_world(tmp_path, dtype, n=45, side=3):
    """Synthetic examples with several human answers to sample, and their
    maps as an ``.att.npy`` store loaded by both packages."""
    opt = {"vqa": {"nans": 20, "maxlength": 10}, "coco": {"mode": "att"},
           "model": {"arch": "MutanAtt", "dim_v": 5}}
    examples, store, _, _ = port_cli._synthetic_vqa(n, opt, 2)
    rng = np.random.default_rng(4)
    for ex in examples:
        ex["answers_aid"] = sorted({ex["answer_aid"],
                                    int(rng.integers(0, 20))})
        ex["answers_count"] = [int(c) for c in
                               rng.integers(1, 10, len(ex["answers_aid"]))]
    maps = np.ascontiguousarray(store.features[:, :side, :side])
    if dtype == "bfloat16":
        maps = maps.astype(BF16)
    prefix = str(tmp_path / "trainset")
    _save_npy(prefix + ".att.npy", maps)
    with open(prefix + ".txt", "w") as f:
        f.write("\n".join(store.names) + "\n")
    return examples, prefix, maps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("drop_remainder", [False, True])
def test_batches_native_path_match_jax(tmp_path, lib, dtype, drop_remainder):
    """``VQAArrays.batches`` over an ``.att.npy`` store (the native
    prefetch path on both sides) for one numpy ``rng``: every batch bit
    for bit against JAX's (its views copied as they come, since JAX reuses
    two buffers), and no ticket left outstanding."""
    examples, prefix, maps = _att_world(tmp_path, dtype)
    store = FeatureStore.load(prefix, dataset="att")
    a_port = VQAArrays(examples, store, samplingans=True)
    a_jax = JaxArrays(examples, JaxStore.load(prefix, dataset="att"),
                      samplingans=True)
    assert a_port.gather_path == "native"
    got = list(a_port.batches(8, shuffle=True, rng=np.random.default_rng(1),
                              drop_remainder=drop_remainder))
    ref = [{k: np.array(v) for k, v in b.items()} for b in a_jax.batches(
        8, shuffle=True, rng=np.random.default_rng(1),
        drop_remainder=drop_remainder)]
    assert len(got) == len(ref) == (5 if drop_remainder else 6)
    for gp, gj in zip(got, ref):
        assert gp.keys() == gj.keys()
        for k in ("question", "answer", "question_id"):
            np.testing.assert_array_equal(gp[k], gj[k])
            assert gp[k].dtype == gj[k].dtype
        assert gp["visual"].dtype == maps.dtype
        np.testing.assert_array_equal(_bits(gp["visual"]),
                                      _bits(gj["visual"]))
    assert got[0]["visual"].shape == (8, 3, 3, 5)
    assert store.outstanding == 0


def test_closed_generator_leaves_no_ticket(tmp_path, lib):
    """A generator dropped after one batch (the next batch's prefetch in
    flight) is closed by the garbage collector: its ticket is waited for
    before its buffer can go."""
    examples, prefix, maps = _att_world(tmp_path, "float32", n=64)
    store = FeatureStore.load(prefix, dataset="att")
    arrays = VQAArrays(examples, store)
    gen = arrays.batches(8, shuffle=False)
    first = next(gen)
    assert store.outstanding == 1
    np.testing.assert_array_equal(first["visual"],
                                  maps[arrays.image_rows[:8]])
    del gen
    gc.collect()
    assert store.outstanding == 0
    gen = arrays.batches(8, shuffle=False)
    next(gen)
    gen.close()
    assert store.outstanding == 0


def test_numpy_path_when_the_build_is_refused(tmp_path, monkeypatch,
                                              capsys):
    """g++ refused: ``load_library`` says so once and returns None, the
    store gathers with numpy (``gather_path``), and the batches are the
    same as JAX's thread path over an in-memory copy."""
    monkeypatch.setattr(nst, "_LIB", None)
    monkeypatch.setattr(nst, "_LIB_FAILED", False)
    monkeypatch.setattr(nst, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    examples, prefix, maps = _att_world(tmp_path, "float32")
    store = FeatureStore.load(prefix, dataset="att")
    assert store.gather_path == "numpy"
    out = capsys.readouterr().out
    assert out.count("native feature store unavailable") == 1
    assert "numpy" in out
    assert nst.load_library() is None and store.gather_path == "numpy"
    assert "unavailable" not in capsys.readouterr().out   # said once
    with pytest.raises(OSError, match="unavailable"):
        nst.NativeFeatureStore.open_npy(prefix + ".att.npy")
    arrays = VQAArrays(examples, store)
    assert arrays.gather_path == "numpy"
    got = list(arrays.batches(8, shuffle=True, rng=np.random.default_rng(3)))
    ref = list(JaxArrays(examples, JaxStore(maps, store.names)).batches(
        8, shuffle=True, rng=np.random.default_rng(3)))
    for gp, gj in zip(got, ref):
        np.testing.assert_array_equal(gp["visual"], gj["visual"])
    assert store.prefetch_rows(np.arange(2), np.empty((2, 45))) is None


def test_extract_bf16_round_trip(tmp_path, monkeypatch):
    """``cli/extract.py --feat-dtype bfloat16`` then ``FeatureStore.load``
    of both of its stores: bf16 rows whose bits are the files', gathered
    natively, with the names the CLI wrote."""
    tiny = (1, 1, 1, 1)
    monkeypatch.setitem(jax_convnets.RESNET_DEPTHS, 50, tiny)
    monkeypatch.setitem(convnets.RESNET_DEPTHS, 50, tiny)
    prefix = port_extract.main([
        "--synthetic", "5", "-b", "2", "--arch", "resnet50", "--size", "64",
        "--feat-dtype", "bfloat16", "--dir_data", str(tmp_path),
        "--device", "cpu"])
    for dataset, suffix in (("noatt", ".npy"), ("att", ".att.npy")):
        bits = np.load(prefix + suffix)
        assert bits.dtype == np.uint16
        store = FeatureStore.load(prefix, dataset=dataset)
        assert store.dtype == BF16 and len(store) == 5
        rows = np.array([4, 0, 2])
        np.testing.assert_array_equal(_bits(store.gather_rows(rows)),
                                      bits[rows])
        assert store.names == ["synthetic_%06d.jpg" % i for i in range(5)]
        assert store.to_device("cpu").dtype == torch.bfloat16
    assert port_features.to_tensor(np.zeros(3, BF16)).dtype == torch.bfloat16
