"""The port's extraction CLI (``vqa_counterexamples_tpu_torch/cli/
extract.py``) against the JAX package's, at ``--size 64`` with the
ResNet-50 name cut to depth (1, 1, 1, 1) on both sides (the factories read
``RESNET_DEPTHS`` at call time), weights drawn by both ``init_resnet``s
from one seed or loaded by both from one reference-named state dict.

Compared: ``.txt`` equal; ``.npy``, ``.att.npy`` and the ``.hdf5``'s
``noatt`` / ``att`` within the trunk's bound, as a share of the largest
entry: 1e-4 with both trunks at f32 (their factories patched), 5e-2 at
the CLIs' bf16 (``tests/test_torch_convnets.py``'s bounds); the bfloat16
bit-views of a run as the bf16 rounding of the same run's f32 files,
exactly; ``.npy`` as the spatial mean of ``.att.npy`` to f32 rounding."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_counterexamples_tpu.cli import extract as jax_extract
from vqa_counterexamples_tpu.models import convnets as jax_convnets
from vqa_counterexamples_tpu_torch.cli import extract as port_extract
from vqa_counterexamples_tpu_torch.models import convnets

TINY = (1, 1, 1, 1)
REL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.fixture
def tiny_trunks(monkeypatch):
    monkeypatch.setitem(jax_convnets.RESNET_DEPTHS, 50, TINY)
    monkeypatch.setitem(convnets.RESNET_DEPTHS, 50, TINY)


def _f32_trunks(monkeypatch):
    monkeypatch.setattr(jax_convnets, "factory", lambda opt: jax_convnets.
                        ResNet(depths=TINY, dtype=jnp.float32))
    monkeypatch.setattr(convnets, "factory", lambda opt: convnets.ResNet(
        depths=TINY, dtype=torch.float32))


def _rel_err(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _bf16_bits_to_f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _load(prefix):
    out = {"npy": np.load(prefix + ".npy")}
    if os.path.exists(prefix + ".att.npy"):
        out["att"] = np.load(prefix + ".att.npy")
    with open(prefix + ".txt") as f:
        out["txt"] = f.read()
    if os.path.exists(prefix + ".hdf5"):
        import h5py

        with h5py.File(prefix + ".hdf5", "r") as h5:
            out["h5"] = {k: h5[k][:] for k in h5}
    return out


def _run_both(tmp_path, argv):
    jax_prefix = jax_extract.main(argv + ["--dir_data",
                                          str(tmp_path / "jax"),
                                          "--workers", "1"])
    port_stats = {}
    port_prefix = port_extract.main(
        argv + ["--dir_data", str(tmp_path / "port"), "--device", "cpu"],
        stats=port_stats)
    assert os.path.relpath(jax_prefix, tmp_path / "jax") == \
        os.path.relpath(port_prefix, tmp_path / "port")
    return _load(jax_prefix), _load(port_prefix), port_stats, port_prefix


def _compare(ref, got, rel):
    assert got["txt"] == ref["txt"]
    assert got["npy"].shape == ref["npy"].shape
    assert _rel_err(got["npy"], ref["npy"]) < rel
    if "att" in ref:
        assert got["att"].shape == ref["att"].shape
        assert _rel_err(got["att"], ref["att"]) < rel
        np.testing.assert_allclose(got["att"].mean(axis=(1, 2)), got["npy"],
                                   rtol=1e-5, atol=1e-6)
    assert set(got["h5"]) == set(ref["h5"])
    for key in ref["h5"]:
        assert _rel_err(got["h5"][key], ref["h5"][key]) < rel
    np.testing.assert_array_equal(got["h5"]["noatt"], got["npy"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_with_short_tail(tmp_path, monkeypatch, tiny_trunks,
                                   dtype):
    """``--synthetic 12 -b 5``: batches of 5, 5 and a tail of 2; the same
    normal draws from ``default_rng(0)`` as JAX's, by name order."""
    if dtype == "float32":
        _f32_trunks(monkeypatch)
    argv = ["--synthetic", "12", "-b", "5", "--arch", "resnet50", "--size",
            "64", "--att_store", "both"]
    ref, got, stats, _ = _run_both(tmp_path, argv)
    assert got["att"].shape == (12, 2, 2, 2048)
    assert got["txt"].splitlines() == ["synthetic_%06d.jpg" % i
                                       for i in range(12)]
    _compare(ref, got, REL[dtype])
    np.testing.assert_array_equal(got["h5"]["att"], got["att"])
    assert set(stats) == {"init_s", "first_batch_s", "steady_img_per_sec",
                          "finalize_s"}


def test_bfloat16_bit_views(tmp_path, monkeypatch, tiny_trunks):
    """``--feat-dtype bfloat16``: uint16 files holding the bf16 rounding of
    the f32 run's values (bit for bit), and JAX's within the bound."""
    _f32_trunks(monkeypatch)
    base = ["--synthetic", "7", "-b", "4", "--arch", "resnet50", "--size",
            "64"]
    ref, got, _, _ = _run_both(tmp_path / "bf", base + ["--feat-dtype",
                                                         "bfloat16"])
    f32 = _load(port_extract.main(base + [
        "--dir_data", str(tmp_path / "f32"), "--device", "cpu"]))
    for key in ("npy", "att"):
        assert got[key].dtype == ref[key].dtype == np.uint16
        want = torch.from_numpy(f32[key]).to(torch.bfloat16).view(
            torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got[key], want)
        assert _rel_err(_bf16_bits_to_f32(got[key]),
                        _bf16_bits_to_f32(ref[key])) < 2 ** -7
    # the .hdf5 stays f4, as JAX's
    assert got["h5"]["noatt"].dtype == np.float32


def _write_images(img_dir, n_jpeg=3, png=True, seed=7):
    from PIL import Image

    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_jpeg):
        arr = rng.integers(0, 255, size=(90 + 10 * i, 80, 3)).astype(
            np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, "img_%d.jpg" % i))
    if png:
        arr = rng.integers(0, 255, size=(90, 80, 3)).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, "img_%d.png"
                                               % n_jpeg))
    with open(os.path.join(img_dir, "notes.txt"), "w") as f:
        f.write("not an image\n")


def _state_dict_file(tmp_path):
    gen = torch.Generator().manual_seed(11)
    sd = {}
    for name, t in convnets.ResNet(depths=TINY).state_dict().items():
        if name.endswith("running_var"):
            sd[name] = torch.rand(t.shape, generator=gen) + 0.5
        elif t.dim() == 4:
            sd[name] = torch.randn(t.shape, generator=gen) / t[0].numel() \
                ** 0.5
        else:
            sd[name] = 0.1 * torch.randn(t.shape, generator=gen)
    sd["fc.weight"] = torch.zeros(10, 2048)
    path = str(tmp_path / "weights.pth")
    torch.save(sd, path)
    return path


@pytest.mark.parametrize("dataset", ["coco", "vgenome"])
def test_raw_images_with_a_png(tmp_path, monkeypatch, tiny_trunks, dataset):
    """A raw directory of JPEGs plus a PNG (coco's val2014, or vgenome's
    flat images dir): the native decoder takes the JPEGs, PIL the PNG,
    weights from one reference-named state dict on both sides."""
    _f32_trunks(monkeypatch)
    sub = "val2014" if dataset == "coco" else "images"
    for side in ("jax", "port"):
        _write_images(str(tmp_path / side / "raw" / sub))
    argv = ["--dataset", dataset, "--data_split",
            "val" if dataset == "coco" else "train", "--arch", "resnet50",
            "--size", "64", "-b", "3", "--weights",
            _state_dict_file(tmp_path)]
    ref, got, _, prefix = _run_both(tmp_path, argv)
    assert got["txt"].splitlines() == ["img_0.jpg", "img_1.jpg",
                                       "img_2.jpg", "img_3.png"]
    _compare(ref, got, REL["float32"])
    assert np.abs(got["npy"][3]).sum() > 0    # the PNG row is not zeros
    assert prefix.endswith(os.path.join("extract", "arch,resnet50_size,64",
                                        "%sset" % ("val" if dataset == "coco"
                                                   else "train")))


def test_noatt_mode_and_vgenome_split_rule(tmp_path, tiny_trunks):
    _write_images(str(tmp_path / "raw" / "images"), n_jpeg=2, png=False)
    prefix = port_extract.main(["--dataset", "vgenome", "--arch",
                                "resnet50", "--size", "64", "--mode",
                                "noatt", "--dir_data", str(tmp_path),
                                "--device", "cpu"])
    out = _load(prefix)
    assert "att" not in out and out["npy"].shape == (2, 2048)
    assert set(out["h5"]) == {"noatt"}
    with pytest.raises(ValueError, match="train split"):
        port_extract.main(["--dataset", "vgenome", "--data_split", "val",
                           "--dir_data", str(tmp_path), "--device", "cpu"])


def test_without_h5py(tmp_path, monkeypatch, tiny_trunks, capsys):
    """Where h5py does not import, ``--att_store npy`` writes the .npy and
    .txt files, no .hdf5, and says why; ``hdf5`` / ``both`` raise."""
    import builtins

    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("no h5py")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    argv = ["--synthetic", "3", "-b", "2", "--arch", "resnet50", "--size",
            "64", "--dir_data", str(tmp_path), "--device", "cpu"]
    prefix = port_extract.main(argv)
    assert not os.path.exists(prefix + ".hdf5")
    assert "No %s.hdf5 written: h5py does not import" % prefix in \
        capsys.readouterr().out
    assert np.load(prefix + ".att.npy").shape == (3, 2, 2, 2048)
    for store in ("hdf5", "both"):
        with pytest.raises(ImportError, match="h5py"):
            port_extract.main(argv + ["--att_store", store])


def test_refusals(tmp_path, monkeypatch):
    base = ["--synthetic", "2", "--dir_data", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="Queue 1 #12"):
        port_extract.main(base + ["--mesh", "data=8", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Queue 1 #12"):
        port_extract.main(base + ["--distributed", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_extract.main(base)
    assert port_extract.build_parser().parse_args([]).device == "cuda"
    # every flag of the JAX CLI is taken
    jax_flags = {a.dest for a in jax_extract.build_parser()._actions}
    port_flags = {a.dest for a in port_extract.build_parser()._actions}
    assert jax_flags <= port_flags
