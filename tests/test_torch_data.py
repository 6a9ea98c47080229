"""The PyTorch port's numpy data copies and config loader against the JAX
package, and the port's import hygiene (it must never load jax).

The port cannot import the JAX package's numpy-only data modules (their
package ``__init__`` imports jax), so it carries copies; these tests hold
the copies to the originals bit for bit.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from vqa_counterexamples_tpu.core import config as jax_config
from vqa_counterexamples_tpu.data import synthetic as jax_synthetic
from vqa_counterexamples_tpu.data import vqacx as jax_vqacx
from vqa_counterexamples_tpu_torch.core import config as port_config
from vqa_counterexamples_tpu_torch.data import synthetic as port_synthetic
from vqa_counterexamples_tpu_torch.data import vqacx as port_vqacx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kw", [
    dict(n_examples=40, n_images=30, dim_v=16, knn_size=6, seed=3),
    dict(n_examples=25, n_images=40, dim_v=8, knn_size=5, seed=7,
         learnable=False, true_knn=False, split="val"),
])
def test_synthetic_matches_jax(kw):
    d_jax, s_jax = jax_synthetic.make_synthetic_cx(**kw)
    d_port, s_port = port_synthetic.make_synthetic_cx(**kw)
    np.testing.assert_array_equal(s_port.features, s_jax.features)
    assert s_port.names == s_jax.names
    assert d_port == d_jax


def test_cx_arrays_and_batches_match_jax():
    dataset, store = port_synthetic.make_synthetic_cx(
        n_examples=37, n_images=30, dim_v=8, knn_size=6, seed=1)
    a_port = port_vqacx.CXArrays.from_examples(dataset["examples_list"],
                                               store.name_to_index)
    a_jax = jax_vqacx.CXArrays.from_examples(dataset["examples_list"],
                                             store.name_to_index)
    for f in a_jax._fields:
        np.testing.assert_array_equal(getattr(a_port, f), getattr(a_jax, f))
        assert getattr(a_port, f).dtype == getattr(a_jax, f).dtype
    b_port = list(port_vqacx.batch_indices(37, 8, shuffle=True,
                                           rng=np.random.default_rng(2)))
    b_jax = list(jax_vqacx.batch_indices(37, 8, shuffle=True,
                                         rng=np.random.default_rng(2)))
    assert len(b_port) == len(b_jax) == 5
    for (ip, np_), (ij, nj) in zip(b_port, b_jax):
        np.testing.assert_array_equal(ip, ij)
        assert np_ == nj
        gp = port_vqacx.gather_batch(a_port, ip)
        gj = jax_vqacx.gather_batch(a_jax, ij)
        assert gp.keys() == gj.keys()
        for k in gj:
            np.testing.assert_array_equal(gp[k], gj[k])


@pytest.mark.parametrize("num", [0, 9, 581929])
def test_coco_names_match_jax(num):
    for split in ("train", "val"):
        name = port_vqacx.coco_num_to_name(num, split)
        assert name == jax_vqacx.coco_num_to_name(num, split)
        assert port_vqacx.coco_name_to_num(name) == \
            jax_vqacx.coco_name_to_num(name) == num


def test_feature_store_to_device():
    import torch

    _, store = port_synthetic.make_synthetic_cx(n_examples=4, n_images=10,
                                                dim_v=4, knn_size=3)
    t = store.to_device("cpu")
    assert t.dtype == torch.float32 and tuple(t.shape) == (10, 4)
    np.testing.assert_array_equal(t.numpy(), store.features)


_CONFIGS = sorted(os.path.relpath(p, REPO) for p in
                  glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                            recursive=True))


@pytest.mark.parametrize("path", _CONFIGS)
def test_config_loader_matches_jax(path):
    full = os.path.join(REPO, path)
    assert port_config.load_options_file(full) == \
        jax_config.load_options_file(full)


def test_resolve_and_save_options(tmp_path):
    path = os.path.join(REPO, "configs", "cx", "counterexamples_default.yaml")
    over = {"optim": {"batch_size": 7, "lr": None}}
    got = port_config.resolve_options({}, path, over)
    assert got == jax_config.resolve_options({}, path, over)
    saved = port_config.save_options(got, str(tmp_path))
    assert jax_config.load_yaml(saved) == got


def test_port_import_leaves_jax_out():
    code = ("import sys\n"
            "import vqa_counterexamples_tpu_torch.cli.counterexamples as c\n"
            "import vqa_counterexamples_tpu_torch.engines.cx_engine\n"
            "import vqa_counterexamples_tpu_torch.models.factory\n"
            "import vqa_counterexamples_tpu_torch.models.from_jax\n"
            "import vqa_counterexamples_tpu_torch.core.config\n"
            "import vqa_counterexamples_tpu_torch.core.rng\n"
            "import vqa_counterexamples_tpu_torch.core.checkpoint\n"
            "import vqa_counterexamples_tpu_torch.data.synthetic\n"
            "import vqa_counterexamples_tpu_torch.cli.train as t\n"
            "import vqa_counterexamples_tpu_torch.cli.profile_vqa\n"
            "import vqa_counterexamples_tpu_torch.cli.probe_kernels\n"
            "import vqa_counterexamples_tpu_torch.engines.vqa_engine\n"
            "import vqa_counterexamples_tpu_torch.data.vqa_dataset\n"
            "import vqa_counterexamples_tpu_torch.core.experiment\n"
            "import vqa_counterexamples_tpu_torch.core.meters\n"
            "import vqa_counterexamples_tpu_torch.models.common\n"
            "import vqa_counterexamples_tpu_torch.ops.fusion\n"
            "import vqa_counterexamples_tpu_torch.ops.cuda.mutan_kernel\n"
            "import vqa_counterexamples_tpu_torch.ops.cuda.attmutan_kernel\n"
            "import vqa_counterexamples_tpu_torch.ops.cuda.knn_kernel\n"
            "import vqa_counterexamples_tpu_torch.models.att\n"
            "import vqa_counterexamples_tpu_torch.ops.topk\n"
            "import vqa_counterexamples_tpu_torch.data.features\n"
            "import vqa_counterexamples_tpu_torch.cli.knn as k\n"
            "import vqa_counterexamples_tpu_torch.cli.extract as e\n"
            "import vqa_counterexamples_tpu_torch.serve.demo_server as d\n"
            "import vqa_counterexamples_tpu_torch.models.convnets\n"
            "import vqa_counterexamples_tpu_torch.data.native_decoder\n"
            "import vqa_counterexamples_tpu_torch.data.image_fixtures\n"
            "import vqa_counterexamples_tpu_torch.core.graphs\n"
            "import vqa_counterexamples_tpu_torch.core.msgpack_tree as mt\n"
            "import vqa_counterexamples_tpu_torch.models.to_jax\n"
            "import vqa_counterexamples_tpu_torch.models.from_reference\n"
            "import vqa_counterexamples_tpu_torch.cli.port_checkpoint\n"
            "import vqa_counterexamples_tpu_torch.cli.visu\n"
            "import vqa_counterexamples_tpu_torch.viz.curves\n"
            "import vqa_counterexamples_tpu_torch.viz.grids\n"
            "import vqa_counterexamples_tpu_torch.utils\n"
            "import vqa_counterexamples_tpu_torch.scripts.run_ablations as r\n"
            "import vqa_counterexamples_tpu_torch.scripts.replicate_reference"
            " as rr\n"
            "mt.unpack(mt.pack({'a': [1, 2.5, None, 'x']}))\n"
            "r.build_parser()\n"
            "rr.build_parser()\n"
            "rr.knobs('proj', rehearsal=True)\n"
            "c.build_parser()\n"
            "t.build_parser()\n"
            "k.build_parser()\n"
            "e.build_parser()\n"
            "d.build_parser()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'msgpack', "
            "'vqa_counterexamples_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
