"""``viz/`` and ``cli/visu.py`` of the PyTorch port against the JAX
package's, and the CX CLI's ``--viz``.

``load_curves`` gives JAX's dict on the same logs; ``render_html`` and the
``visu`` CLI write JAX's HTML byte for byte, in the matplotlib branch
(the tests hide plotly where it exists) and in the plotly one (through a
stub ``plotly`` that records the figures); ``viz_knns`` / ``viz_qa``
draw the committed fixture images pixel for pixel as JAX's do;
``rank_for_viz`` orders the candidates as the argsort of the scores JAX's
``visualize_results`` computes (f32), and its answer distributions are
JAX's; ``--viz`` ranks and renders (or, with no raw image directory, skips
the grids as JAX's does), and a failure of the ranking is not swallowed.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vqa_counterexamples_tpu.cli import visu as jax_visu
from vqa_counterexamples_tpu.core import policy as jax_policy
from vqa_counterexamples_tpu.core import rng as jax_rng
from vqa_counterexamples_tpu.data import synthetic as jax_synthetic
from vqa_counterexamples_tpu.viz import curves as jax_curves
from vqa_counterexamples_tpu.viz import grids as jax_grids
from vqa_counterexamples_tpu_torch.cli import counterexamples as port_cli
from vqa_counterexamples_tpu_torch.cli import visu as port_visu
from vqa_counterexamples_tpu_torch.core.experiment import (Experiment,
                                                           ScalarWriter)
from vqa_counterexamples_tpu_torch.core.meters import AvgMeter
from vqa_counterexamples_tpu_torch.data import vqacx as port_vqacx
from vqa_counterexamples_tpu_torch.data.image_fixtures import (FIXTURE_DIR,
                                                               SHAPES)
from vqa_counterexamples_tpu_torch.engines import cx_engine as port_engine
from vqa_counterexamples_tpu_torch.viz import curves as port_curves
from vqa_counterexamples_tpu_torch.viz import grids as port_grids

from test_torch_modules import K, build_pair
from test_torch_slice import _tiny_cli_options

IMAGES = [name for name, *_ in SHAPES]


@pytest.fixture
def no_plotly(monkeypatch):
    """Both packages' dashboards take their matplotlib branch."""
    monkeypatch.setitem(sys.modules, "plotly", None)
    monkeypatch.setitem(sys.modules, "plotly.graph_objects", None)


def _run_logs(root):
    """A run dir as the port's CLIs write it: ``logger.json``, the
    ``events.jsonl`` streams and ``eval_res``'s accuracy files."""
    xp = Experiment("run", {"a": 1})
    for tag, names in (("train", ("loss", "acc1")),
                       ("val", ("loss", "acc1", "acc5"))):
        xp.add_meters(tag, {n: AvgMeter() for n in names})
    rng = np.random.default_rng(0)
    for epoch in (1, 2, 3):
        for tag in ("train", "val"):
            for meter in xp.get_meters(tag).values():
                meter.reset()
                meter.update(float(rng.random()))
            xp.log_meters(tag, n=epoch)
    xp.to_json(os.path.join(root, "logger.json"))
    for sub in ("train", "val"):
        writer = ScalarWriter(os.path.join(root, sub))
        for step in (3, 1, 2):
            writer.add_scalar("recall", rng.random(), step)
        writer.close()
    for epoch in (2, 1):
        path = os.path.join(root, "results", "val",
                            "vqa_OpenEnded_mscoco_epoch_%d_accuracy.json"
                            % epoch)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"overall": 10.0 * epoch}, f)
    return root


def test_load_curves_matches_jax(tmp_path):
    root = _run_logs(str(tmp_path))
    got = port_curves.load_curves(root)
    assert got == jax_curves.load_curves(root)
    assert set(got) >= {"train/loss", "val/acc5", "val/openended",
                        "train/recall", "val/recall"}
    assert got["val/openended"] == ([1, 2], [10.0, 20.0])


def test_render_html_matplotlib_matches_jax(tmp_path, no_plotly):
    curves = port_curves.load_curves(_run_logs(str(tmp_path)))
    outs = [str(tmp_path / name) for name in ("jax.html", "port.html")]
    jax_curves.render_html({"run": curves}, outs[0])
    port_curves.render_html({"run": curves}, outs[1])
    html = [open(p).read() for p in outs]
    assert html[0] == html[1]
    assert html[1].count('<img src="data:image/png;base64,') == 4


@pytest.fixture
def stub_plotly(monkeypatch):
    """A ``plotly`` that records what each dashboard asks of it: every
    figure's traces and layout, written by ``plotly.offline.plot`` as a
    JSON div."""
    import types

    class Figure:
        def __init__(self):
            self.data, self.layout = [], {}

        def add_trace(self, trace):
            self.data.append(trace)

        def update_layout(self, **kwargs):
            self.layout.update(kwargs)

    def scatter(**kwargs):
        return kwargs

    def plot(fig, output_type, include_plotlyjs):
        assert (output_type, include_plotlyjs) == ("div", False)
        return "<div>%s</div>" % json.dumps(
            {"data": fig.data, "layout": fig.layout}, sort_keys=True)

    go = types.ModuleType("plotly.graph_objects")
    go.Figure, go.Scatter = Figure, scatter
    offline = types.ModuleType("plotly.offline")
    offline.plot = plot
    plotly = types.ModuleType("plotly")
    plotly.graph_objects, plotly.offline = go, offline
    for name, mod in (("plotly", plotly), ("plotly.graph_objects", go),
                      ("plotly.offline", offline)):
        monkeypatch.setitem(sys.modules, name, mod)


def test_render_html_plotly_matches_jax(tmp_path, stub_plotly):
    """The plotly branch asks plotly for JAX's figures: the same traces
    (each accuracy and recall with its best-so-far), layouts and page."""
    curves = port_curves.load_curves(_run_logs(str(tmp_path)))
    outs = [str(tmp_path / name) for name in ("jax.html", "port.html")]
    jax_curves.render_html({"run": curves}, outs[0])
    port_curves.render_html({"run": curves}, outs[1])
    html = [open(p).read() for p in outs]
    assert html[0] == html[1]
    assert html[1].startswith("<html><head><script src=")
    divs = [json.loads(d.split("</div>")[0])
            for d in html[1].split("<div>")[1:]]
    assert [d["layout"]["title"] for d in divs] == [
        "loss", "acc1", "acc5", "recall"]
    recall = divs[3]["data"]
    assert [t["name"] for t in recall] == [
        "run train/recall", "best train/recall: run",
        "run val/recall", "best val/recall: run"]
    assert recall[1]["y"] == port_curves.best_trace(recall[0]["x"],
                                                    recall[0]["y"])


def test_visu_cli_matches_jax(tmp_path, no_plotly):
    """Two runs in one dashboard, ``--watch 0``."""
    runs = [_run_logs(str(tmp_path / name)) for name in ("a", "b")]
    for cli, out in ((jax_visu, "jax.html"), (port_visu, "port.html")):
        cli.main(runs + ["--out", str(tmp_path / out), "--meters", "loss",
                         "acc1", "recall"])
    assert (tmp_path / "port.html").read_text() == (
        tmp_path / "jax.html").read_text()


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("grid", ["knns", "qa"])
def test_viz_grids_pixel_equal_jax(tmp_path, grid):
    """Both grids over the committed fixtures, the comp among the
    candidates: JAX's JPEG and the port's decode to the same pixels."""
    knns = IMAGES[1:] + IMAGES[1:3]
    for who, mod in (("jax", jax_grids), ("port", port_grids)):
        out = str(tmp_path / ("%s.jpg" % who))
        if grid == "knns":
            mod.viz_knns(FIXTURE_DIR, IMAGES[0], knns, IMAGES[2],
                         "what is it?", "yes", len(knns), outfile=out)
        else:
            dists = [[("a%d" % j, 0.5 / (j + 1)) for j in range(3)]
                     for _ in range(5)]
            mod.viz_qa(FIXTURE_DIR, IMAGES[0], knns, IMAGES[2],
                       "what is it?", "yes", "no", dists, 5, outfile=out)
    np.testing.assert_array_equal(_pixels(tmp_path / "port.jpg"),
                                  _pixels(tmp_path / "jax.jpg"))


@pytest.fixture(scope="module")
def pair():
    dataset, store = jax_synthetic.make_synthetic_cx(
        n_examples=12, n_images=20, dim_v=128, knn_size=K, n_words=20,
        n_answers=20, seed=4)
    jmodel, params, pmodel, arrays = build_pair(dataset)
    return dataset, store, jmodel, params, pmodel, arrays


@pytest.mark.parametrize("caches", [False, True])
def test_rank_for_viz_matches_jax(pair, monkeypatch, caches):
    """The order of each example's candidates is the argsort of the scores
    of JAX's ``visualize_results`` (its ``cx_model.apply``, f32); the top
    answers of the 5 best candidates are JAX's ``vqa_forward`` softmax's,
    with or without the port's caches (the eval step's inputs)."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    dataset, store, jmodel, params, pmodel, arrays = pair
    arrays = port_vqacx.CXArrays(*arrays)
    n = arrays.size
    batch = port_vqacx.gather_batch(arrays, np.arange(n))
    feats = jnp.asarray(store.features)[batch["image_idxs"]]
    keys = jax_rng.step_keys(jax_rng.root_key(0), 0, ("lesion",))
    with jax_policy.compute_dtype_scope("float32"):
        scores = np.asarray(jmodel.apply(
            {"params": params}, feats, jnp.asarray(batch["question_wids"]),
            jnp.asarray(batch["answer_aids"]), deterministic=True,
            rngs=keys))
        _, _, a_knns, _, _ = jmodel.apply(
            {"params": params}, feats, jnp.asarray(batch["question_wids"]),
            deterministic=True, rngs=keys, method=jmodel.vqa_forward)
    probs = np.asarray(jax.nn.softmax(a_knns, axis=-1))
    features = torch.from_numpy(store.features)
    tables = {}
    if caches:
        q, v, z, _ = port_engine.build_frozen_caches(pmodel, features,
                                                     arrays)
        tables = dict(q_table=q, v_table=v, z_table=z)
    got = port_grids.rank_for_viz(pmodel, features, arrays, 200, **tables)
    np.testing.assert_array_equal(got["order"], np.argsort(-scores))
    np.testing.assert_allclose(got["scores"], scores, rtol=1e-4, atol=1e-5)
    for i in range(n):
        for rank, j in enumerate(got["order"][i, :5]):
            top3 = np.argsort(-probs[i, j])[:3]
            np.testing.assert_array_equal(got["top_aids"][i, rank], top3)
            np.testing.assert_allclose(got["top_probs"][i, rank],
                                       probs[i, j, top3], rtol=1e-4)


def test_render_refuses_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib does not import, the render raises an
    ``ImportError`` naming it (the per-example ``except`` does not hide
    it)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    ranking = {"order": np.zeros((1, 2), np.int64), "top_aids": None,
               "top_probs": None}
    valset = {"vocab_answers": ["a"], "examples_list": [{}]}
    with pytest.raises(ImportError, match="matplotlib"):
        port_grids.visualize_results(valset, ranking, str(tmp_path),
                                     str(tmp_path))


def _few_val(monkeypatch, n=3):
    """The CLI's synthetic run with its val split cut to ``n`` examples
    (each rendered example draws two figures)."""
    load = port_cli.load_synthetic_data

    def few(args, n_examples):
        trainset, valset, _, store, val_store = load(args, n_examples)
        valset = dict(valset, examples_list=valset["examples_list"][:n])
        return trainset, valset, valset, store, val_store

    monkeypatch.setattr(port_cli, "load_synthetic_data", few)
    return few


@pytest.mark.parametrize("case", ["no_raw_dir", "fixtures", "rank_fails"])
def test_cx_cli_viz(tmp_path, monkeypatch, case):
    """``--viz`` after a 1-epoch run: the ranking runs on the val examples;
    with no raw image directory the grids are skipped (JAX's behaviour),
    with one holding the images both grids of every example are written;
    a ranking that fails raises."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    few = _few_val(monkeypatch)
    raw = tmp_path / "raw"
    base = _tiny_cli_options(tmp_path)
    path = tmp_path / "viz.yaml"
    path.write_text("base: %s\ncoco: {path_val_raw: %s}\n" % (base, raw))
    if case == "fixtures":
        _, valset, *_ = few(type("A", (), {"seed": 42})(), 64)
        raw.mkdir()
        for ex in valset["examples_list"]:
            for name in [ex["image_name"], ex["comp"]["image_name"],
                         *ex["knns"]]:
                shutil.copy(os.path.join(FIXTURE_DIR, IMAGES[0]),
                            raw / name)
    ranked = []
    rank = port_grids.rank_for_viz

    def spy(*args, **kw):
        if case == "rank_fails":
            raise RuntimeError("ranking failed")
        out = rank(*args, **kw)
        ranked.append(out)
        return out

    monkeypatch.setattr(port_grids, "rank_for_viz", spy)
    argv = ["--cx_model", "NeuralModel", "--synthetic", "64", "--epochs",
            "1", "--viz", "--device", "cpu", "--path_opt", str(path),
            "--project_dir", str(tmp_path)]
    if case == "rank_fails":
        with pytest.raises(RuntimeError, match="ranking failed"):
            port_cli.main(argv)
        return
    port_cli.main(argv)
    (out,) = ranked
    assert out["order"].shape == (3, 24) and out["top_aids"].shape == (
        3, 5, 3)
    (run,) = os.listdir(tmp_path / "viz" / "cx")
    written = sorted(os.listdir(tmp_path / "viz" / "cx" / run))
    if case == "no_raw_dir":
        assert written == []
    else:
        assert written == sorted(["viz_knns_%d.jpg" % i for i in range(3)]
                                 + ["viz_qa%d.jpg" % i for i in range(3)])
