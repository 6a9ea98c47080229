"""The JAX package's checkpoint files in the PyTorch port, both ways.

- the codec (``core/msgpack_tree``): its bytes equal
  ``flax.serialization.to_bytes`` on random trees, and each reads the
  other's;
- ``models/to_jax``: the port's weights as JAX's trees (against JAX's own
  mapping, ``models/port_torch``, and JAX's init templates), and
  ``from_jax(to_jax(x)) == x`` bit for bit;
- the CX scheme across the packages: a run of either CLI loads in the
  other bit for bit, and the next epoch from those states is held between
  the two (f32, ``drop_p`` 0);
- the VQA scheme across the packages (MutanNoAtt and MLBNoAtt, Adam state
  included) through JAX's ``cli/train.py --resume``;
- ``cli/port_checkpoint`` against JAX's on the reference-named torch
  oracles of ``tests/test_port_torch.py``, the port's modules built from
  its files against the oracles' forward, and ``--init_params``.
"""

import copy
import json
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import serialization

from vqa_counterexamples_tpu.cli import counterexamples as jax_cli
from vqa_counterexamples_tpu.cli import port_checkpoint as jax_port_cli
from vqa_counterexamples_tpu.cli import train as jax_train_cli
from vqa_counterexamples_tpu.core import checkpoint as jax_ckpt
from vqa_counterexamples_tpu.core import config as jax_config
from vqa_counterexamples_tpu.core import policy as jax_policy
from vqa_counterexamples_tpu.data import vqacx as jax_vqacx
from vqa_counterexamples_tpu.engines import cx_engine as jax_engine
from vqa_counterexamples_tpu.engines import vqa_engine as jax_vqa_engine
from vqa_counterexamples_tpu.models import factory as jax_factory
from vqa_counterexamples_tpu.models import port_torch
from vqa_counterexamples_tpu_torch.cli import counterexamples as port_cli
from vqa_counterexamples_tpu_torch.cli import port_checkpoint as port_port_cli
from vqa_counterexamples_tpu_torch.cli import train as port_train_cli
from vqa_counterexamples_tpu_torch.core import checkpoint as port_ckpt
from vqa_counterexamples_tpu_torch.core import config as port_config
from vqa_counterexamples_tpu_torch.core import msgpack_tree
from vqa_counterexamples_tpu_torch.engines import cx_engine as port_engine
from vqa_counterexamples_tpu_torch.engines import vqa_engine as port_vqa_engine
from vqa_counterexamples_tpu_torch.models import factory as port_factory
from vqa_counterexamples_tpu_torch.models import from_jax, to_jax

from test_port_torch import (DIM_V, NANS, V, TorchMutanNoAtt,
                             TorchNeuralCX, _noatt_opt, _wids)
from test_torch_mlb import _narrow
from test_torch_pretrain import _tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, prefix=""):
    """{path: leaf} of a tree (dicts and NamedTuples)."""
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, "%s/%s" % (prefix, k)))
        return out
    return {prefix: tree}


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    return np.asarray(a)


def _assert_same_leaves(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    for path, leaf in want.items():
        if leaf is None:
            assert got[path] is None, path
            continue
        g, w = _bits(got[path]), _bits(leaf)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert g.tobytes() == w.tobytes(), path


# ------------------------------------------------------------------ codec

def _random_tree(rng, depth=0):
    """(port tree, flax tree): the same values, bf16 leaves as a torch
    bfloat16 tensor on the port's side and an ml_dtypes array on flax's."""
    port, ref = {}, {}
    for i in range(int(rng.integers(0, 18 if depth else 20))):
        key = "k%d_%s" % (i, "x" * int(rng.integers(0, 40)))
        kind = int(rng.integers(0, 9 if depth < 2 else 8))
        if kind == 0:
            shape = tuple(int(s) for s in rng.integers(0, 5, size=rng.integers(
                0, 4)))
            v = rng.normal(size=shape).astype(np.float32)
            port[key] = ref[key] = v
        elif kind == 1:
            v = rng.normal(size=(int(rng.integers(1, 200)),)).astype(
                ml_dtypes.bfloat16)
            ref[key] = v
            port[key] = torch.from_numpy(v.view(np.int16).copy()).view(
                torch.bfloat16)
        elif kind == 2:
            port[key] = ref[key] = np.asarray(int(rng.integers(-1e6, 1e6)),
                                              np.int32)
        elif kind == 3:
            port[key] = ref[key] = None
        elif kind == 4:
            port[key] = ref[key] = {}
        elif kind == 5:
            port[key] = ref[key] = int(rng.choice(
                [0, 5, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32,
                 -33, -128, -129, -32768, -32769, -2 ** 31 - 1, 2 ** 40]))
        elif kind == 6:
            port[key] = ref[key] = float(rng.normal())
        elif kind == 7:
            port[key] = ref[key] = "s" * int(rng.choice([0, 31, 32, 255, 256,
                                                          70000]))
        else:
            port[key], ref[key] = _random_tree(rng, depth + 1)
    if depth == 0:
        big = rng.normal(size=(70000,)).astype(np.float32)
        port["big"] = ref["big"] = big
        port["scalar"] = ref["scalar"] = np.float32(rng.normal())
    return port, ref


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_codec_bytes_equal_flax(seed):
    """The port's bytes equal ``to_bytes`` of the same tree; each package
    reads the other's bytes to equal leaves."""
    port, ref = _random_tree(np.random.default_rng(seed))
    data = serialization.to_bytes(ref)
    assert msgpack_tree.pack(port) == data
    back = msgpack_tree.unpack(bytearray(data))
    _assert_same_leaves(back, port)
    restored = serialization.msgpack_restore(msgpack_tree.pack(port))
    for path, leaf in _flat(restored).items():
        want = _flat(ref)[path]
        assert np.asarray(leaf).tobytes() == np.asarray(want).tobytes(), path


def test_codec_refuses_chunked_leaves(monkeypatch):
    """flax chunks leaves over 2**30 bytes; the codec writes none and reads
    none (a small limit stands in for 2**30 here)."""
    chunked = serialization.msgpack_serialize(
        {"a": {"__msgpack_chunked_array__": True, "shape": [2],
               "chunks": {"0": np.zeros(2, np.float32)}}})
    with pytest.raises(ValueError, match="chunked"):
        msgpack_tree.unpack(chunked)
    monkeypatch.setattr(msgpack_tree, "MAX_CHUNK_SIZE", 16)
    with pytest.raises(ValueError, match="2\\*\\*30"):
        msgpack_tree.pack({"a": np.zeros(8, np.float32)})


# ---------------------------------------------------------------- to_jax

WORDS = ["w%d" % i for i in range(30)]
ANSWERS = ["a%d" % i for i in range(12)]


def _vqa_options(tmp_path, name, encoder):
    _, opt = _narrow(name, tmp_path)
    model = opt["model"]
    if encoder in ("lstm", "2-lstm"):
        hidden = 8
        model["seq2vec"] = {"arch": encoder, "emb_size": 16,
                            "hidden_size": hidden}
        dim_q = hidden * (2 if encoder == "2-lstm" else 1)
        if "attention" in model:
            model["dim_q"] = dim_q
        else:
            model["fusion"]["dim_q"] = dim_q
    elif encoder == "UniSkip":
        model["seq2vec"]["type"] = "UniSkip"
    return model


@pytest.mark.parametrize("name,encoder", [
    ("mutan_noatt_train.yaml", "BayesianUniSkip"),
    ("mutan_noatt_train.yaml", "UniSkip"),
    ("mutan_noatt_train.yaml", "2-lstm"),
    ("mutan_att_train.yaml", "BayesianUniSkip"),
    ("mlb_noatt_train.yaml", "lstm"),
    ("mlb_att_trainval.yaml", "2-lstm")])
def test_vqa_params_match_port_torch_and_round_trip(tmp_path, name,
                                                    encoder):
    """``to_jax.vqa_params`` equals JAX's ``port_vqa_state_dict`` of the
    same (reference-named) state_dict leaf for leaf, and ``from_jax``
    takes it back to the state_dict bit for bit."""
    opt = _vqa_options(tmp_path, name, encoder)
    model = port_factory.factory_vqa(opt, WORDS, ANSWERS)
    port_vqa_engine.init_vqa_params(model, seed=3)
    tree = to_jax.vqa_params(model)
    ref, _ = port_torch.port_vqa_state_dict(model.state_dict())
    _assert_same_leaves(tree, ref)
    assert list(tree) == sorted(tree)
    back = from_jax.vqa_state_dict_from_jax(tree,
                                            seq2vec_arch=model.seq2vec.arch)
    sd = dict(model.named_parameters())
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v.detach()), k


def _synthetic(n=64, seed=42):
    return jax_cli.load_synthetic_data(SimpleNamespace(seed=seed), n)


@pytest.mark.parametrize("cx_model", [
    "NeuralModel", "LinearContext", "PairwiseModel", "PairwiseLinearModel",
    "ContrastiveModel", "SemanticBaseline", "RandomBaseline"])
def test_cx_params_match_jax_template(tmp_path, cx_model):
    """The port's CX tree has JAX's init template's keys and shapes (the
    backbone nested under ``vqa_model``), equals JAX's
    ``port_cx_state_dict`` of the same state_dict, and round-trips."""
    path = _cx_yaml(tmp_path)
    options = jax_config.resolve_options({}, path, {})
    trainset, _, _, f_train, _ = _synthetic()
    words, answers = trainset["vocab_words"], trainset["vocab_answers"]
    arrays = jax_vqacx.CXArrays.from_examples(trainset["examples_list"],
                                              f_train.name_to_index)
    kw = ({"sb_lambda": 0.5} if cx_model == "SemanticBaseline"
          else {"model_spec": dict(options["cx_model"])})
    extra = ((jnp.eye(len(answers)),) if cx_model == "SemanticBaseline"
             else ())
    if cx_model == "RandomBaseline":
        jmodel = jax_factory.factory_cx(cx_model, None, knn_size=24)
    else:
        jmodel = jax_factory.factory_cx(
            cx_model, jax_factory.factory_vqa(options["model"], words,
                                              answers), knn_size=24, **kw)
    view = (arrays.pairwise_view(np.random.default_rng(0))
            if cx_model.startswith("Pairwise") else arrays)
    template = jax.device_get(jax_engine.init_cx_state(
        jmodel, None, jax_vqacx.gather_batch(view, np.arange(8)),
        f_train.features, extra_apply_args=extra).params)
    pmodel = port_factory.cx_from_options(
        cx_model, port_config.resolve_options({}, path, {}), words, answers,
        knn_size=24, sb_lambda=0.5)
    port_engine.init_cx_params(pmodel, seed=1)
    tree = to_jax.cx_params(pmodel)
    got, want = _flat(tree), _flat(template)
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert got[key].shape == leaf.shape, key
    if cx_model in ("SemanticBaseline", "RandomBaseline"):
        # JAX's mapping takes the models with weights of their own
        if "vqa_model" in tree:
            ref, _ = port_torch.port_vqa_state_dict(
                pmodel.vqa_model.state_dict())
            _assert_same_leaves(tree["vqa_model"], ref)
    else:
        ref, _, _ = port_torch.port_cx_state_dict(
            pmodel.state_dict(), cx_model=cx_model)
        _assert_same_leaves(tree, ref)
    back = from_jax.cx_state_dict_from_jax(tree)
    for k, v in pmodel.named_parameters():
        assert torch.equal(back[k], v.detach()), k


def test_adam_state_round_trips(tmp_path, monkeypatch):
    """A port state after three steps -> optax's Adam state dict -> a fresh
    optimizer: step, exp_avg and exp_avg_sq bit-equal; before any step the
    tree is optax's init (count 0, zero moments)."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    model = _cli_model(tmp_path)
    state = port_engine.init_cx_state(model, lr=1e-3)
    fresh = port_ckpt.cx_state_tree(state)["opt_state"]
    assert int(fresh["0"]["count"]) == 0 and fresh["1"] == {}
    assert all(not np.any(v) for v in _flat(fresh["0"]["mu"]).values())
    for p in state.optimizer.param_groups[0]["params"]:
        p.grad = torch.randn_like(p)
    for _ in range(3):
        state.optimizer.step()
    tree = port_ckpt.cx_state_tree(state)["opt_state"]
    assert int(tree["0"]["count"]) == 3
    other = copy.deepcopy(model)
    opt = torch.optim.Adam([p for n, p in other.named_parameters()
                            if not n.startswith("vqa_model.")], lr=1e-3)
    from_jax.adam_state_from_jax(tree, other, opt)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              other.named_parameters()):
        sa, sb = state.optimizer.state.get(a), opt.state.get(b)
        assert (sa is None) == (sb is None), n
        for key in sa or ():
            assert torch.equal(sa[key].float(), sb[key].float()), (n, key)


# ------------------------------------------------------ CX across packages

def _cx_yaml(tmp_path):
    """The CX default YAML at the test's widths, dropout 0 (the packages'
    dropout draws never match)."""
    base = os.path.join(REPO, "configs", "cx", "counterexamples_default.yaml")
    path = tmp_path / "cx_tiny.yaml"
    path.write_text(
        "base: %s\n"
        "model:\n"
        "  seq2vec: {emb_size: 16, hidden_size: 32}\n"
        "  fusion: {dim_q: 32, dim_hv: 24, dim_hq: 24, dim_mm: 24, R: 3}\n"
        "cx_model: {dim_h: 24, dim_a: 40, drop_p: 0.0}\n"
        "optim: {batch_size: 24}\n" % base)
    return str(path)


def _cli_model(tmp_path):
    """The CX CLI's NeuralModel on its synthetic run's vocab."""
    path = _cx_yaml(tmp_path)
    trainset = _synthetic()[0]
    model = port_factory.cx_from_options(
        "NeuralModel", port_config.resolve_options({}, path, {}),
        trainset["vocab_words"], trainset["vocab_answers"], knn_size=24)
    return port_engine.init_cx_params(model, seed=42)


def _cx_argv(tmp_path, project, *extra):
    return ["--cx_model", "NeuralModel", "--synthetic", "64",
            "--path_opt", _cx_yaml(tmp_path), "--project_dir", str(project),
            "--comment", "run", *extra]


def _jax_f32():
    return jax_policy.compute_dtype_scope("float32")


def _jax_cx_main(argv):
    with _jax_f32():
        return jax_cli.main(argv)


def _run_dir(project):
    (run,) = os.listdir(os.path.join(project, "logs", "cx"))
    return run, os.path.join(project, "logs", "cx", run)


def _jax_cx_template(tmp_path):
    """JAX's ``CXTrainState`` for the CLI's synthetic run (the template
    its ``load_cx_checkpoint`` reads against)."""
    path = _cx_yaml(tmp_path)
    options = jax_config.resolve_options({}, path, {})
    trainset, _, _, f_train, _ = _synthetic()
    arrays = jax_vqacx.CXArrays.from_examples(trainset["examples_list"],
                                              f_train.name_to_index)
    jmodel = jax_factory.factory_cx(
        "NeuralModel", jax_factory.factory_vqa(
            options["model"], trainset["vocab_words"],
            trainset["vocab_answers"]), knn_size=24, trainable_vqa=False,
        model_spec=dict(options["cx_model"]))
    return jax_engine.init_cx_state(
        jmodel, optax.adam(options["optim"]["lr"]),
        jax_vqacx.gather_batch(arrays, np.arange(24)), f_train.features)


def _port_cx_state(tmp_path):
    model = _cli_model(tmp_path)
    return port_engine.init_cx_state(model, lr=1e-4)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cx_checkpoint_crosses_packages(tmp_path, monkeypatch, writer):
    """A 1-epoch run of one package's CLI: its ``ckpt/`` loads in JAX's
    ``load_cx_checkpoint`` (against JAX's template) and in the port's, the
    leaves bit-equal to ``to_jax`` of the port's loaded state, and JAX
    writes the same bytes back; then each package resumes it for epoch 2
    (f32, dropout 0): the val losses and the trained parameters agree."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    src = tmp_path / "src"
    argv = _cx_argv(tmp_path, src, "--epochs", "1")
    (port_cli.main if writer == "port" else _jax_cx_main)(
        argv + (["--device", "cpu"] if writer == "port" else []))
    run, run_dir = _run_dir(src)
    jstate, info, nxt, _ = jax_ckpt.load_cx_checkpoint(
        _jax_cx_template(tmp_path), run_dir, resume_best=False)
    assert nxt == 2 and len(info) == 1
    pstate, pinfo, pnext, _ = port_ckpt.load_cx_checkpoint(
        _port_cx_state(tmp_path), run_dir, resume_best=False)
    assert (pinfo, pnext) == (info, 2)
    _assert_same_leaves(port_ckpt.cx_state_tree(pstate),
                        serialization.to_state_dict(jax.device_get(jstate)))
    with open(os.path.join(run_dir, "ckpt", "model.ckpt"), "rb") as f:
        assert f.read() == serialization.to_bytes(jax.device_get(jstate))
    # epoch 2 in both packages from the same files
    for who in ("port", "jax"):
        shutil.copytree(src, tmp_path / who)
        argv = _cx_argv(tmp_path, tmp_path / who, "--epochs", "2",
                        "--resume", run)
        if who == "port":
            port_cli.main(argv + ["--device", "cpu"])
        else:
            _jax_cx_main(argv)
    done = {who: _run_dir(tmp_path / who)[1] for who in ("port", "jax")}
    infos = {who: json.loads(open(os.path.join(d, "ckpt", "info.ckpt"))
                             .read()) for who, d in done.items()}
    assert len(infos["port"]) == len(infos["jax"]) == 2
    assert infos["port"][0] == infos["jax"][0] == info[0]
    assert infos["port"][1]["loss"] == pytest.approx(
        infos["jax"][1]["loss"], rel=1e-4)
    trees = {who: msgpack_tree.load(os.path.join(d, "ckpt", "model.ckpt"))
             for who, d in done.items()}
    assert int(trees["port"]["step"]) == int(trees["jax"]["step"]) == 2 * 3
    got, want = _flat(trees["port"]["params"]), _flat(trees["jax"]["params"])
    for path, ref in want.items():
        if path == "/out_b":     # trains on rounding noise (ROADMAP Queue 3)
            continue
        np.testing.assert_allclose(got[path], ref, rtol=1e-4, atol=2e-5,
                                   err_msg=path)


def test_cx_checkpoint_refuses_other_trees(tmp_path, monkeypatch):
    """A load checks the file's tree against the model's: another width,
    a missing leaf, an optimizer where the model has none, or a bare
    param tree where a train state belongs, raise
    ``ValueError``; ``--init_params`` raises before anything trains."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    state = _port_cx_state(tmp_path)
    save_dir = str(tmp_path / "run")
    port_ckpt.save_cx_checkpoint(state, [{"recall": 0.1}], save_dir)
    tree = port_ckpt.cx_state_tree(state)
    bad = copy.deepcopy(tree)
    bad["params"]["linear_1_w"] = bad["params"]["linear_1_w"][:, :3]
    msgpack_tree.save(bad, os.path.join(save_dir, "best", "model.ckpt"))
    with pytest.raises(ValueError, match="shape mismatch"):
        port_ckpt.load_cx_checkpoint(_port_cx_state(tmp_path), save_dir)
    del bad["params"]["linear_1_w"]
    msgpack_tree.save(bad, os.path.join(save_dir, "best", "model.ckpt"))
    with pytest.raises(ValueError, match="linear_1_w"):
        port_ckpt.load_cx_checkpoint(_port_cx_state(tmp_path), save_dir)
    with pytest.raises(ValueError, match="opt_state"):
        port_ckpt.load_cx_checkpoint(
            port_engine.CXTrainState(_cli_model(tmp_path), None, 0),
            save_dir, resume_best=False)
    msgpack_tree.save(tree["params"], os.path.join(save_dir, "best",
                                                   "model.ckpt"))
    with pytest.raises(ValueError, match="not a CXTrainState"):
        port_ckpt.load_cx_checkpoint(_port_cx_state(tmp_path), save_dir)
    msgpack_tree.save(bad["params"], str(tmp_path / "p.msgpack"))
    with pytest.raises(ValueError, match="linear_1_w"):
        port_cli.main(_cx_argv(tmp_path, tmp_path / "cli", "--epochs", "1",
                               "--device", "cpu", "--init_params",
                               str(tmp_path / "p.msgpack")))
    assert not os.path.exists(tmp_path / "cli" / "logs" / "cx" /
                              os.listdir(tmp_path / "cli" / "logs" / "cx")[0]
                              / "ckpt" / "model.ckpt")


# ----------------------------------------------------- VQA across packages

def _vqa_yaml(tmp_path, arch):
    if arch == "MutanNoAtt":
        path, logs = _tiny_config(tmp_path)
        return path, str(logs)
    path, opt = _narrow("mlb_noatt_train.yaml", tmp_path)
    return path, opt["logs"]["dir_logs"]


def _vqa_argv(path, *extra):
    return ["--path_opt", path, "--synthetic", "64", "-b", "16", "-p", "2",
            *extra]


def _jax_vqa_template(path):
    """JAX's VQA params and Adam state for the train CLI's synthetic run
    (a NoAtt arch), as its ``init_vqa_state`` makes them."""
    options = jax_config.resolve_options({}, path, {})
    _, _, words, answers = jax_train_cli._synthetic_vqa(64, options, 42)
    model = jax_factory.factory_vqa(options["model"], words, answers)
    example = {"visual": np.zeros((8, options["model"]["fusion"]["dim_v"]),
                                  np.float32),
               "question": np.ones((8, options["vqa"]["maxlength"]),
                                   np.int32)}
    return jax_vqa_engine.init_vqa_state(
        model, optax.adam(options["optim"]["lr"]), example)


def _port_vqa_state(path):
    options = port_config.resolve_options({}, path, {})
    _, _, words, answers = jax_train_cli._synthetic_vqa(64, options, 42)
    model = port_factory.factory_vqa(options["model"], words, answers)
    port_vqa_engine.init_vqa_params(model)
    return port_vqa_engine.init_vqa_state(model, lr=options["optim"]["lr"])


@pytest.mark.parametrize("arch", ["MutanNoAtt", "MLBNoAtt"])
def test_vqa_checkpoint_crosses_packages(tmp_path, monkeypatch, arch):
    """The port's train CLI writes the triple; JAX's ``load_vqa_checkpoint``
    reads it to the leaves of ``to_jax`` of the port's loaded state (and
    writes the same bytes back), and JAX's ``cli/train.py --resume ckpt``
    trains epoch 2 from it; the port reads JAX's epoch-2 triple bit-equal
    to ``from_jax`` of JAX's loaded trees, and resumes epoch 3."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    path, logs = _vqa_yaml(tmp_path, arch)
    port_train_cli.main(_vqa_argv(path, "--epochs", "1", "--device", "cpu"))
    names = sorted(os.listdir(logs))
    for suffix in ("info.json", "model.msgpack", "optim.msgpack"):
        assert "ckpt_" + suffix in names
    template = _jax_vqa_template(path)
    info, jparams, jopt = jax_ckpt.load_vqa_checkpoint(
        template.params, template.opt_state, logs)
    assert info["epoch"] == 1
    pstate = _port_vqa_state(path)
    assert port_ckpt.load_vqa_checkpoint(pstate, logs) == info
    assert pstate.step == 4
    _assert_same_leaves(to_jax.vqa_params(pstate.model),
                        jax.device_get(jparams))
    _assert_same_leaves(to_jax.adam_state(pstate.model, pstate.optimizer,
                                          to_jax.vqa_params),
                        serialization.to_state_dict(jax.device_get(jopt)))
    for name, tree in (("model", jparams), ("optim", jopt)):
        with open(os.path.join(logs, "ckpt_%s.msgpack" % name), "rb") as f:
            assert f.read() == serialization.to_bytes(jax.device_get(tree))
    with _jax_f32():
        jax_train_cli.main(_vqa_argv(path, "--epochs", "2", "--resume",
                                     "ckpt"))
    info, jparams, jopt = jax_ckpt.load_vqa_checkpoint(
        template.params, template.opt_state, logs)
    assert info["epoch"] == 2
    pstate = _port_vqa_state(path)
    assert port_ckpt.load_vqa_checkpoint(pstate, logs) == info
    want = from_jax.vqa_state_dict_from_jax(
        jax.device_get(jparams), seq2vec_arch=pstate.model.seq2vec.arch)
    for name, p in pstate.model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name
    ref = port_engine.CXTrainState(copy.deepcopy(pstate.model), None, 0)
    ref_opt = torch.optim.Adam(ref.model.parameters(), lr=1e-4)
    from_jax.vqa_adam_state_from_jax(jax.device_get(jopt), ref.model,
                                     ref_opt)
    for p, q in zip(pstate.model.parameters(), ref.model.parameters()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(pstate.optimizer.state[p][key],
                               ref_opt.state[q][key]), key
    state = port_train_cli.main(_vqa_argv(path, "--epochs", "3", "--resume",
                                          "ckpt", "--device", "cpu"))
    assert state.step == 3 * 4


# ------------------------------------------------------- port_checkpoint

K, DIM_A, DIM_H = 4, 8, 12


def _oracles():
    torch.manual_seed(4)
    vqa = TorchMutanNoAtt(_noatt_opt()["fusion"]).eval()
    cx = TorchNeuralCX(TorchMutanNoAtt(_noatt_opt()["fusion"]), K, DIM_A,
                       DIM_H).eval()
    return vqa, cx


@pytest.mark.parametrize("kind", ["vqa", "cx"])
def test_port_checkpoint_matches_jax_and_oracle(tmp_path, kind):
    """Both packages' ``port_checkpoint`` on a reference-named torch
    checkpoint write the same bytes (so JAX loads the port's files leaf
    for leaf as its own); the port's modules built from them give the
    oracle's forward (f32, rtol 1e-4)."""
    vqa, cx = _oracles()
    oracle = vqa if kind == "vqa" else cx
    src = tmp_path / ("best_model.pth.tar" if kind == "vqa" else "model.ckpt")
    torch.save(oracle.state_dict(), str(src))
    outs = {}
    for who, cli in (("jax", jax_port_cli), ("port", port_port_cli)):
        out = tmp_path / who / ("ported" if kind == "vqa" else "p.msgpack")
        os.makedirs(out.parent, exist_ok=True)
        cli.main(["--src", str(src), "--kind", kind, "--out", str(out)])
        outs[who] = out
    if kind == "vqa":
        names = sorted(os.listdir(outs["port"]))
        assert names == sorted(os.listdir(outs["jax"])) == [
            "best_info.json", "best_model.msgpack", "ckpt_info.json",
            "ckpt_model.msgpack"]
        for name in names:
            if name.endswith(".json"):
                continue     # the source path differs
            assert (outs["port"] / name).read_bytes() == (
                outs["jax"] / name).read_bytes(), name
        info = json.loads((outs["port"] / "best_info.json").read_text())
        assert info["arch"] == "MutanNoAtt" and info["epoch"] == 0
    else:
        assert outs["port"].read_bytes() == outs["jax"].read_bytes()
    words = ["w%d" % i for i in range(V)]
    answers = ["a%d" % i for i in range(NANS)]
    vqa_model = port_factory.factory_vqa(_noatt_opt(), words, answers)
    wids = torch.from_numpy(_wids().astype(np.int64))
    rng = np.random.default_rng(1)
    with torch.no_grad():
        if kind == "vqa":
            assert port_ckpt.load_vqa_model(vqa_model,
                                            str(outs["port"] / "best"))
            visual = torch.from_numpy(rng.normal(
                size=(wids.shape[0], DIM_V)).astype(np.float32))
            got = vqa_model.eval()(visual, wids)
            ref = oracle(visual, wids)
        else:
            spec = dict(dim_h=DIM_H, n_layers=2, drop_p=0.25, dim_a=DIM_A,
                        v_emb=True, v_mult=True, v_dist=True, v_rank=True,
                        q_emb=True, a_emb=True, z_emb=True,
                        pretrained_emb=False, trainable_vqa=False)
            model = port_factory.factory_cx("NeuralModel", vqa_model,
                                            knn_size=K, model_spec=spec)
            port_ckpt.load_cx_params(model,
                                     msgpack_tree.load(str(outs["port"])))
            feats = torch.from_numpy(rng.normal(
                size=(wids.shape[0], K + 1, DIM_V)).astype(np.float32))
            aids = torch.from_numpy(rng.integers(0, NANS, wids.shape[0]))
            got = model.eval()(feats, wids, aids)
            ref = oracle(feats, wids, aids)
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_init_params_starts_the_cli_from_a_ported_file(tmp_path,
                                                       monkeypatch):
    """``port_checkpoint --kind cx`` on a reference-named state_dict of the
    CLI's model (other weights than the CLI's init), then
    ``counterexamples --init_params``: the port's CLI starts from exactly
    those weights, and scores the test split as JAX's CLI does from the
    same file (f32)."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    source = port_engine.init_cx_params(_cli_model(tmp_path), seed=7)
    torch.save(source.state_dict(), str(tmp_path / "model.ckpt"))
    params = str(tmp_path / "p.msgpack")
    port_port_cli.main(["--src", str(tmp_path / "model.ckpt"), "--kind",
                        "cx", "--out", params])
    seen = []
    load = port_ckpt.load_cx_params

    def spy(model, tree, path="params"):
        load(model, tree, path)
        seen.append({k: v.detach().clone()
                     for k, v in model.named_parameters()})

    monkeypatch.setattr(port_ckpt, "load_cx_params", spy)
    results = {}
    for who in ("port", "jax"):
        argv = _cx_argv(tmp_path, tmp_path / who, "--epochs", "0", "--test",
                        "--init_params", params)
        if who == "port":
            port_cli.main(argv + ["--device", "cpu"])
        else:
            _jax_cx_main(argv)
        results[who] = json.loads(open(os.path.join(
            _run_dir(tmp_path / who)[1], "final_results.txt")).read())
    (loaded,) = seen
    for name, p in source.named_parameters():
        assert torch.equal(loaded[name], p.detach()), name
    for key in ("loss", "recall", "recall_1"):
        assert results["port"][key] == pytest.approx(results["jax"][key],
                                                     rel=1e-4), key


def test_demo_server_serves_a_jax_triple(tmp_path, monkeypatch):
    """JAX's ``cli/train.py`` writes the triple; the port's demo server
    (``create_server --dir_logs``) loads its model file bit-equal to
    ``from_jax`` of JAX's loaded params and answers a request."""
    import base64
    import io
    import pickle

    from PIL import Image

    from vqa_counterexamples_tpu_torch.serve import demo_server

    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    path, logs = _tiny_config(tmp_path)
    opt = port_config.load_yaml(path)
    opt["model"]["fusion"]["dim_v"] = 2048          # ResNet-50's features
    opt["coco"].update(arch="resnet50", size=64)
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    with _jax_f32():
        jax_train_cli.main(_vqa_argv(path, "--epochs", "1"))
    for name in ("info.json", "model.msgpack", "optim.msgpack"):
        shutil.copyfile(os.path.join(logs, "ckpt_" + name),
                        os.path.join(logs, "best_" + name))
    options = jax_config.resolve_options({}, path, {})
    _, _, words, answers = jax_train_cli._synthetic_vqa(64, options, 42)
    vocab = tmp_path / "vocab"
    vocab.mkdir()
    with open(vocab / "wid_to_word.pickle", "wb") as f:
        pickle.dump({i + 1: w for i, w in enumerate(words)}, f)
    with open(vocab / "aid_to_ans.pickle", "wb") as f:
        pickle.dump(list(answers), f)
    _, jparams, _ = jax_ckpt.load_vqa_checkpoint(
        _jax_vqa_template(path).params, None, os.path.join(logs, "best"))
    server = demo_server.create_server([
        "--path_opt", path, "--port", "0", "--device", "cpu", "--dir_logs",
        str(logs), "--vocab_path", str(vocab)])
    try:
        want = from_jax.vqa_state_dict_from_jax(jax.device_get(jparams))
        for name, p in server.engine.vqa_model.named_parameters():
            assert torch.equal(p.detach(), want[name]), name
        buf = io.BytesIO()
        Image.fromarray(np.full((64, 64, 3), 90, np.uint8)).save(
            buf, format="JPEG")
        out = server.engine.answer(base64.b64encode(buf.getvalue()).decode(),
                                   "what is it")
        assert len(out["ans"]) == 5 and set(out["ans"]) <= set(answers)
    finally:
        server.server_close()
