"""The port's demo server (``vqa_counterexamples_tpu_torch/serve/
demo_server.py``): the cases of ``tests/test_demo_engine.py`` against the
port's engine (question encoding, buckets, the checkpoint registry and the
``best`` prefix, ``answer_batch`` against ``answer``, hot swap, the batcher,
``prewarm``, the uint8 normalize), the port's predict against the JAX
package's ``DemoEngine`` on the same carried weights, one HTTP round trip
over every route, and ``core/graphs.GraphedCall`` under a fake graph.

Widths are narrow (skip-thoughts 16 -> 48, MUTAN R 3 at 24, 64 x 64 images,
the ResNet-50 name cut to depth (1, 1, 1, 1)).  Tolerances: JAX's own
1e-3 for a batch-1 against a batch-4 answer; against JAX, both at f32,
top-5 answers equal, probabilities within 1e-5, glimpse pixels within 1
(a map value near a multiple of 1/255 may truncate either way)."""

import base64
import contextlib
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vqa_counterexamples_tpu.models import convnets as jax_convnets
from vqa_counterexamples_tpu.models import factory as jax_factory
from vqa_counterexamples_tpu.serve.demo_server import (
    DemoEngine as JaxDemoEngine)
from vqa_counterexamples_tpu_torch.core import checkpoint as port_ckpt
from vqa_counterexamples_tpu_torch.core import config as port_config
from vqa_counterexamples_tpu_torch.core import graphs, spans
from vqa_counterexamples_tpu_torch.data import synthetic
from vqa_counterexamples_tpu_torch.data.tokenizers import tokenize_mcb
from vqa_counterexamples_tpu_torch.engines import vqa_engine
from vqa_counterexamples_tpu_torch.models import convnets, factory, from_jax
from vqa_counterexamples_tpu_torch.serve import demo_server
from vqa_counterexamples_tpu_torch.serve.demo_server import (
    DemoEngine, MicroBatcher, _next_bucket, list_checkpoints)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (1, 1, 1, 1)
NANS = 6


def _options(attention: bool) -> dict:
    name = "mutan_att_train.yaml" if attention else "mutan_noatt_train.yaml"
    opt = port_config.load_options_file(os.path.join(REPO, "configs",
                                                     "vqa2", name))
    model = opt["model"]
    model["seq2vec"].update(emb_size=16, hidden_size=48, dir_st="/no_st")
    if attention:
        model.update(dim_v=2048, dim_q=48)
        model["attention"].update(dim_hv=20, dim_hq=20, dim_mm=18, R=3)
        model["fusion"].update(dim_hv=40, dim_hq=20, dim_mm=18, R=3)
    else:
        model["fusion"].update(dim_q=48, dim_hv=24, dim_hq=24, dim_mm=24,
                               R=3)
    opt["vqa"].update(maxlength=8, nans=NANS)
    opt["coco"].update(arch="resnet50", size=64)
    return opt


def _vocab():
    return synthetic.synthetic_vocab(30, NANS)


def _port_engine(attention=False, dtype=torch.bfloat16, seed=0, **kwargs):
    options = _options(attention)
    vocab_words, vocab_answers = _vocab()
    model = factory.factory_vqa(options["model"], vocab_words,
                                vocab_answers)
    vqa_engine.init_vqa_params(model, seed=seed)
    cnn = convnets.init_resnet(convnets.ResNet(depths=TINY, dtype=dtype))
    return DemoEngine(options, model, cnn, vocab_words, vocab_answers,
                      attention, **kwargs)


def _jpeg_b64(seed, size=64):
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 255, (size, size, 3),
                                       dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode()


def _items(n=3):
    return [{"visual": _jpeg_b64(i), "question": "what color is the w%d" % i}
            for i in range(n)]


# ---------------------------------------------- encoding, buckets, registry

def _encoding_engine(pad):
    eng = DemoEngine.__new__(DemoEngine)   # no models: encoding only
    eng.word_to_wid = {"what": 1, "color": 2, "is": 3, "the": 4, "cat": 5,
                       "UNK": 6}
    eng.maxlength = 8
    eng.pad = pad
    eng.tokenize = tokenize_mcb
    return eng


@pytest.mark.parametrize("pad,question,want", [
    ("right", "What color is the zebra?", [1, 2, 3, 4, 6, 0, 0, 0]),
    ("left", "the cat", [0, 0, 0, 0, 0, 0, 4, 5]),
    ("right", "what " * 20, [1] * 8)])
def test_encode_question(pad, question, want):
    wids = _encoding_engine(pad).encode_question(question)
    assert wids.dtype == np.int32
    np.testing.assert_array_equal(wids, want)


def test_next_bucket_powers_of_two():
    assert [_next_bucket(n) for n in (1, 2, 3, 4, 5, 8, 9, 31, 32)] == \
        [1, 2, 4, 4, 8, 8, 16, 32, 32]


def test_list_checkpoints_registry(tmp_path):
    run_a = tmp_path / "run_a"          # best files (prefix scheme)
    run_a.mkdir()
    (run_a / "best_model.msgpack").write_bytes(b"")
    (run_a / "best_info.json").write_text(json.dumps({"epoch": 7}))
    run_b = tmp_path / "run_b"          # ckpt files only
    run_b.mkdir()
    (run_b / "ckpt_model.msgpack").write_bytes(b"")
    run_c = tmp_path / "run_c"          # no model file: not a checkpoint
    run_c.mkdir()
    (run_c / "best_model.pt").write_bytes(b"")
    (tmp_path / "empty_dir").mkdir()
    (tmp_path / "stray.txt").write_text("x")
    got = list_checkpoints(str(tmp_path))
    assert [c["name"] for c in got] == ["run_a", "run_b"]
    assert got[0]["best"] and got[0]["epoch"] == 7
    assert got[0]["path"].endswith("run_a/best")
    assert not got[1]["best"] and got[1]["path"].endswith("run_b")
    assert got[1]["epoch"] is None
    assert list_checkpoints(str(tmp_path / "missing")) == []
    assert list_checkpoints(None) == []


def _save_run(root, name, model, epoch=1):
    state = vqa_engine.init_vqa_state(model)
    port_ckpt.save_vqa_checkpoint({"epoch": epoch, "best_acc1": 0.5}, state,
                                  os.path.join(root, name), is_best=True)


def test_best_prefix_roundtrip(tmp_path):
    """``<dir>/best`` loads the best_* files saved NEXT TO ckpt_*, and the
    registry's path for it is that prefix."""
    model = factory.factory_vqa(_options(False)["model"], *_vocab())
    vqa_engine.init_vqa_params(model, seed=3)
    _save_run(str(tmp_path), "run", model, epoch=3)
    (entry,) = list_checkpoints(str(tmp_path))
    assert entry["best"] and entry["epoch"] == 3
    other = factory.factory_vqa(_options(False)["model"], *_vocab())
    assert port_ckpt.load_vqa_model(other, entry["path"])
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), n


# ------------------------------------------------ answers, swap, batcher

def test_answer_batch_one_call_matches_single_and_hot_swap(tmp_path):
    engine = _port_engine()
    items = _items()
    results = engine.answer_batch(items)     # bucket 4: padded tail sliced
    assert len(results) == 3
    for r in results:
        assert len(r["ans"]) == 5 and len(r["val"]) == 5
        assert all(0.0 <= v <= 1.0 for v in r["val"])
        assert r["att"] == []                # MutanNoAtt: no glimpses
    single = engine.answer(items[1]["visual"], items[1]["question"])
    assert single["ans"] == results[1]["ans"]
    # bf16 trunk: batch-1 vs batch-4 convolutions round apart (JAX's bound)
    np.testing.assert_allclose(single["val"], results[1]["val"], atol=1e-3)

    # a hot swap changes the served weights (and the output), in place
    ptrs = [p.data_ptr() for p in engine.vqa_model.parameters()]
    other = factory.factory_vqa(_options(False)["model"], *_vocab())
    vqa_engine.init_vqa_params(other, seed=0)
    with torch.no_grad():
        for p in other.parameters():
            p.add_(0.5)
    _save_run(str(tmp_path), "run", other)
    engine.load_checkpoint(str(tmp_path / "run" / "best"))
    swapped = engine.answer(items[1]["visual"], items[1]["question"])
    assert swapped["val"] != single["val"]
    assert ptrs == [p.data_ptr() for p in engine.vqa_model.parameters()]
    with pytest.raises(FileNotFoundError):
        engine.load_checkpoint(str(tmp_path / "nothing"))


def test_microbatcher_coalesces_concurrent_requests():
    engine = _port_engine()
    calls = []
    real_predict = engine.predict_prepared_async

    def counting_predict(images, wids):
        calls.append(images.shape[0])
        return real_predict(images, wids)

    engine.predict_prepared_async = counting_predict
    # enqueue everything before the one dispatcher starts: deterministic
    batcher = MicroBatcher(engine, max_wait_ms=50.0, autostart=False,
                           n_dispatchers=1)
    items = _items(5)
    results: list = [None] * len(items)
    errors: list = []

    def worker(j):
        try:
            results[j] = batcher.submit(items[j])
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(j,))
               for j in range(len(items))]
    for t in threads:
        t.start()
    deadline = time.time() + 30
    while batcher.pending() < len(items) and time.time() < deadline:
        time.sleep(0.01)
    assert batcher.pending() == len(items)
    batcher.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert calls == [5], calls  # one coalesced forward (bucket 8)
    direct = engine.answer_batch(items)
    for got, want in zip(results, direct):
        assert got["ans"] == want["ans"]
        np.testing.assert_allclose(got["val"], want["val"], atol=1e-3)


def test_microbatcher_adaptive_lone_request_skips_the_window():
    engine = _port_engine()
    item = _items(1)[0]
    engine.answer(item["visual"], item["question"])
    calls = []
    real_predict = engine.predict_prepared_async

    def counting_predict(images, wids):
        calls.append(images.shape[0])
        return real_predict(images, wids)

    engine.predict_prepared_async = counting_predict
    batcher = MicroBatcher(engine, max_wait_ms=30_000.0)
    assert batcher.adaptive
    t0 = time.time()
    out = batcher.submit(item)
    assert time.time() - t0 < 15.0
    assert calls == [1]
    assert len(out["ans"]) == 5


def test_microbatcher_propagates_errors_to_all_waiters():
    engine = _port_engine()

    def boom(images, wids):
        raise RuntimeError("device on fire")

    engine.predict_prepared_async = boom
    batcher = MicroBatcher(engine, max_wait_ms=20.0, autostart=False)
    item = _items(1)[0]
    caught = []

    def worker():
        try:
            batcher.submit(item)
        except RuntimeError as exc:
            caught.append(str(exc))

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    deadline = time.time() + 30
    while batcher.pending() < 2 and time.time() < deadline:
        time.sleep(0.01)
    batcher.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert caught == ["device on fire"] * 2


def test_equal_probabilities_rank_the_lower_answer_first():
    """With every logit equal the top 5 are answers 0-4 in order, as
    ``lax.top_k`` ranks ties, at every bucket."""
    engine = _port_engine()
    with torch.no_grad():
        engine.vqa_model.linear_classif.weight.zero_()
        engine.vqa_model.linear_classif.bias.zero_()
    for n in (1, 3):
        images = np.zeros((n, 64, 64, 3), np.uint8)
        vals, idxs, _ = engine.predict_prepared(
            images, np.ones((n, 8), np.int32))
        np.testing.assert_array_equal(idxs, np.tile(np.arange(5), (n, 1)))
        np.testing.assert_allclose(vals, 1.0 / NANS, rtol=1e-6)


@pytest.mark.parametrize("concurrent", [True, False])
def test_prewarm_runs_every_bucket(concurrent):
    engine = _port_engine()
    calls = []
    real_predict = engine.predict_prepared

    def counting_predict(images, wids):
        calls.append(images.shape[0])
        return real_predict(images, wids)

    engine.predict_prepared = counting_predict
    max_bucket = 8 if concurrent else 4
    warmed = engine.prewarm(max_bucket=max_bucket, concurrent=concurrent)
    assert warmed == [1, 2, 4, 8][:warmed.index(max_bucket) + 1]
    assert sorted(calls) == warmed
    assert engine.n_graphs == 0        # the CPU runs eagerly


def test_uint8_device_normalize_matches_host_preprocess():
    from PIL import Image

    rng = np.random.default_rng(3)
    img = Image.fromarray(rng.integers(0, 255, (500, 400, 3),
                                       dtype=np.uint8), "RGB")
    ref = convnets.preprocess_image(img, size=64)
    u8 = convnets.preprocess_image_uint8(img, size=64).copy()
    dev = convnets.normalize_images_device(torch.from_numpy(u8)).numpy()
    np.testing.assert_allclose(dev, ref, atol=1e-6)


# ---------------------------------------------------------- against JAX

def _jax_and_port_engines(attention, monkeypatch):
    """Both engines over the same weights, trunks and policy at f32; the
    answer head scaled up so the top 5 are well apart."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    monkeypatch.setattr(jax_convnets, "factory", lambda opt: jax_convnets.
                        ResNet(depths=TINY, dtype=jnp.float32))
    options = _options(attention)
    vocab_words, vocab_answers = _vocab()
    cnn_params = jax.tree_util.tree_map(np.asarray, jax_convnets.init_resnet(
        jax_convnets.ResNet(depths=TINY), 64, seed=4))
    model = jax_factory.factory_vqa(options["model"], tuple(vocab_words),
                                    tuple(vocab_answers))
    dummy_v = (jnp.zeros((1, 2, 2, 2048)) if attention
               else jnp.zeros((1, 2048)))
    params = model.init({"params": jax.random.key(0),
                         "dropout": jax.random.key(1)}, dummy_v,
                        jnp.zeros((1, 8), jnp.int32),
                        deterministic=True)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["linear_classif"]["kernel"] = \
        params["linear_classif"]["kernel"] * 40.0
    jax_engine = JaxDemoEngine(options, params, cnn_params, vocab_words,
                               vocab_answers, attention)
    port_model = factory.factory_vqa(options["model"], vocab_words,
                                     vocab_answers)
    port_model.load_state_dict(from_jax.vqa_state_dict_from_jax(params))
    cnn = convnets.ResNet(depths=TINY, dtype=torch.float32)
    cnn.load_state_dict(from_jax.resnet_from_jax(cnn_params))
    port_engine = DemoEngine(options, port_model, cnn, vocab_words,
                             vocab_answers, attention)
    return jax_engine, port_engine


def _png_pixels(b64):
    from PIL import Image

    with Image.open(io.BytesIO(base64.b64decode(b64))) as img:
        return np.asarray(img.convert("L"), dtype=np.int16)


@pytest.mark.parametrize("attention", [False, True], ids=["noatt", "att"])
def test_predict_matches_jax(attention, monkeypatch):
    jax_engine, port_engine = _jax_and_port_engines(attention, monkeypatch)
    items = _items()
    want = jax_engine.answer_batch(items)
    got = port_engine.answer_batch(items)
    for g, w in zip(got, want):
        assert g["ans"] == w["ans"]
        np.testing.assert_allclose(g["val"], w["val"], rtol=0, atol=1e-5)
        assert len(g["att"]) == len(w["att"]) == (2 if attention else 0)
        for pg, pw in zip(g["att"], w["att"]):
            a, b = _png_pixels(pg), _png_pixels(pw)
            assert a.shape == b.shape == (112, 112)
            assert np.abs(a - b).max() <= 1
    # the single-request path too (bucket 1)
    single = port_engine.answer(items[0]["visual"], items[0]["question"])
    assert single["ans"] == want[0]["ans"]
    np.testing.assert_allclose(single["val"], want[0]["val"], atol=1e-5)


# ------------------------------------------------------------- the server

def _tiny_yaml(tmp_path):
    opt = _options(False)
    opt["logs"]["dir_logs"] = str(tmp_path / "logs")
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(opt))
    return str(path)


def _request(url, payload=None, method=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers, err.read()


@contextlib.contextmanager
def _serving(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield "http://127.0.0.1:%d" % server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_http_round_trip_every_route(tmp_path, monkeypatch):
    """``create_server`` (main's construction, ``--device cpu``, port 0)
    and every route: GET /health, /checkpoints, the web client and a 404,
    OPTIONS, POST /, /batch, /checkpoint (swap, back, unknown)."""
    monkeypatch.setitem(convnets.RESNET_DEPTHS, 50, TINY)
    path = _tiny_yaml(tmp_path)
    root = tmp_path / "runs"
    options = port_config.load_options_file(path)
    base = factory.factory_vqa(options["model"], *synthetic.synthetic_vocab(
        2000, NANS))
    vqa_engine.init_vqa_params(base, seed=0)     # create_server's weights
    _save_run(str(root), "a_original", base)
    with torch.no_grad():
        for p in base.parameters():
            p.mul_(1.5).add_(0.1)
    _save_run(str(root), "b_perturbed", base)
    server = demo_server.create_server([
        "--path_opt", path, "--port", "0", "--device", "cpu",
        "--ckpt_root", str(root), "--serve_web"])
    item = _items(1)[0]
    with _serving(server) as url:
        status, _, body = _request(url + "/health")
        assert status == 200 and json.loads(body) == {"ok": True}
        status, _, body = _request(url + "/checkpoints")
        names = [c["name"] for c in json.loads(body)["checkpoints"]]
        assert names == ["a_original", "b_perturbed"]
        status, headers, body = _request(url + "/")
        assert status == 200 and b"custom.js" in body
        assert headers["Content-Type"] == "text/html"
        status, headers, _ = _request(url + "/custom.js")
        assert headers["Content-Type"] == "application/javascript"
        assert _request(url + "/missing.css")[0] == 404
        assert _request(url + "/../README.md")[0] == 404
        status, headers, _ = _request(url + "/", method="OPTIONS")
        assert status == 200
        assert headers["Access-Control-Allow-Origin"] == "*"
        status, _, body = _request(url + "/", item)
        first = json.loads(body)
        assert status == 200 and len(first["ans"]) == 5
        status, _, body = _request(url + "/batch", {"items": _items(3)})
        batch = json.loads(body)["results"]
        assert len(batch) == 3 and batch[0]["ans"] == first["ans"]
        status, _, body = _request(url + "/checkpoint",
                                   {"name": "b_perturbed"})
        assert status == 200 and json.loads(body)["loaded"]["best"]
        swapped = json.loads(_request(url + "/", item)[2])
        assert swapped["val"] != first["val"]
        _request(url + "/checkpoint", {"name": "a_original"})
        back = json.loads(_request(url + "/", item)[2])
        assert back == first
        status, _, body = _request(url + "/checkpoint", {"name": "nope"})
        assert status == 400 and "unknown checkpoint" in \
            json.loads(body)["error"]
        status, _, body = _request(url + "/", {"question": "no image"})
        assert status == 400


def test_server_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        demo_server.create_server(["--port", "0"])
    assert demo_server.build_parser().parse_args([]).device == "cuda"


# ---------------------------------------- GraphedCall under a fake graph

class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _FakeStream:
    def wait_stream(self, other):
        pass


def _fake_cuda(monkeypatch):
    made, modes = [], []

    class _graph:
        def __init__(self, graph, stream=None, capture_error_mode=None):
            modes.append(capture_error_mode)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def new_graph():
        made.append(_FakeGraph())
        return made[-1]

    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "graph", _graph)
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    return made, modes


def test_graphed_call_captures_once_per_layout(monkeypatch):
    """One graph a layout (warm-up, then capture, in thread-local error
    mode), replays add the capture's launches, outputs are copies, and
    ``exclusive`` blocks calls until it is left."""
    made, modes = _fake_cuda(monkeypatch)
    bodies = []
    name = "kernels.launches.toy_served"

    def launches():
        return spans.counters().get(name, 0)

    def body(inputs):
        bodies.append(1)
        spans.count(name, 2)
        return {"y": inputs["x"] * 2.0}

    run = graphs.GraphedCall(body, "cpu")
    run.capture = True
    x4 = np.arange(4, dtype=np.float32)
    before = launches()
    out = run({"x": x4})
    # warm-up and capture ran the body; the counter shows one replay
    assert len(bodies) == 2 and len(made) == 1 and made[0].replays == 1
    assert launches() - before == 2 and modes == ["thread_local"]
    np.testing.assert_array_equal(out["y"].numpy(), x4 * 2)
    again = run({"x": x4 + 1})
    assert len(bodies) == 2 and made[0].replays == 2
    assert launches() - before == 4
    assert again["y"].data_ptr() != out["y"].data_ptr()   # copied out
    run({"x": np.zeros(8, np.float32)})                     # a new layout
    assert len(made) == 2 and run.n_graphs == 2

    done = threading.Event()
    with run.exclusive():
        t = threading.Thread(target=lambda: (run({"x": x4}), done.set()))
        t.start()
        assert not done.wait(0.3)       # held off while exclusive
    t.join(timeout=30)
    assert done.is_set()
