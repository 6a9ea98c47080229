"""The port's replication runbook
(``vqa_counterexamples_tpu_torch/scripts/replicate_reference.py``) against
the JAX package's ``scripts/replicate_reference.py`` (CPU).

Its rehearsal fixtures are JAX's at the same knobs (every file byte for
byte; the fbresnet ``.pth`` key for key and bit for bit), its knobs are
JAX's ``P`` in both modes (captured by running JAX's ``main`` over one
recording stage), and the two YAMLs it writes are JAX's in both modes.
The whole ``--rehearsal --device cpu`` run goes through the real
subprocess route and ends with ``replication complete``; a rerun skips
every stage.  Over that run's fixtures the JAX package's CLIs of the host
stages (preprocess, port_skipthoughts, build_vqacx) write the same bytes
as the port's.  Every comparison is exact but one: JAX's kNN over the
port's extracted features.  Those features are large (|x|^2 about 2e7)
and the f32 distances' rounding reorders neighbours that lie a few units
apart, differently on each side, so the two lists are held to agree
position by position within ``KNN_TIE``.
"""

import argparse
import filecmp
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from vqa_counterexamples_tpu.cli import build_vqacx as jax_build_vqacx
from vqa_counterexamples_tpu.cli import knn as jax_knn
from vqa_counterexamples_tpu.cli import port_skipthoughts as jax_st
from vqa_counterexamples_tpu.cli import preprocess as jax_preprocess
from vqa_counterexamples_tpu_torch.cli import build_vqacx
from vqa_counterexamples_tpu_torch.scripts import replicate_reference as rr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import replicate_reference as jr  # noqa: E402

STAGE_NAMES = [name for name, _ in rr.STAGES]
# kNN lists of two f32 computations agree where, position by position, the
# neighbours' exact (f64) distances differ by at most 16 units of f32
# roundoff (2^-24) of |q|^2 + max |x|^2: the norm expansion |q|^2 + |x|^2
# - 2 q.x rounds each side at that scale, in another order (up to about
# 5 units seen on the rehearsal's features)
KNN_TIE = 16 * 2.0 ** -24


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def test_stages_and_constants_are_jaxs():
    assert STAGE_NAMES == [name for name, _ in jr.STAGES]
    assert rr.URLS == jr.URLS and rr.MIRRORS == jr.MIRRORS
    assert rr.MIN_SIZES == jr.MIN_SIZES
    assert (rr.N_TRAIN_IMAGES, rr.N_VAL_IMAGES, rr.N_ANSWERS, rr.DIM_Q) \
        == (jr.N_TRAIN_IMAGES, jr.N_VAL_IMAGES, jr.N_ANSWERS, jr.DIM_Q)
    # the full-scale pins sit beside the port's script, not in scripts/
    assert rr.LOCKFILE == os.path.join(
        REPO, "vqa_counterexamples_tpu_torch", "scripts",
        "replicate_reference.lock.json")


def test_fixtures_match_jax(tmp_path):
    P = rr.knobs(str(tmp_path / "port"), rehearsal=True, device="cpu")
    J = rr.knobs(str(tmp_path / "jax"), rehearsal=True)
    rr.stage_rehearsal_fixtures(P, None)
    jr.stage_rehearsal_fixtures(J, None)
    names = _files(P.project_dir)
    assert names == _files(J.project_dir)
    assert len([n for n in names if n.endswith(".jpg")]) == 60
    for name in names:
        got = os.path.join(P.project_dir, name)
        want = os.path.join(J.project_dir, name)
        if name.endswith(".pth"):
            a = torch.load(got, weights_only=True)
            b = torch.load(want, weights_only=True)
            assert list(a) == list(b)
            for key in a:
                assert a[key].dtype == b[key].dtype == torch.float32
                assert torch.equal(a[key], b[key]), key
        else:
            assert filecmp.cmp(got, want, shallow=False), name


def _jax_knobs(monkeypatch, argv):
    """JAX's ``P`` for ``argv``: its ``main`` over one recording stage."""
    seen = {}
    monkeypatch.setattr(jr, "STAGES",
                        [("record", lambda P, lock: seen.update(vars(P)))])
    # its --rehearsal branch flips a global and sets a cache directory
    monkeypatch.setattr(jr, "_FORCE_CPU", False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jr.main(argv + ["--stages", "record"])
    return seen


@pytest.mark.parametrize("rehearsal", [True, False],
                         ids=["rehearsal", "full_scale"])
@pytest.mark.parametrize("official_knn", [False, True],
                         ids=["computed_knn", "official_knn"])
def test_knobs_match_jax(tmp_path, monkeypatch, rehearsal, official_knn):
    project = str(tmp_path / "proj")
    argv = (["--project_dir", project] + ["--rehearsal"] * rehearsal
            + ["--official_knn"] * official_knn)
    want = _jax_knobs(monkeypatch, argv)
    got = vars(rr.knobs(project, rehearsal=rehearsal,
                        official_knn=official_knn, stages="record"))
    assert got.pop("device") == "cuda"
    assert got == want
    # main parses into the same knobs
    parsed = vars(rr.build_parser().parse_args(argv + ["--stages",
                                                       "record"]))
    assert vars(rr.knobs(**parsed)) == {**want, "device": "cuda"}


def test_knob_overrides_come_before_the_paths(tmp_path):
    P = rr.knobs(str(tmp_path), nans=7, extract_size=96, n_train_images=3)
    assert (P.nans, P.extract_size, P.n_train_images) == (7, 96, 3)
    assert os.path.basename(P.processed).startswith("nans,7_")
    assert P.features.endswith("arch,fbresnet152_size,96")
    with pytest.raises(ValueError, match="unknown knobs"):
        rr.knobs(str(tmp_path), n_answers=7)


@pytest.mark.parametrize("rehearsal", [True, False],
                         ids=["rehearsal", "full_scale"])
def test_yamls_match_jax(tmp_path, monkeypatch, rehearsal):
    P = rr.knobs(str(tmp_path / "port"), rehearsal=rehearsal)
    J = rr.knobs(str(tmp_path / "jax"), rehearsal=rehearsal)
    for ns in (P, J):
        os.makedirs(ns.project_dir)
    # JAX writes its CX yaml inside stage_counterexamples: its CLI call
    # is replaced by a results file
    calls = []

    def fake_cli(module, *args):
        calls.append([module] + [str(a) for a in args])
        run = os.path.join(J.project_dir, "logs", "cx", "x_replication")
        os.makedirs(run)
        with open(os.path.join(run, "final_results.txt"), "w") as f:
            f.write('{"loss": 1.0, "recall": 0.5, "recall_1": 0.25, '
                    '"best_epoch": 1}')

    monkeypatch.setattr(jr, "cli", fake_cli)
    J.min_r1 = J.min_r5 = 0.0
    jr.stage_counterexamples(J, None)
    got_vqa = rr.write_vqa_train_yaml(P)
    got_cx = rr.write_cx_yaml(P)
    want = {os.path.basename(got_vqa): jr.write_vqa_train_yaml(J),
            os.path.basename(got_cx): os.path.join(J.project_dir,
                                                   "cx_replication.yaml")}
    for got in (got_vqa, got_cx):
        with open(got) as f:
            text = f.read()
        with open(want[os.path.basename(got)]) as f:
            assert text.replace(P.project_dir, J.project_dir) == f.read()
    (call,) = calls
    assert call[0] == "counterexamples" and "--z_cache" not in call


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """The port's ``--rehearsal --device cpu`` run through the subprocess
    route, then the same command again over its directory."""
    project = str(tmp_path_factory.mktemp("replicate") / "proj")
    cmd = [sys.executable, "-m",
           "vqa_counterexamples_tpu_torch.scripts.replicate_reference",
           "--project_dir", project, "--rehearsal", "--device", "cpu"]
    # one thread a process: the suite's workers share the host's cores,
    # and twelve CLI processes at every core each starve them
    env = dict(os.environ, VQACX_COMPUTE_DTYPE="float32",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    runs = [subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=600) for _ in range(2)]
    for proc in runs:
        assert proc.returncode == 0, (proc.stdout[-4000:] + "\n"
                                      + proc.stderr[-3000:])
    return argparse.Namespace(P=rr.knobs(project, rehearsal=True,
                                         device="cpu"),
                              first=runs[0].stdout, again=runs[1].stdout)


def _stages(out):
    return [line.split(": ", 1)[1] for line in out.splitlines()
            if line.startswith("==== stage: ")]


def _commands(out):
    return [line[2:].split() for line in out.splitlines()
            if line.startswith("+ ")]


def test_rehearsal_runs_every_stage_through_the_clis(rehearsal):
    P, out = rehearsal.P, rehearsal.first
    assert out.rstrip().endswith("replication complete")
    assert _stages(out) == STAGE_NAMES
    commands = _commands(out)
    modules = [c[2].rsplit(".", 1)[1] for c in commands]
    assert modules == ["preprocess", "preprocess", "port_skipthoughts",
                       "extract", "extract", "knn", "knn", "train",
                       "build_answer_embedding", "build_vqacx",
                       "build_vqacx", "counterexamples"]
    for module, argv in zip(modules, commands):
        assert argv[:2] == [sys.executable, "-m"]
        has_device = argv[-2:] == ["--device", "cpu"]
        assert has_device == (module in rr.DEVICE_CLIS), argv
    # the CX stage runs the reference's command, with no --z_cache
    assert commands[-1][3:] == [
        "--cx_model", "NeuralModel", "--epochs", "2", "--path_opt",
        os.path.join(P.project_dir, "cx_replication.yaml"),
        "--project_dir", P.project_dir, "--comment", "replication", "--test",
        "--device", "cpu"]
    assert "FINAL: Recall@1" in out
    (results,) = glob.glob(os.path.join(P.project_dir, "logs", "cx",
                                        "*replication*",
                                        "final_results.txt"))
    assert os.path.isfile(os.path.join(P.dir_logs_vqa,
                                       "best_model.msgpack"))
    with open(os.path.join(P.features, "trainset.txt")) as f:
        assert len(f.read().splitlines()) == P.n_train_images


def test_rehearsal_rerun_skips_every_stage(rehearsal):
    out = rehearsal.again
    assert out.rstrip().endswith("replication complete")
    assert _stages(out) == STAGE_NAMES
    assert _commands(out) == []           # no CLI ran
    assert "dictionary drops" not in out  # no fixture rewritten
    assert "FINAL: Recall@1" in out       # the results verified again


def _hold_knn(got_path, want_path, features_path):
    """The port's kNN json against JAX's within ``KNN_TIE``."""
    with open(got_path) as f:
        got = json.load(f)
    with open(want_path) as f:
        want = json.load(f)
    assert list(got) == list(want)
    feats = np.load(features_path).astype(np.float64)
    sq = (feats ** 2).sum(1)
    dist = sq[:, None] + sq[None] - 2.0 * feats @ feats.T
    swaps = 0
    for key, row in got.items():
        q = int(key) - 1
        assert len(row) == len(want[key]) == 24 and int(key) not in row
        tie = KNN_TIE * (sq[q] + sq.max())
        for a, b in zip(row, want[key]):
            assert abs(dist[q, a - 1] - dist[q, b - 1]) <= tie, (key, a, b)
            swaps += a != b
    # most positions agree outright
    assert swaps <= 0.2 * 24 * len(got), swaps


def test_host_stages_match_jax_clis(rehearsal, tmp_path):
    """JAX's CLIs of the host stages over a copy of the run's raw files
    write the port's bytes; its kNN over the port's extracted features
    agrees within ``KNN_TIE``, and its join over the port's lists gives
    the port's pickles."""
    P = rehearsal.P
    J = rr.knobs(str(tmp_path / "jax"), rehearsal=True)
    shutil.copytree(P.vqa_raw, J.vqa_raw)
    os.makedirs(J.dir_st)
    for name in ("dictionary.txt", "utable.npy", "uni_skip.npz",
                 "uni_skip.npz.pkl"):
        shutil.copyfile(os.path.join(P.dir_st, name),
                        os.path.join(J.dir_st, name))
    os.makedirs(J.features)
    os.makedirs(J.knn_dir)
    for split in ("train", "val"):
        for ext in (".npy", ".txt"):
            shutil.copyfile(os.path.join(P.features, split + "set" + ext),
                            os.path.join(J.features, split + "set" + ext))
    jax_preprocess.main(["interim", "--dir_vqa", J.dir_vqa, "--version",
                         "2"])
    jax_preprocess.main(["processed", "--dirname", J.dir_vqa, "--nans",
                         str(J.nans), "--maxlength", "26", "--minwcount",
                         "0", "--nlp", "mcb", "--pad", "right"])
    jax_st.main(["--dir_st", J.dir_st, "--vocab",
                 os.path.join(J.processed, "wid_to_word.pickle"), "--table",
                 "utable", "--out",
                 os.path.join(J.dir_st, "adapted_uniskip.npz")])
    for split in ("train", "val"):
        name = "computed_%s2014_nn_images.json" % split
        jax_knn.main(["--path_features",
                      os.path.join(J.features, split + "set"), "-k", "25",
                      "--split", split, "--json-out",
                      os.path.join(J.knn_dir, name)])
        _hold_knn(os.path.join(P.knn_dir, name),
                  os.path.join(J.knn_dir, name),
                  os.path.join(P.features, split + "set.npy"))
        # the join itself over the same lists: the port's
        json_in = os.path.join(J.project_dir, name)
        shutil.copyfile(os.path.join(P.knn_dir, name), json_in)
        jax_build_vqacx.main([
            "--split", split, "--path_processed", J.processed,
            "--path_comp_pairs", os.path.join(
                J.vqa_raw, "annotations",
                "v2_mscoco_%s2014_complementary_pairs.json" % split),
            "--path_knn_json", json_in,
            "--path_features_txt",
            os.path.join(J.features, "%sset.txt" % split),
            "--out_dir", J.cx_data])
    compared = []
    for sub in ("data/vqa2/interim", "data/vqa2/processed",
                "data/skip-thoughts/adapted_uniskip.npz", "data/cx"):
        want_root = os.path.join(J.project_dir, sub)
        names = ([os.path.join(sub, n) for n in _files(want_root)]
                 if os.path.isdir(want_root) else [sub])
        for name in names:
            got = os.path.join(P.project_dir, name)
            assert filecmp.cmp(got, os.path.join(J.project_dir, name),
                               shallow=False), got
            compared.append(name)
    assert sum(n.endswith(".pickle") for n in compared) >= 10
    assert {"data/cx/trainset_augmented.pickle",
            "data/cx/valset_augmented.pickle"} <= set(compared)


def test_official_knn_reads_the_distributed_lists(rehearsal, tmp_path):
    """``--official_knn`` joins over ``mscoco_*_nn_images.json``: the
    run's computed lists under those names give the run's pickles."""
    R = rehearsal.P
    P = rr.knobs(str(tmp_path / "proj"), rehearsal=True, official_knn=True,
                 device="cpu")
    P.processed, P.features, P.vqa_raw = R.processed, R.features, R.vqa_raw
    os.makedirs(P.knn_dir)
    for split in ("train", "val"):
        shutil.copyfile(
            os.path.join(R.knn_dir, "computed_%s2014_nn_images.json"
                         % split),
            os.path.join(P.knn_dir, "mscoco_%s2014_nn_images.json" % split))
    calls = []

    def in_process(module, args):
        calls.append(args)
        assert module == "build_vqacx"
        build_vqacx.main(args)

    P.run_cli = in_process
    rr.stage_build_vqacx(P, None)
    assert [os.path.basename(a[a.index("--path_knn_json") + 1])
            for a in calls] == ["mscoco_train2014_nn_images.json",
                                "mscoco_val2014_nn_images.json"]
    for name in _files(R.cx_data):
        if "augmented" in name:
            assert filecmp.cmp(os.path.join(P.cx_data, name),
                               os.path.join(R.cx_data, name),
                               shallow=False), name


def test_download_raises_for_a_missing_file_naming_its_url(tmp_path):
    P = rr.knobs(str(tmp_path / "proj"))
    lock = rr.Lockfile(str(tmp_path / "lock.json"))
    with pytest.raises(FileNotFoundError,
                       match=re.escape(rr.URLS["vqa2"][0])) as err:
        rr.stage_download(P, lock)
    assert "Queue 1 #7" in str(err.value)
    # a skip-thoughts file names its mirror as well
    for group in ("vqa2", "knn", "coco"):
        for url in rr.URLS[group]:
            path = os.path.join({"vqa2": P.vqa_raw, "knn": P.knn_dir,
                                 "coco": P.coco_raw}[group],
                                url.rsplit("/", 1)[1])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with zipfile.ZipFile(path, "w") if path.endswith(".zip") \
                    else open(path, "w"):
                pass
    lock.check = lambda path: None
    with pytest.raises(FileNotFoundError,
                       match=re.escape("data.lip6.fr/cadene/skip-thoughts/"
                                       "dictionary.txt")):
        rr.stage_download(P, lock)
    assert not os.path.exists(str(tmp_path / "lock.json"))


def test_download_pins_and_unzips_without_overwriting(tmp_path,
                                                      monkeypatch):
    base = "http://example.invalid/"
    monkeypatch.setattr(rr, "URLS", {
        "vqa2": [base + "v2_Questions_Train_mscoco.zip"],
        "coco": [base + "train2014.zip"],
        "skipthoughts": [base + "dictionary.txt"]})
    monkeypatch.setattr(rr, "MIN_SIZES", {"dictionary.txt": 4})
    P = rr.knobs(str(tmp_path / "proj"))
    P.n_train_images, P.n_val_images = 2, 0
    ann = os.path.join(P.vqa_raw, "annotations")
    os.makedirs(ann)
    os.makedirs(P.coco_raw)
    os.makedirs(P.dir_st)
    with zipfile.ZipFile(os.path.join(P.vqa_raw,
                                      "v2_Questions_Train_mscoco.zip"),
                         "w") as z:
        z.writestr("a.json", "from the zip")
        z.writestr("b.json", "from the zip")
    with zipfile.ZipFile(os.path.join(P.coco_raw, "train2014.zip"),
                         "w") as z:
        for i in (1, 2):
            z.writestr("train2014/COCO_train2014_%012d.jpg" % i, b"\xff")
    with open(os.path.join(ann, "a.json"), "w") as f:
        f.write("already here")
    with open(os.path.join(P.dir_st, "dictionary.txt"), "w") as f:
        f.write("UNK\nword\n")
    lock_path = str(tmp_path / "lock.json")
    rr.stage_download(P, rr.Lockfile(lock_path))
    with open(os.path.join(ann, "a.json")) as f:
        assert f.read() == "already here"             # unzip -n
    with open(os.path.join(ann, "b.json")) as f:
        assert f.read() == "from the zip"
    assert len(glob.glob(os.path.join(P.coco_raw, "train2014",
                                      "*.jpg"))) == 2
    pins = rr.Lockfile(lock_path).pins
    assert sorted(pins) == ["dictionary.txt", "train2014.zip",
                            "v2_Questions_Train_mscoco.zip"]
    assert pins["dictionary.txt"] == {
        "sha256": rr.sha256(os.path.join(P.dir_st, "dictionary.txt")),
        "size": 9}
    rr.stage_download(P, rr.Lockfile(lock_path))      # the pins hold
    with open(os.path.join(P.dir_st, "dictionary.txt"), "a") as f:
        f.write("drift\n")
    with pytest.raises(AssertionError, match="pinned"):
        rr.stage_download(P, rr.Lockfile(lock_path))
    with open(os.path.join(P.dir_st, "dictionary.txt"), "w") as f:
        f.write("UN")
    with pytest.raises(AssertionError, match="truncated"):
        rr.stage_download(P, rr.Lockfile(lock_path))


def test_cuda_without_a_card_raises_before_any_stage(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    project = tmp_path / "proj"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rr.main(["--project_dir", str(project), "--rehearsal"],
                run_cli=lambda module, args: calls.append(module))
    assert calls == [] and not project.exists()


def test_checks_hold_under_python_O(tmp_path):
    """The stages' checks raise under ``python -O``, which drops
    ``assert``: the acceptance thresholds are never skipped."""
    code = ("import argparse\n"
            "from vqa_counterexamples_tpu_torch.scripts import "
            "replicate_reference as rr\n"
            "P = argparse.Namespace(min_r1=18.4, min_r5=55.1)\n"
            "try:\n"
            "    rr._assert_final_results(P, [%r])\n"
            "except AssertionError as e:\n"
            "    print('raised', e)\n" % str(tmp_path / "final.txt"))
    (tmp_path / "final.txt").write_text(
        '{"loss": 1.0, "recall": 0.5, "recall_1": 0.1, "best_epoch": 1}')
    proc = subprocess.run([sys.executable, "-O", "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "raised Recall@1 10.00 below target 18.4" in proc.stdout
