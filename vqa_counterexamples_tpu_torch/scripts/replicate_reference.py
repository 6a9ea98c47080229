"""Pinned, unattended replication of the reference accuracy numbers through
the port's CLIs (port of the JAX package's ``scripts/replicate_reference.py``,
with its stages, knobs, path layout, lockfile and assertions).

The one number no synthetic run can give is real-data accuracy (NeuralCX
Recall@1 18.47 / Recall@5 55.14, the reference's README.md:34-41).  This
script is the runbook that produces it: every stage is a CLI of the port,
every artifact URL is pinned, checksums are recorded and verified through
a lockfile, intermediate shapes and counts are asserted, and the final
stage asserts the acceptance thresholds.

Requirements: this repo's root as the working directory (the CLIs run as
``python -m vqa_counterexamples_tpu_torch.cli.<module>``), torch, numpy,
PyYAML and PIL; an H100 for the device stages (``--device cpu`` runs them
on the host); about 80 GB of disk for the raw and extracted artifacts.

Usage::

    python -m vqa_counterexamples_tpu_torch.scripts.replicate_reference \\
        --project_dir /data/vqacx [--stages download,preprocess,\\
skipthoughts,extract,knn,train,answer_embedding,build_vqacx,counterexamples] \\
        [--official_knn] [--rehearsal] [--device cuda|cpu]

The download stage does not fetch: it checks the raw files already under
``--project_dir`` (sizes, and sha256 against the lockfile) and unzips the
archives without overwriting (``unzip -n``).  A missing file raises
``FileNotFoundError`` naming its pinned URL (the fetch is ROADMAP.md,
Queue 1 #7).

Stages are idempotent (each checks its outputs first); rerun after a
failure and completed stages are skipped.  ``--official_knn`` uses the
VQA-distributed 24-NN lists (what the paper used,
vqacx_trainset_builder.ipynb cell 11) instead of self-computed kNN.

``--rehearsal`` swaps the download stage for generated miniature fixtures
(tiny COCO-named JPEGs, VQA2-format Q/A/comp-pair JSONs, a fake
skip-thoughts artifact set with a 620-d table and a theano-layout
uni_skip.npz, a torchvision-format fbresnet152 .pth) and drives every
remaining stage through the real STAGES list at scaled dataset sizes,
model widths and acceptance thresholds: the full-scale run's glue on
minutes of compute.

The device CLIs (``extract``, ``knn``, ``train``, ``build_answer_embedding``,
``counterexamples``) get ``--device``; ``cuda`` (the default) must be
visible, or the run stops before its first stage.  Under
``VQACX_COMPUTE_DTYPE=bfloat16`` they run the port's CUDA kernels.

Acceptance (asserted in the final stages, targets from BASELINE.md):
  * VQA2 val OpenEnded acc@1 of the MutanNoAtt pretrain >= 56
    (reference best 58.14 at epoch 39)
  * VQA-CX test Recall@1 >= 18.4, Recall@5 >= 55.1
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import pickle
import subprocess
import sys
import time
import zipfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LOCKFILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "replicate_reference.lock.json")

# ---- pinned artifact URLs -------------------------------------------------
# VQA2 + comp pairs + official KNN lists: the visualqa.org distribution the
# reference's _raw steps fetch (vqa/datasets/vqa.py:151-177; KNN JSONs from
# vqacx_trainset_builder.ipynb cell 11).  COCO images: the 2014 release
# (vqa/datasets/coco.py:35).  Skip-thoughts: the Toronto originals with the
# lip6 mirror skip-thoughts.torch uses.  fbresnet152: the Cadene
# pretrained-models checkpoint (Torch7-ported ResNet-152 the reference
# extracts with, convnets.py:76-80).
URLS = {
    "vqa2": [
        "http://visualqa.org/data/mscoco/vqa/v2_Questions_Train_mscoco.zip",
        "http://visualqa.org/data/mscoco/vqa/v2_Questions_Val_mscoco.zip",
        "http://visualqa.org/data/mscoco/vqa/v2_Annotations_Train_mscoco.zip",
        "http://visualqa.org/data/mscoco/vqa/v2_Annotations_Val_mscoco.zip",
        "http://visualqa.org/data/mscoco/vqa/"
        "v2_Complementary_Pairs_Train_mscoco.zip",
        "http://visualqa.org/data/mscoco/vqa/"
        "v2_Complementary_Pairs_Val_mscoco.zip",
    ],
    "knn": [
        "http://visualqa.org/data/mscoco/vqa/mscoco_train2014_nn_images.json",
        "http://visualqa.org/data/mscoco/vqa/mscoco_val2014_nn_images.json",
    ],
    "coco": [
        "http://msvocds.blob.core.windows.net/coco2014/train2014.zip",
        "http://msvocds.blob.core.windows.net/coco2014/val2014.zip",
    ],
    "skipthoughts": [
        # primary: U. Toronto (rkiros); mirror: data.lip6.fr/cadene
        "http://www.cs.toronto.edu/~rkiros/models/dictionary.txt",
        "http://www.cs.toronto.edu/~rkiros/models/utable.npy",
        "http://www.cs.toronto.edu/~rkiros/models/uni_skip.npz",
        "http://www.cs.toronto.edu/~rkiros/models/uni_skip.npz.pkl",
    ],
    "fbresnet": [
        "http://data.lip6.fr/cadene/pretrainedmodels/"
        "fbresnet152-2e20f6b4.pth",
    ],
}
MIRRORS = {
    "http://www.cs.toronto.edu/~rkiros/models/":
        "http://data.lip6.fr/cadene/skip-thoughts/",
}
# minimum plausible sizes (bytes): catches truncated / HTML-error downloads
MIN_SIZES = {
    "train2014.zip": 12_000_000_000,
    "val2014.zip": 6_000_000_000,
    "utable.npy": 2_000_000_000,
    "uni_skip.npz": 500_000_000,
    "fbresnet152-2e20f6b4.pth": 200_000_000,
    "dictionary.txt": 5_000_000,
    "v2_Questions_Train_mscoco.zip": 20_000_000,
    "v2_Annotations_Train_mscoco.zip": 20_000_000,
    "mscoco_train2014_nn_images.json": 20_000_000,
}
# expected dataset cardinalities (official 2014/VQA2 release counts);
# full-scale defaults for the P.* knobs --rehearsal scales down
N_TRAIN_IMAGES = 82_783
N_VAL_IMAGES = 40_504
N_ANSWERS = 2000
DIM_Q = 2400

# the CLIs that run on a device and take --device
DEVICE_CLIS = ("extract", "knn", "train", "build_answer_embedding",
               "counterexamples")


def subprocess_cli(module, args):
    """The default runner: the CLI as its own process, from the repo's
    root."""
    cmd = [sys.executable, "-m", "vqa_counterexamples_tpu_torch.cli." + module,
           *args]
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=REPO)


def cli(P, module, *args):
    """Run ``module``'s CLI through ``P.run_cli``, with ``--device`` where
    the CLI takes it."""
    args = [str(a) for a in args]
    if module in DEVICE_CLIS:
        args += ["--device", P.device]
    P.run_cli(module, args)


def require(ok, what=""):
    """The runbook's checks, kept under ``python -O`` (which drops
    ``assert``): AssertionError, as the JAX script's asserts raise."""
    if not ok:
        raise AssertionError(what)


def sha256(path, chunk=1 << 22):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


class Lockfile:
    """sha256 pin-on-first-check: the upstream hashes are not published,
    so the FIRST successful run records them here (commit the file) and
    every later run verifies against the recorded pin; drift (a mirror
    swap, a corrupted re-download) fails loudly."""

    def __init__(self, path):
        self.path = path
        self.pins = {}
        if os.path.exists(path):
            with open(path) as f:
                self.pins = json.load(f)

    def check(self, path):
        name = os.path.basename(path)
        size = os.path.getsize(path)
        lo = MIN_SIZES.get(name)
        if lo is not None:
            require(size >= lo, "%s is %d bytes, expected >= %d — "
                    "truncated download?" % (name, size, lo))
        digest = sha256(path)
        if name in self.pins:
            require(self.pins[name]["sha256"] == digest,
                    "%s sha256 %s != pinned %s"
                    % (name, digest, self.pins[name]["sha256"]))
        else:
            self.pins[name] = {"sha256": digest, "size": size}
            with open(self.path, "w") as f:
                json.dump(self.pins, f, indent=2, sort_keys=True)
        print("  ok %-45s %11d bytes  %s" % (name, size, digest[:16]))


# ---- rehearsal fixtures ----------------------------------------------------
# Miniature stand-ins for every artifact stage_download expects, written to
# the same paths with the same formats, so the eight remaining stage
# functions execute their real code against them.  With the same knobs the
# files are the JAX package's, byte for byte (the .pth: the same keys and
# bit-equal tensors).

REHEARSAL_COLORS = ["red", "blue", "green", "yellow", "black", "white",
                    "brown", "pink", "purple", "orange"]
REHEARSAL_RARE = ["magenta", "teal", "maroon", "navy", "olive"]
REHEARSAL_NOUNS = ["cat", "dog", "car", "kite", "boat", "chair", "tree",
                   "sign"]


def _rehearsal_questions(split, n_images, rng):
    """VQA2-format questions/annotations/comp-pairs for ``n_images`` tiny
    images: per image pair, 3 shared-text comp questions with different
    answers; per image, 3 solo questions.  Every ~7th answer comes from the
    rare pool outside the top-nans vocab so the processed stage's OOV-drop
    path executes (vqa_processed.py:34-40 semantics)."""
    questions, annotations, comp_pairs = [], [], []

    def add(qid, image_id, text, answer):
        questions.append({"question_id": qid, "image_id": image_id,
                          "question": text})
        other = REHEARSAL_COLORS[rng.integers(len(REHEARSAL_COLORS))]
        occurrence = [{"answer": answer}] * 8 + [{"answer": other}] * 2
        annotations.append({"question_id": qid,
                            "multiple_choice_answer": answer,
                            "answers": occurrence})

    def pick_answer(k):
        if k % 7 == 3:  # long tail: drops out of the top-nans answer vocab
            return REHEARSAL_RARE[rng.integers(len(REHEARSAL_RARE))]
        return REHEARSAL_COLORS[rng.integers(len(REHEARSAL_COLORS))]

    k = 0
    for a in range(1, n_images + 1, 2):
        b = a + 1
        if b > n_images:  # odd count: the last image gets solo questions only
            break
        for q in range(3):  # complementary: same question, two images
            noun = REHEARSAL_NOUNS[rng.integers(len(REHEARSAL_NOUNS))]
            text = "What color is the %s near the %s ?" % (
                noun, REHEARSAL_NOUNS[rng.integers(len(REHEARSAL_NOUNS))])
            ans_a, ans_b = pick_answer(k), pick_answer(k + 1)
            k += 2
            add(a * 100 + q, a, text, ans_a)
            add(b * 100 + q, b, text, ans_b)
            comp_pairs.append([a * 100 + q, b * 100 + q])
    for i in range(1, n_images + 1):
        for q in range(3, 6):  # solo questions: vocab mass, no complement
            noun = REHEARSAL_NOUNS[rng.integers(len(REHEARSAL_NOUNS))]
            text = "Is the %s %s or %s ?" % (
                noun, REHEARSAL_COLORS[rng.integers(len(REHEARSAL_COLORS))],
                REHEARSAL_COLORS[rng.integers(len(REHEARSAL_COLORS))])
            add(i * 100 + q, i, text, pick_answer(k))
            k += 1
    return questions, annotations, comp_pairs


def _write_fake_fbresnet(path):
    """torchvision-format fbresnet152 state dict with fan-in-scaled random
    weights: every key and shape the loader walks
    (``models/convnets.load_torch_resnet152``), drawn in the JAX package's
    order (conv1, bn1, then its trunk's blocks in their sorted flax names,
    each block's conv/bn pairs, then its downsample pair)."""
    import numpy as np
    import torch

    from vqa_counterexamples_tpu_torch.models import convnets

    with torch.device("meta"):
        model = convnets.factory({"arch": "fbresnet152", "pooling": False})
    weights = {name: tuple(t.shape) for name, t in model.state_dict().items()}
    blocks = sorted({path[0] for path, _ in
                     convnets.flax_conv_names(model.depths)
                     if len(path) == 2})
    rng = np.random.default_rng(7)
    sd = {}

    def conv_t(name):
        co, ci, h, w = weights[name + ".weight"]
        std = (1.0 / (h * w * ci)) ** 0.5
        sd[name + ".weight"] = torch.from_numpy(
            rng.normal(0.0, std, (co, ci, h, w)).astype(np.float32))
        return co

    def bn_t(name, c):
        sd[name + ".weight"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[name + ".bias"] = torch.from_numpy(
            rng.normal(0.0, 0.1, c).astype(np.float32))
        sd[name + ".running_mean"] = torch.from_numpy(
            rng.normal(0.0, 0.1, c).astype(np.float32))
        sd[name + ".running_var"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, c).astype(np.float32))

    bn_t("bn1", conv_t("conv1"))
    for block in blocks:
        stage, index = block[len("layer"):].split("_")
        pre = "layer%s.%s" % (stage, index)
        for i in (1, 2, 3):
            bn_t("%s.bn%d" % (pre, i), conv_t("%s.conv%d" % (pre, i)))
        if pre + ".downsample.0.weight" in weights:
            bn_t(pre + ".downsample.1", conv_t(pre + ".downsample.0"))
    torch.save(sd, path)


def write_fixtures(P, questions=_rehearsal_questions):
    """The miniature raw set under ``P``'s paths: ``P.n_train_images`` /
    ``P.n_val_images`` COCO-named JPEGs, ``questions(split, n_images,
    rng)``'s JSONs, a skip-thoughts set at GRU hidden ``P.dim_q`` and the
    fake fbresnet152 checkpoint."""
    import numpy as np
    from PIL import Image

    ann_dir = os.path.join(P.vqa_raw, "annotations")
    for d in (ann_dir, P.knn_dir, P.dir_st, P.weights_dir,
              os.path.join(P.coco_raw, "train2014"),
              os.path.join(P.coco_raw, "val2014")):
        os.makedirs(d, exist_ok=True)

    # tiny COCO-named JPEGs (mixed portrait/landscape so the Scale +
    # CenterCrop host transform is exercised on both aspect branches)
    rng = np.random.default_rng(0)
    words = set()
    for split, n in (("train", P.n_train_images), ("val", P.n_val_images)):
        sub = os.path.join(P.coco_raw, split + "2014")
        for i in range(1, n + 1):
            h, w = ((96, 80) if i % 2 else (80, 96))
            img = Image.fromarray(
                rng.integers(0, 255, (h, w, 3), dtype=np.uint8), "RGB")
            img.save(os.path.join(sub, "COCO_%s2014_%012d.jpg" % (split, i)))

        qs, annotations, comp = questions(split, n, rng)
        for q in qs:
            words.update(q["question"].replace("?", " ").lower().split())
        base = os.path.join(ann_dir, "v2_%s_mscoco_%s2014_%s.json")
        with open(base % ("OpenEnded", split, "questions"), "w") as f:
            json.dump({"questions": qs}, f)
        with open(os.path.join(
                ann_dir, "v2_mscoco_%s2014_annotations.json" % split),
                "w") as f:
            json.dump({"annotations": annotations}, f)
        with open(os.path.join(
                ann_dir,
                "v2_mscoco_%s2014_complementary_pairs.json" % split),
                "w") as f:
            json.dump(comp, f)

    # skip-thoughts artifact set: dictionary + 620-d table + theano-layout
    # uni_skip GRU at hidden = P.dim_q.  One question word is deliberately
    # left out of the dictionary so the porter's UNK fallback executes.
    dict_words = sorted(words | set(REHEARSAL_COLORS) | set(REHEARSAL_RARE))
    dropped = dict_words.pop()
    dict_words = ["UNK"] + dict_words + ["extra%d" % i for i in range(20)]
    print("rehearsal: dictionary drops %r to exercise the UNK path"
          % dropped)
    with open(os.path.join(P.dir_st, "dictionary.txt"), "w") as f:
        f.write("\n".join(dict_words) + "\n")
    np.save(os.path.join(P.dir_st, "utable.npy"),
            rng.normal(0, 0.1, (len(dict_words), 620)).astype(np.float32))
    h = P.dim_q
    np.savez(os.path.join(P.dir_st, "uni_skip.npz"),
             encoder_W=rng.normal(0, 0.1, (620, 2 * h)).astype(np.float32),
             encoder_U=rng.normal(0, 0.1, (h, 2 * h)).astype(np.float32),
             encoder_b=np.zeros(2 * h, np.float32),
             encoder_Wx=rng.normal(0, 0.1, (620, h)).astype(np.float32),
             encoder_Ux=rng.normal(0, 0.1, (h, h)).astype(np.float32),
             encoder_bx=np.zeros(h, np.float32))
    with open(os.path.join(P.dir_st, "uni_skip.npz.pkl"), "wb") as f:
        pickle.dump({}, f)

    _write_fake_fbresnet(
        os.path.join(P.weights_dir, "fbresnet152-2e20f6b4.pth"))


def stage_rehearsal_fixtures(P, lock):
    """--rehearsal's replacement for stage_download: write the miniature
    fixture set to the exact paths the real download stage checks."""
    marker = os.path.join(P.project_dir, ".rehearsal_fixtures_done")
    if os.path.exists(marker):
        return
    write_fixtures(P)
    with open(marker, "w") as f:
        f.write("ok\n")


# ---- stages ---------------------------------------------------------------

def _unzip_new(path, dest):
    """``unzip -n``: extract the members not already under ``dest``."""
    with zipfile.ZipFile(path) as z:
        for member in z.infolist():
            if not os.path.exists(os.path.join(dest, member.filename)):
                z.extract(member, dest)


def stage_download(P, lock):
    for group, urls in URLS.items():
        dest_dir = {"vqa2": P.vqa_raw, "knn": P.knn_dir, "coco": P.coco_raw,
                    "skipthoughts": P.dir_st,
                    "fbresnet": P.weights_dir}[group]
        # VQA2 zips hold flat JSONs at the zip root, but every consumer
        # reads them from raw/annotations/ (data/interim.py,
        # stage_build_vqacx below): extract there, not into raw/
        unzip_dir = (os.path.join(P.vqa_raw, "annotations")
                     if group == "vqa2" else dest_dir)
        for url in urls:
            name = url.rsplit("/", 1)[-1]
            dest = os.path.join(dest_dir, name)
            if not os.path.exists(dest):
                mirror = MIRRORS.get(url.rsplit("/", 1)[0] + "/")
                raise FileNotFoundError(
                    "%s is not on disk: fetch %s%s to that path (the "
                    "download itself is not ported: ROADMAP.md, Queue 1 #7)"
                    % (dest, url, " (mirror %s%s)" % (mirror, name)
                       if mirror else ""))
            lock.check(dest)
            if name.endswith(".zip"):
                os.makedirs(unzip_dir, exist_ok=True)
                _unzip_new(dest, unzip_dir)
    n_train = len(glob.glob(os.path.join(P.coco_raw, "train2014", "*.jpg")))
    n_val = len(glob.glob(os.path.join(P.coco_raw, "val2014", "*.jpg")))
    require(n_train == P.n_train_images, (n_train, P.n_train_images))
    require(n_val == P.n_val_images, (n_val, P.n_val_images))


def stage_preprocess(P, lock):
    if os.path.exists(os.path.join(P.processed, "trainset.pickle")):
        return
    cli(P, "preprocess", "interim", "--dir_vqa", P.dir_vqa, "--version", 2)
    cli(P, "preprocess", "processed", "--dirname", P.dir_vqa,
        "--nans", P.nans, "--maxlength", 26, "--minwcount", 0,
        "--nlp", "mcb", "--pad", "right")
    # the processed stage writes the examples LIST to trainset.pickle and
    # the vocabs to their own pickles (data/processed.py)
    with open(os.path.join(P.processed, "aid_to_ans.pickle"), "rb") as f:
        vocab_answers = pickle.load(f)
    require(len(vocab_answers) == P.nans, len(vocab_answers))
    with open(os.path.join(P.processed, "trainset.pickle"), "rb") as f:
        examples = pickle.load(f)
    # VQA2 train has 443,757 questions; ~12% have OOV answers and drop
    # (vqa_processed.py:34-40 semantics).  Rehearsal fixtures plant the
    # same structure: a rare-answer tail outside the top-nans that drops.
    require(P.min_train_examples < len(examples) < P.max_train_examples,
            len(examples))


def stage_skipthoughts(P, lock):
    out = os.path.join(P.dir_st, "adapted_uniskip.npz")
    if os.path.exists(out):
        return
    cli(P, "port_skipthoughts", "--dir_st", P.dir_st,
        "--vocab", os.path.join(P.processed, "wid_to_word.pickle"),
        "--table", "utable", "--out", out)
    import numpy as np

    z = np.load(out)
    emb = z[[k for k in z.files if "emb" in k][0]]
    require(emb.shape[1] == 620, emb.shape)


def stage_extract(P, lock):
    for split, n_img in (("train", P.n_train_images),
                         ("val", P.n_val_images)):
        prefix = os.path.join(P.features, "%sset" % split)
        txt = prefix + ".txt"
        if os.path.exists(txt):
            continue
        cli(P, "extract", "--dir_data", P.dir_coco, "--dataset", "coco",
            "--data_split", split, "--arch", "fbresnet152",
            "--mode", "both", "--size", P.extract_size,
            "--batch_size", P.extract_batch,
            "--weights",
            os.path.join(P.weights_dir, "fbresnet152-2e20f6b4.pth"))
        with open(txt) as f:
            names = f.read().splitlines()
        require(len(names) == n_img, (split, len(names), n_img))


def stage_knn(P, lock):
    for split in ("train", "val"):
        out = os.path.join(P.knn_dir,
                           "computed_%s2014_nn_images.json" % split)
        if os.path.exists(out):
            continue
        cli(P, "knn", "--path_features",
            os.path.join(P.features, "%sset" % split),
            "-k", 25, "--split", split, "--json-out", out)
        with open(out) as f:
            lists = json.load(f)
        n = P.n_train_images if split == "train" else P.n_val_images
        require(len(lists) == n, (split, len(lists), n))
        require(len(next(iter(lists.values()))) == 24, split)


def write_vqa_train_yaml(P) -> str:
    """The stock VQA yaml with its repo-relative data paths rewritten to the
    earlier stages' --project_dir outputs (without this the pretrain stage
    cannot find the preprocessed / extracted data, and the pretrained
    skip-thoughts graft in cli/train never fires)."""
    import yaml

    with open(os.path.join(REPO, "configs", "vqa2",
                           "mutan_noatt_train.yaml")) as f:
        opt = yaml.safe_load(f)
    opt["vqa"]["dir"] = P.dir_vqa
    opt["coco"]["dir"] = P.dir_coco
    opt["coco"]["path_features"] = P.features
    opt["model"]["seq2vec"]["dir_st"] = P.dir_st
    if P.rehearsal:
        # scaled model: same architecture and wiring (BayesianUniSkip
        # skip-thoughts GRU + MUTAN fusion + pretrained graft) at minutes
        # of compute.  emb stays 620 (the skip-thoughts table dim the
        # porter asserts); the GRU hidden = P.dim_q matches the fixture's
        # uni_skip.
        opt["vqa"]["nans"] = P.nans
        opt["coco"]["size"] = P.extract_size
        opt["model"]["seq2vec"]["hidden_size"] = P.dim_q
        opt["model"]["fusion"].update(
            dim_q=P.dim_q, dim_hv=32, dim_hq=32, dim_mm=32, R=2)
    path_opt = os.path.join(P.project_dir, "vqa_replication.yaml")
    with open(path_opt, "w") as f:
        yaml.safe_dump(opt, f)
    return path_opt


def stage_train(P, lock):
    best = os.path.join(P.dir_logs_vqa, "best_model.msgpack")
    if not os.path.exists(best):
        cli(P, "train", "--path_opt", write_vqa_train_yaml(P),
            "--dir_logs", P.dir_logs_vqa, "--epochs", P.vqa_epochs,
            "-b", P.vqa_batch)
    # Experiment.to_json layout (core/experiment.py): logged[split][meter]
    # maps epoch -> value; info["val"] carries best_acc1
    with open(os.path.join(P.dir_logs_vqa, "logger.json")) as f:
        exp = json.load(f)
    val = exp.get("logged", {}).get("val", {})
    accs = list(val.get("acc1", {}).values())
    best_acc = max(accs) if accs else exp.get("info", {}).get(
        "val", {}).get("best_acc1")
    require(best_acc is not None, "no val acc1 in logger.json")
    require(best_acc >= P.min_vqa_acc,
            "VQA val acc@1 %.2f < %.1f (reference best 58.14 at epoch 39, "
            "doc/mutan_noatt.html)" % (best_acc, P.min_vqa_acc))


def stage_answer_embedding(P, lock):
    out = os.path.join(P.cx_data, "answer_embedding.pickle")
    if os.path.exists(out):
        return
    os.makedirs(P.cx_data, exist_ok=True)
    # the rewritten yaml, not the stock one: its model widths must match
    # the stage_train checkpoint this stage loads (equal at full scale;
    # only the rewrite is right under --rehearsal's scaled widths)
    cli(P, "build_answer_embedding",
        "--path_opt", write_vqa_train_yaml(P),
        "--path_processed", P.processed, "--dir_logs", P.dir_logs_vqa,
        "--out", out)
    import numpy as np

    with open(out, "rb") as f:
        table = pickle.load(f)
    require(table.shape == (P.nans, P.dim_q), table.shape)
    covered = (np.abs(table).sum(1) > 0).mean()
    # "good answers" = all words in the question vocab; historically ~70%
    require(covered > 0.5, covered)


def stage_build_vqacx(P, lock):
    knn_tpl = (os.path.join(P.knn_dir, "mscoco_%s2014_nn_images.json")
               if P.official_knn else
               os.path.join(P.knn_dir, "computed_%s2014_nn_images.json"))
    for split in ("train", "val"):
        out = os.path.join(P.cx_data, "%sset_augmented.pickle" % split)
        if os.path.exists(out):
            continue
        cli(P, "build_vqacx", "--split", split,
            "--path_processed", P.processed,
            "--path_comp_pairs",
            os.path.join(P.vqa_raw, "annotations",
                         "v2_mscoco_%s2014_complementary_pairs.json"
                         % split),
            "--path_knn_json", knn_tpl % split,
            "--path_features_txt",
            os.path.join(P.features, "%sset.txt" % split),
            "--out_dir", P.cx_data)
    with open(os.path.join(P.cx_data, "trainset_augmented.pickle"),
              "rb") as f:
        ds = pickle.load(f)
    # the comp-pairs x KNN join keeps ~216k of the train pairs at full
    # scale; rehearsal fixtures keep ~3/4 of their comp pairs (24-NN of
    # 31 others)
    require(P.min_cx_examples < len(ds["examples_list"])
            < P.max_cx_examples, len(ds["examples_list"]))
    for ex in ds["examples_list"][:3]:
        require(len(ex["knns"]) == 24
                and 0 <= ex["comp"]["knn_index"] < 24, ex["knns"])


def write_cx_yaml(P) -> str:
    """The stock CX yaml with its data paths rewritten and its VQA
    backbone section taken from :func:`write_vqa_train_yaml`'s (the EXACT
    model stage_train checkpointed: identical to the stock one at full
    scale, required under --rehearsal's scaled widths)."""
    import yaml

    with open(os.path.join(REPO, "configs", "cx",
                           "counterexamples_default.yaml")) as f:
        opt = yaml.safe_load(f)
    opt["logs"]["dir_logs"] = P.dir_logs_vqa
    opt["vqa"]["dir"] = P.dir_vqa
    opt["vqa"]["path_trainset"] = P.cx_data
    opt["coco"]["dir"] = P.dir_coco
    opt["coco"]["path_features"] = P.features
    opt["model"]["seq2vec"]["dir_st"] = P.dir_st
    with open(write_vqa_train_yaml(P)) as f:
        vqa_opt = yaml.safe_load(f)
    opt["model"] = vqa_opt["model"]
    opt["vqa"]["nans"] = vqa_opt["vqa"]["nans"]
    opt["coco"]["size"] = vqa_opt["coco"]["size"]
    if P.rehearsal:
        # dim_a must match the scaled answer-embedding table width
        # (stage_answer_embedding emits (nans, P.dim_q); default 2400)
        opt["cx_model"].update(dim_h=16, dim_a=P.dim_q)
        opt["optim"]["batch_size"] = 16
    path_opt = os.path.join(P.project_dir, "cx_replication.yaml")
    with open(path_opt, "w") as f:
        yaml.safe_dump(opt, f)
    return path_opt


def _cx_results(P):
    return sorted(glob.glob(os.path.join(
        P.project_dir, "logs", "cx", "*replication*", "final_results.txt")))


def stage_counterexamples(P, lock):
    done = _cx_results(P)
    if done:  # idempotent like every other stage: re-verify, don't retrain
        _assert_final_results(P, done)
        return
    path_opt = write_cx_yaml(P)
    # the literal reference repro command (README.md:55-61) + --test
    cli(P, "counterexamples", "--cx_model", "NeuralModel",
        "--epochs", P.cx_epochs,
        "--path_opt", path_opt, "--project_dir", P.project_dir,
        "--comment", "replication", "--test")
    results = _cx_results(P)
    require(results, "no final_results.txt written by --test")
    _assert_final_results(P, results)


def _assert_final_results(P, results):
    # cli/counterexamples.py's final_results.txt: {"loss", "recall"
    # (= recall@5), "recall_1", "best_epoch"}; recalls are fractions
    with open(results[-1]) as f:
        vals = json.load(f)
    r1 = 100.0 * vals["recall_1"]
    r5 = 100.0 * vals["recall"]
    print("FINAL: Recall@1 %.2f (target >= %.1f)  Recall@5 %.2f "
          "(target >= %.1f)" % (r1, P.min_r1, r5, P.min_r5))
    require(0.0 <= r1 <= 100.0 and 0.0 <= r5 <= 100.0 and r5 >= r1,
            (r1, r5))
    require(r1 >= P.min_r1,
            "Recall@1 %.2f below target %.1f" % (r1, P.min_r1))
    require(r5 >= P.min_r5,
            "Recall@5 %.2f below target %.1f" % (r5, P.min_r5))


STAGES = [("download", stage_download), ("preprocess", stage_preprocess),
          ("skipthoughts", stage_skipthoughts), ("extract", stage_extract),
          ("knn", stage_knn), ("train", stage_train),
          ("answer_embedding", stage_answer_embedding),
          ("build_vqacx", stage_build_vqacx),
          ("counterexamples", stage_counterexamples)]


def knobs(project_dir, rehearsal=False, official_knn=False, stages=None,
          device="cuda", **overrides):
    """The run's knobs and paths: the full-scale values, or the rehearsal's
    miniature (the JAX script's ``P``, plus ``device``); ``overrides``
    replace knob values before the paths are derived from them."""
    P = argparse.Namespace(
        project_dir=os.path.abspath(project_dir),
        stages=stages or ",".join(s for s, _ in STAGES),
        official_knn=official_knn, rehearsal=rehearsal, device=device)
    if rehearsal:
        P.n_train_images, P.n_val_images = 32, 28
        P.nans = 10                    # REHEARSAL_COLORS; rare pool drops
        P.dim_q = 64                   # fixture uni_skip GRU hidden
        P.extract_size, P.extract_batch = 64, 16
        P.vqa_epochs, P.vqa_batch = 2, 16
        P.cx_epochs = 2
        P.min_vqa_acc = 0.0            # liveness: the glue, not the science
        P.min_r1, P.min_r5 = 0.0, 0.0
        P.min_train_examples, P.max_train_examples = 20, 1000
        P.min_cx_examples, P.max_cx_examples = 4, 1000
    else:
        P.n_train_images, P.n_val_images = N_TRAIN_IMAGES, N_VAL_IMAGES
        P.nans, P.dim_q = N_ANSWERS, DIM_Q
        P.extract_size, P.extract_batch = 448, 80
        P.vqa_epochs, P.vqa_batch = 40, 512
        P.cx_epochs = 20
        P.min_vqa_acc = 56.0
        P.min_r1, P.min_r5 = 18.4, 55.1
        P.min_train_examples, P.max_train_examples = 350_000, 443_757
        P.min_cx_examples, P.max_cx_examples = 150_000, 300_000
    unknown = set(overrides) - set(vars(P))
    if unknown:
        raise ValueError("unknown knobs %s" % sorted(unknown))
    vars(P).update(overrides)
    P.dir_vqa = os.path.join(P.project_dir, "data", "vqa2")
    P.vqa_raw = os.path.join(P.dir_vqa, "raw")
    P.dir_coco = os.path.join(P.project_dir, "data", "coco")
    P.coco_raw = os.path.join(P.dir_coco, "raw")
    P.knn_dir = os.path.join(P.dir_coco, "knn")
    P.dir_st = os.path.join(P.project_dir, "data", "skip-thoughts")
    P.weights_dir = os.path.join(P.project_dir, "data", "weights")
    P.processed = os.path.join(
        P.dir_vqa, "processed",
        "nans,%d_maxlength,26_minwcount,0_nlp,mcb_pad,right_"
        "trainsplit,train" % P.nans)
    P.features = os.path.join(P.dir_coco, "extract",
                              "arch,fbresnet152_size,%d" % P.extract_size)
    P.dir_logs_vqa = os.path.join(P.project_dir, "logs", "vqa2",
                                  "mutan_noatt_train")
    P.cx_data = os.path.join(P.project_dir, "data", "cx")
    return P


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--project_dir", required=True)
    ap.add_argument("--stages", default=",".join(s for s, _ in STAGES))
    ap.add_argument("--official_knn", action="store_true",
                    help="use the VQA-distributed 24-NN JSONs (the paper's "
                         "configuration) instead of self-computed kNN")
    ap.add_argument("--rehearsal", action="store_true",
                    help="replace the download stage with generated "
                         "miniature fixtures and run every remaining stage "
                         "at scaled-down sizes/thresholds (minutes): the "
                         "full-scale run's exact glue")
    ap.add_argument("--device", default="cuda",
                    help="the device CLIs' --device (default cuda; cpu "
                         "must be asked for)")
    return ap


def main(argv=None, run_cli=None, overrides=None):
    """Run the stages; ``run_cli(module, args)`` runs one CLI (default: a
    subprocess), ``overrides`` replace :func:`knobs`' values.  Returns
    ``P``."""
    import torch

    P = knobs(**vars(build_parser().parse_args(argv)), **(overrides or {}))
    if torch.device(P.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the port runs on the "
                           "card; pass --device cpu to run on the CPU")
    P.run_cli = run_cli or subprocess_cli
    # rehearsal pins land in the project dir (fixtures are per-run random);
    # full-scale pins are committed next to this script
    lock = Lockfile(os.path.join(P.project_dir, "rehearsal.lock.json")
                    if P.rehearsal else LOCKFILE)
    wanted = P.stages.split(",")
    for name, fn in STAGES:
        if name not in wanted:
            continue
        if P.rehearsal and name == "download":
            fn = stage_rehearsal_fixtures
        print("==== stage: %s" % name, flush=True)
        t0 = time.perf_counter()
        fn(P, lock)
        print("  %s: %.2f s" % (name, time.perf_counter() - t0), flush=True)
    print("replication complete", flush=True)
    return P


if __name__ == "__main__":
    main()
