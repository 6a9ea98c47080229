"""Interim dataset builders (port of ``data/interim.py``): flatten the
official VQA / VQA2 (and Visual Genome) JSONs to per-example rows.

As reference ``vqa/datasets/vqa_interim.py`` / ``vqa2_interim.py`` /
``vgenome_interim.py``: rows carry ``question_id, image_name, question``
plus, for annotated splits, ``answer`` (the multiple_choice_answer) and
``answers_occurence`` (``Counter.most_common`` over the 10 human answers,
ties in first-seen order).  VQA 1.0 also keeps ``MC_answer``
(vqa_interim.py:18-34).  The JSON files come out byte for byte as the JAX
package writes them.
"""

from __future__ import annotations

import json
import os
from collections import Counter


def get_subtype(split: str = "train") -> str:
    return split + "2014" if split in ("train", "val") else "test2015"


def get_image_name(subtype: str, image_id: int) -> str:
    return "COCO_%s_%012d.jpg" % (subtype, image_id)


def interim_rows(questions: list, split: str = "train",
                 annotations: list | None = None,
                 keep_mc: bool = False) -> list:
    data = []
    annotations = annotations or []
    for i, q in enumerate(questions):
        row = {
            "question_id": q["question_id"],
            "image_name": get_image_name(get_subtype(split), q["image_id"]),
            "question": q["question"],
        }
        if keep_mc and "multiple_choices" in q:
            row["MC_answer"] = q["multiple_choices"]
        if split in ("train", "val", "trainval"):
            ann = annotations[i]
            row["answer"] = ann["multiple_choice_answer"]
            row["answers_occurence"] = Counter(
                a["answer"] for a in ann["answers"]).most_common()
        data.append(row)
    return data


def vqa_interim(dir_vqa: str, version: int = 2) -> None:
    """Interim JSONs for VQA 1.0 (the MultipleChoice files) or VQA 2.0
    (the OpenEnded files) under ``{dir_vqa}/interim``, from
    ``{dir_vqa}/raw/annotations``; the test splits when their files are
    there."""
    raw = os.path.join(dir_vqa, "raw", "annotations")
    out = os.path.join(dir_vqa, "interim")
    os.makedirs(out, exist_ok=True)
    prefix = "OpenEnded" if version == 2 else "MultipleChoice"
    v2p = "v2_" if version == 2 else ""

    def load(name):
        with open(os.path.join(raw, name)) as f:
            return json.load(f)

    ann_train = load("%smscoco_train2014_annotations.json" % v2p)
    ann_val = load("%smscoco_val2014_annotations.json" % v2p)
    q_train = load("%s%s_mscoco_train2014_questions.json" % (v2p, prefix))
    q_val = load("%s%s_mscoco_val2014_questions.json" % (v2p, prefix))

    keep_mc = version == 1
    data_train = interim_rows(q_train["questions"], "train",
                              ann_train["annotations"], keep_mc)
    data_val = interim_rows(q_val["questions"], "val",
                            ann_val["annotations"], keep_mc)

    def dump(obj, name):
        with open(os.path.join(out, name), "w") as f:
            json.dump(obj, f)

    dump(data_train, "train_questions_annotations.json")
    dump(data_val, "val_questions_annotations.json")
    dump(data_train + data_val, "trainval_questions_annotations.json")

    for split_file, out_name in [
            ("%s%s_mscoco_test2015_questions.json" % (v2p, prefix),
             "test_questions.json"),
            ("%s%s_mscoco_test-dev2015_questions.json" % (v2p, prefix),
             "testdev_questions.json")]:
        path = os.path.join(raw, split_file)
        if os.path.exists(path):
            with open(path) as f:
                qs = json.load(f)
            dump(interim_rows(qs["questions"], "test", None, keep_mc),
                 out_name)


def vgenome_interim(dir_vg: str) -> None:
    """Visual Genome QA pairs -> interim rows (vgenome_interim.py:8-38)."""
    out = os.path.join(dir_vg, "interim")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(dir_vg, "raw", "question_answers.json")) as f:
        qas = json.load(f)
    data = []
    for image in qas:
        for qa in image["qas"]:
            data.append({
                "question_id": qa["qa_id"],
                "image_name": "%d.jpg" % qa["image_id"],
                "question": qa["question"],
                "answer": qa["answer"],
            })
    with open(os.path.join(out, "train_questions_annotations.json"),
              "w") as f:
        json.dump(data, f)
