"""Qualitative visualization grids (port of ``viz/grids.py``; reference
``cx_visu.py`` + the --viz path of ``counterexamples.py:393-448``).

``viz_knns``: original image + its 24 candidates tiled, ground-truth
complement framed in green.  ``viz_qa``: original/comp/top-5 candidates with
the VQA model's top-3 answer distributions.  Requires matplotlib + PIL and a
directory of raw COCO jpegs; silently skips examples with missing images
(the reference wraps each grid in try/except, counterexamples.py:440-446).

JAX's ``visualize_results`` is split in two here: :func:`rank_for_viz`
scores the examples with the CX model on its device (the eval step's
inputs: kernels and cache tables as ``engines/cx_engine.eval_model`` uses
them) and :func:`visualize_results` renders the ranking.  Only the render
of each example is wrapped in the reference's ``except``: a failure of the
ranking, or a missing matplotlib, raises.
"""

from __future__ import annotations

import os

import numpy as np


def _load_image(datadir: str, name: str):
    from PIL import Image

    return Image.open(os.path.join(datadir, name)).convert("RGB")


def viz_knns(datadir, img_name, knns, comp, question, answer, knn_size,
             outfile=None):
    """Original + KNN tile grid; green border marks the complement
    (reference cx_visu.py:23-78)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cols = 5
    rows = 1 + (knn_size + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
    fig.suptitle("Q: {}   A: {}".format(question, answer), fontsize=12)
    for ax in axes.flat:
        ax.axis("off")
    axes.flat[0].imshow(_load_image(datadir, img_name))
    axes.flat[0].set_title("original", fontsize=9)
    for i, name in enumerate(knns[:knn_size]):
        ax = axes.flat[cols + i]
        ax.imshow(_load_image(datadir, name))
        ax.set_title("#%d" % (i + 1), fontsize=8)
        if name == comp:
            for spine in ax.spines.values():
                spine.set_edgecolor("green")
                spine.set_linewidth(4)
            ax.axis("on")
            ax.set_xticks([])
            ax.set_yticks([])
    if outfile:
        fig.savefig(outfile, bbox_inches="tight", dpi=60)
        plt.close(fig)
    return fig


def viz_qa(datadir, img_name, knns, comp, question, answer, comp_answer,
           answer_dists, top_k, outfile=None):
    """Original/comp/top-k candidates with top-3 answer strings
    (reference cx_visu.py:81-134)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = 2 + top_k
    fig, axes = plt.subplots(1, n, figsize=(3 * n, 4))
    for ax in axes:
        ax.axis("off")
    axes[0].imshow(_load_image(datadir, img_name))
    axes[0].set_title("orig\nA: {}".format(answer), fontsize=8)
    axes[1].imshow(_load_image(datadir, comp))
    axes[1].set_title("comp\nA: {}".format(comp_answer), fontsize=8)
    for i in range(top_k):
        axes[2 + i].imshow(_load_image(datadir, knns[i]))
        if answer_dists and i < len(answer_dists):
            label = "\n".join("%s %.2f" % (w, s)
                              for w, s in answer_dists[i])
        else:
            label = "#%d" % (i + 1)
        axes[2 + i].set_title(label, fontsize=7)
    fig.suptitle("Q: {}".format(question), fontsize=11)
    if outfile:
        fig.savefig(outfile, bbox_inches="tight", dpi=60)
        plt.close(fig)
    return fig


def rank_for_viz(cx_model, features, arrays, num_images: int, *,
                 extra_apply_args=(), q_table=None, v_table=None,
                 z_table=None, base_seed: int = 123) -> dict:
    """Score the first ``num_images`` examples of ``arrays`` as the eval
    step scores a batch (model in eval mode, the lesion generator seeded
    from (``base_seed``, 0), the table form where the z cache is given and
    the model takes it) -> ``{"scores": (n, K) f32, "order": (n, K)
    candidates best first (``np.argsort(-scores)``, as JAX's), "top_aids"
    / "top_probs": (n, 5, 3) the top-3 answers of the VQA model's softmax
    over each of the 5 best candidates, or None for a model without a
    backbone}`` as numpy arrays."""
    import torch

    from ..core import rng as rng_lib
    from ..data import vqacx
    from ..engines import cx_engine

    device = cx_engine._device(cx_model)
    idx = np.arange(min(num_images, arrays.size))
    batch = cx_engine.batch_to_device(vqacx.gather_batch(arrays, idx),
                                      device)
    gens = rng_lib.StepGenerators(("lesion",), device)
    gens.reseed(base_seed, 0)
    pass_table = cx_engine._pass_table(cx_model, z_table is not None)
    with torch.no_grad():
        cx_model.eval()
        image_features, kw = cx_engine._model_inputs(
            cx_model, features, batch, pass_table, q_table, v_table,
            z_table)
        scores = cx_model(image_features, batch["question_wids"],
                          batch["answer_aids"], *extra_apply_args,
                          lesion_gen=gens["lesion"], **kw).float()
        a_knns = None
        if hasattr(cx_model, "vqa_model"):
            if image_features is None and "z_emb" not in kw:
                image_features = features[batch["image_idxs"].long()]
            _, a_knns, _, _ = cx_model.vqa_forward(
                image_features, batch["question_wids"],
                q_emb=kw.get("q_emb"), v_proj=kw.get("v_proj"),
                z_emb=kw.get("z_emb"))
            a_knns = torch.softmax(a_knns.float(), dim=-1)
    scores = scores.cpu().numpy()
    order = np.argsort(-scores)
    out = {"scores": scores, "order": order, "top_aids": None,
           "top_probs": None}
    if a_knns is not None:
        best = torch.from_numpy(order[:, :5]).to(a_knns.device)
        picked = torch.take_along_dim(a_knns, best[..., None], dim=1)
        probs = picked.cpu().numpy()                     # (n, 5, A)
        top = np.argsort(-probs, axis=-1)[..., :3]
        out["top_aids"] = top
        out["top_probs"] = np.take_along_axis(probs, top, axis=-1)
    return out


def visualize_results(valset, ranking: dict, datadir, viz_dir) -> None:
    """Render both grids for each ranked example (JAX
    ``visualize_results``' render; reference
    ``counterexamples.py:393-448``).  With no raw image directory the
    grids are skipped, as JAX's are."""
    if datadir is None or not os.path.isdir(str(datadir)):
        print("viz: no raw image directory available (%r); skipping grids"
              % (datadir,))
        return
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        raise ImportError("--viz renders its grids with matplotlib, which "
                          "does not import here (%s)" % exc) from exc
    vocab_answers = valset["vocab_answers"]
    for i, order in enumerate(ranking["order"]):
        ex = valset["examples_list"][i]
        knns_sorted = [ex["knns"][j] for j in order]
        dists = None
        if ranking["top_aids"] is not None:
            dists = [[(vocab_answers[t], float(p))
                      for t, p in zip(aids, probs)]
                     for aids, probs in zip(ranking["top_aids"][i],
                                            ranking["top_probs"][i])]
        try:
            viz_knns(datadir, ex["image_name"], knns_sorted,
                     ex["comp"]["image_name"], ex["question"], ex["answer"],
                     len(ex["knns"]),
                     outfile=os.path.join(viz_dir,
                                          "viz_knns_%d.jpg" % i))
            viz_qa(datadir, ex["image_name"], knns_sorted,
                   ex["comp"]["image_name"], ex["question"], ex["answer"],
                   ex["comp"]["answer"], dists, 5,
                   outfile=os.path.join(viz_dir, "viz_qa%d.jpg" % i))
        except Exception as exc:  # reference swallows per-example viz errors
            print("viz: skipped example %d (%s)" % (i, exc))
    print("Saved visualizations to", viz_dir)
