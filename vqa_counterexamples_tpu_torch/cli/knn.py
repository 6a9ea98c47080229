"""kNN builder CLI (port of ``cli/knn.py``; reference ``knn.py``).

Exact k nearest neighbours over the extracted ``noatt`` feature matrix
(``{prefix}.npy`` + ``{prefix}.txt``), every image against every image,
through ``ops/topk.knn`` (on the card the fused distance + top-k kernel),
and writes:

* ``knn_results.npy``: {'indices', 'distances'} (the reference's artifact,
  ``knn.py:55-58``), and
* with ``--json-out``: the VQA-distributed KNN format the dataset builders
  read, {image_id: [k - 1 neighbour image_ids]}, self dropped::

    python -m vqa_counterexamples_tpu_torch.cli.knn \\
        --path_features data/coco/extract/trainset -k 25 --json-out knn.json

``--engine cuda`` (default; JAX's ``pallas`` names it too) is the kernel,
``plain`` (or ``xla``) its plain version; both take any k up to the
number of images.  The features may be f32 or bf16 (``cli/extract.py
--feat-dtype bfloat16``): they are cast to f32 on the device.  The device
is ``cuda``; with no card visible the CLI refuses to run unless ``--device
cpu`` is given.  ``--mesh data=P`` splits the corpus rows over P ranks
(``ops/topk.knn(mesh=)``: each searches its shard with the kernel, the
candidates merged to the one-rank result), ``--distributed`` runs one
rank of a torchrun launch; rank 0 writes the files.  ``--approx`` is the
TPU's ``approx_max_k`` (recall target 0.999: ``ops/topk.approx_chunk``)
on ``--engine plain`` alone; with the kernel or a mesh it raises
``ValueError`` (JAX's CLI ignores it there).  It is carried for parity
with TPU runs: on an H100 it is both slower and less exact than the
default kernel route (README, the port's ``--approx``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import parallel

# the JAX CLI's engine names
_ENGINE_ALIASES = {"cuda": "cuda", "pallas": "cuda", "plain": "plain",
                   "xla": "plain"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--path_features", required=True, type=str,
                        help="prefix of {prefix}.npy + {prefix}.txt")
    parser.add_argument("--dataset", default="noatt", type=str)
    parser.add_argument("-k", "--n_neighbors", default=25, type=int,
                        help="neighbours per image, self included")
    parser.add_argument("-b", "--batch_size", default=1024, type=int)
    parser.add_argument("--engine", default="cuda",
                        choices=sorted(_ENGINE_ALIASES),
                        help="cuda = the fused distance + top-k kernel; "
                             "plain = one GEMM + topk per chunk")
    parser.add_argument("--approx", action="store_true",
                        help="approximate top-k (the TPU's approx_max_k, "
                             "recall target 0.999; --engine plain only). "
                             "For parity with TPU runs: on an H100 it is "
                             "slower and less exact than the default "
                             "--engine cuda")
    parser.add_argument("--out", default=None, type=str,
                        help="output .npy path (default: alongside features)")
    parser.add_argument("--json-out", default=None, type=str,
                        help="also write VQA-format {image_id: [ids]} json")
    parser.add_argument("--split", default="train", choices=["train", "val"])
    parser.add_argument("--mesh", type=str, default=None,
                        help="split the corpus rows over the ranks of the "
                             "mesh's data axis, e.g. 'data=2'")
    parallel.add_distributed_flag(parser)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu must be asked "
                             "for)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.approx and (_ENGINE_ALIASES[args.engine] != "plain"
                        or args.mesh or args.distributed):
        raise ValueError("--approx runs on --engine plain, with no mesh "
                         "(JAX's CLI ignores it elsewhere)")
    return parallel.run(_run, args, argv, main)


def _run(args, mesh):
    from ..data.features import FeatureStore
    from ..data.vqacx import coco_name_to_num
    from ..ops import topk

    if mesh is not None:
        device = mesh.device
        print("=> Mesh %s: corpus rows split over %d ranks"
              % (mesh.axes, mesh.size("data")))
    else:
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: the port runs on "
                               "the card; pass --device cpu to run on the "
                               "CPU")
    store = FeatureStore.load(args.path_features, dataset=args.dataset)
    print("Loaded %d features of dim %d" % store.features.shape)
    dist, idx = topk.knn(store.to_device(device), k=args.n_neighbors,
                         batch_size=args.batch_size,
                         engine=_ENGINE_ALIASES[args.engine], device=device,
                         mesh=mesh, approx=args.approx)
    if mesh is not None and not mesh.is_main:
        return dist, idx

    out = args.out or (args.path_features + "_knn_results.npy")
    np.save(out, {"indices": idx, "distances": dist})
    print("Saved KNN results to", out)

    if args.json_out:
        table = {}
        for row, name in enumerate(store.names):
            # drop self (rank 0) and keep k - 1 neighbours as image ids
            neigh = [coco_name_to_num(store.names[j])
                     for j in idx[row] if j != row][:args.n_neighbors - 1]
            table[str(coco_name_to_num(name))] = neigh
        with open(args.json_out, "w") as f:
            json.dump(table, f)
        print("Saved VQA-format KNN json to", args.json_out)
    return dist, idx


if __name__ == "__main__":
    main()
