"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports only the port
(``vqa_counterexamples_tpu_torch``), never JAX, and runs under the bf16
policy, where the port's ten CUDA kernels are on the paths.  Any failure
ends the run with a nonzero exit and no result line.

1. Kernels vs plain: builds every kernel library from ``csrc/`` (nvcc,
   sm_90a, one process per source, all at once), runs each kernel at the
   shapes its path gives it and holds it against its plain PyTorch
   version on the same inputs, with the stated tolerances (the GRU
   forwards, the vfeat forward, mixture, MUTAN, the folded forward, the
   three backwards and kNN also against themselves: reruns are
   bit-equal); times both with CUDA events after a warm-up, mixture also
   beside the one library composition that computes its function
   (``torch.softmax(F.linear(z, w, b), dim=1)``), and the vfeat forward
   and backward beside cuBLAS on their two bf16 products, operands
   gathered beforehand (``torch.mm``); neither is called by the port
   (``library_ms``).
2. Scoring at the flagship width (bench.py's configuration: dim_v 2048,
   K 24, BayesianUniSkip 620 -> 2400, MUTAN R 10 at 360, 2000 answers,
   NeuralCX 300 x 2, B 768; synthetic 2048 examples over 1024 images, random
   weights from a seed): builds the q/v/z caches, makes the tables
   bf16-resident and scores every example.  The kernels' launch counters
   are zeroed just before and must all have moved; one batch's scores are
   held against the same computation through the plain versions.
3. Training at the flagship width (dropout 0.25, Adam at 1e-4): the
   caches, then 2 epochs of ``train_epoch`` with a per-epoch
   ``eval_model``, counted (the steps are captured CUDA graphs, as the
   CLI runs them; a replay adds the launches its capture recorded): the
   vfeat forward, vfeat backward and mixture counters must move once per
   step (plus the eval batches), every loss must be finite; one step's
   gradients through the kernels are held against the same step through
   the plain versions (dropout off); the warm train rate.  Then, from one
   starting state with dropout on, an epoch of captured steps against the
   same epoch of eager ones, and through ``make_cx_train_scan`` with S 3
   against the single steps (per-step losses and recall counts, every
   trained parameter and Adam moment: bit-equal), the captured eval pass
   against the eager one (equal results), and the ms a step of each,
   unprofiled and profiled (idle share, kernels and host launches a
   step).
4. The CLI: ``cli.counterexamples.main([... --synthetic 2048 --z_cache
   --epochs 1 --test -b 768])`` in a temporary directory, once as it is
   and once with ``--scan_steps 2``: the checkpoint files, ``best_epoch``
   and the same ``final_results.txt`` from both.
5. VQA pretraining at full width through ``engines/vqa_engine``
   (``configs/vqa2/mutan_noatt_train.yaml``: dim_v 2048, BayesianUniSkip
   620 -> 2400 with per-gate masks, MUTAN R 10 at 360, 2000 answers, B 512,
   Adam at 1e-4; 2048 synthetic examples): 2 epochs with a per-epoch
   ``validate``, counted: the per-gate GRU forward, the GRU backward and
   MUTAN once per train step, the GRU forward and MUTAN once per val
   batch; every loss finite; one step's gradients of every parameter
   through the kernels against the same step through the plain versions,
   dropout on (both draw the same masks); then the warm train and val
   rates; PyTorch's default embedding backward against the port's
   (``models/seq2vec.embedding``) on one batch's word ids, five calls
   each: the port's must give the same bits every call; then an epoch of
   captured steps against eager ones from one starting state, dropout on
   (bit-equal), and the ms a step of each, as in phase 3.
6. The pretraining CLI: ``cli.train.main([... --synthetic 2048 --epochs 1
   -b 512])`` in a temporary directory: the checkpoint files,
   ``logger.json`` and the val result rows.

7. MutanAtt pretraining at full width (``configs/vqa2/mutan_att_train.yaml``:
   14 x 14 maps of 2048, BayesianUniSkip 620 -> 2400 with per-gate masks,
   two glimpses, MUTAN R 5 at 310 / 310 / 510 in the attention and 620 /
   310 / 510 in the fusion, 2000 answers, B 128, Adam at 1e-4; 1024
   synthetic examples over 256 images, their maps gathered on the host into
   pinned buffers): 2 epochs with a per-epoch ``validate``, counted: the
   folded MUTAN forward and backward, the per-gate GRU forward, the GRU
   backward and MUTAN once per train step, the folded forward, the shared
   GRU forward and MUTAN once per val batch; every loss finite; one step's
   gradients through the kernels against the plain versions, dropout on;
   the warm train and val rates; captured against eager steps (bit-equal)
   and their ms a step, as in phase 3.
8. The pretraining CLI with ``mutan_att_train.yaml``: ``--synthetic 1024
   --epochs 1 -b 128``, its files and val rows.
9. The kNN builder at COCO-train scale: 82,783 x 2048 f32 features from the
   seed written as ``.npy`` + ``.txt``, then ``cli.knn.main([... -k 25
   --json-out ...])`` through the kernel, counted; a 1024-query sample of
   its output held against ``knn_chunk_plain``; the build's seconds.

10. The trainable backbone at ``configs/cx/neuralcx_trainable_vqa.yaml``'s
   width, built through ``core/config.resolve_options`` and the factory
   (NeuralCX 1024 x 3, drop_p 0.25, over MutanNoAtt: dim_v 2048,
   BayesianUniSkip 620 -> 2400 with per-gate masks at 0.25, MUTAN R 10 at
   360 with dropout_v / dropout_q 0.5, classifier dropout 0.5, 2000
   answers; the phase-2 data, B 768, Adam at 1e-4 over every parameter,
   no cache): 1 epoch with an eval, counted (per train step the per-gate
   GRU forward, its backward and MUTAN once each, per eval batch the GRU
   forward once); every loss finite; one step's gradients of every
   parameter, the backbone's included, through the kernels against the
   plain versions with dropout on and the same masks (within the larger
   of 5e-2 and twice the plain bf16 path's own distance from the f32
   policy's gradients, logged); an epoch of captured steps against eager
   ones from one starting state and the eval pass both ways (bit-equal);
   the ms a step and an eval batch of each, as in phase 3.
11. The CX zoo: one LinearContext, one PairwiseModel (on a pairwise view,
   K 2) and one contrastive train step at the flagship backbone's width
   over the phase-2 data, B 768, the q / v caches on, two captured steps
   against two eager ones each (bit-equal); then
   ``cli.counterexamples.main([... --synthetic 2048 --epochs 1 --test -b
   768])`` for every other model of ``cx_model_names`` (SemanticBaseline
   with ``--sb_lambda 0.5``, PairwiseModel with ``--pairwise``;
   ContrastiveModel must raise ``ValueError`` there, as in JAX's CLI): the
   files, finite results, ``acc_pairwise`` where pairwise, ``best_epoch``,
   and the GRU forward's counter moving in every q-cache build; then
   ``cli.contrastive.main([... --synthetic 2048 --epochs 1 -b 768])``.
12. The real-data pipeline at full width: a fixture in the real file
   names and layouts, made with numpy from the seed (512 train / 128 val
   COCO-named images with 8 questions each, ten human answers a question,
   more than 2,000 distinct train answers, complementary pairs inside
   feature clusters of 32 images, noatt features and 14 x 14 x 2048 att
   maps, a skip-thoughts set at 620 / 2400), then the port's CLIs in the
   runbook's order (``scripts/replicate_reference.py``), their YAMLs'
   paths rewritten and their widths as published: ``preprocess interim``
   and ``processed`` (nans 2000), ``port_skipthoughts``, ``knn -k 25``
   for train and val, ``train`` with ``mutan_noatt_train.yaml`` (1 epoch,
   B 512; ``eval_res`` scores the val rows), ``build_answer_embedding``
   (held against the same encoder through the plain GRU),
   ``build_vqacx`` for both splits, ``counterexamples --cx_model
   NeuralModel --epochs 1 --test --z_cache`` with
   ``counterexamples_default.yaml`` (the backbone grafted from the
   ``best`` checkpoint and the answer embedding from its pickle, both
   checked bit for bit), ``train`` with ``mutan_att_train.yaml`` (1
   epoch, B 128).  Every stage's launch counts must be exactly its
   steps', batches', chunks' or 128-answer batches'; each stage's seconds
   and the phase's peak allocated memory are logged.  An epoch whose val
   acc@1 stays 0 writes no ``best_*`` (the reference's rule); the phase
   then takes its ``ckpt_*`` as the best, and says so.
13. Extraction and the demo server at full width (random weights from
   the seed): (a) the committed image fixtures
   (``vqa_counterexamples_tpu_torch/data/fixtures/``) decoded at 448 and
   held to their recorded SHA-256 (through PIL: the card's host has no
   libjpeg, ``CARD_HOST_HAS_LIBJPEG``; where it is set the native decoder
   is built and held too); (b) ``cli.extract.main(["--synthetic", "400",
   "-b", "80", "--arch", "fbresnet152", "--size", "448", ...])``: the
   shapes, 400 names, ``.npy`` the spatial mean of ``.att.npy``, the first
   batch bit-equal to a direct trunk call, the CLI's ``stats``; then the
   same over a raw ``train2014/`` of 240 copies of the fixtures (the PNG
   among them); (c) ``serve.demo_server.create_server`` with
   ``mutan_noatt_train.yaml`` (``main``'s default) and with
   ``mutan_att_train.yaml``, ``--prewarm``, the synthetic vocab: six
   captured buckets, each bucket's captured forward bit-equal to the
   eager one on the same models with exactly one launch of the GRU
   forward and of MUTAN a call (and of the folded MUTAN forward with
   MutanAtt), its ms a call captured and eager; ``answer_batch`` of 3
   against ``answer`` of each (vals within 1e-3, top-5 ids equal but
   where near-tied candidates trade places, ``top5_agree``); (d) the
   MutanNoAtt server on 127.0.0.1, port 0: ``/health``,
   ``/checkpoints`` over two runs written by ``save_vqa_checkpoint``,
   POST ``/`` and ``/batch``, ``/checkpoint`` to perturbed weights (the
   answers change) and back (bit-equal to the first), then 16 client
   threads x 8 requests with the batcher off and adaptive (items/s, p50 /
   p99 ms).  The phase's seconds and peak allocated memory are logged.
14. The MLB family, the LSTM encoders and the native feature store, at
   the YAMLs' widths with random weights from the seed (only the amount
   of data is cut): (a) MLBNoAtt at ``configs/vqa2/default.yaml`` (UniSkip
   620 -> 2400, MLB dim_h 1200 with tanh, 2000 answers, B 512, 2048
   synthetic examples): an epoch and a validate counted (the GRU forward
   with h_proj and no mask and the backward with no mask once a train
   step, the forward once a val batch, nothing else), one step's
   gradients through the kernels against the plain versions (phase 5's
   bound), captured against eager steps (bit-equal) with their ms a step,
   device busy, kernels and host launches and the counters held to the
   trace, then ``cli.train`` on ``default.yaml`` and
   ``mlb_noatt_train.yaml``; (d) MLBNoAtt over the LSTM and the 2-LSTM
   encoder at the skip-thoughts widths (620 -> 2400: no published config
   names an LSTM width), B 512, 8 captured steps against 8 eager ones each
   (bit-equal, finite losses, ms a step); (b) MLBAtt at
   ``mlb_att_trainval.yaml`` (BayesianUniSkip, 4 glimpses, dim_h 1200, B
   128) on 1024 examples over 256 maps of 14 x 14 x 2048 written as an
   ``.att.npy`` (411 MB f32) and read through the native store (its
   ``gather_path`` must say so): the checks of (a), then an epoch on the
   bf16 copy of the maps (the uint16 bit-view), then MutanAtt's captured
   step at ``mutan_att_train.yaml`` through the native store and through
   the four-thread numpy gather of the same file, in turns (ms a step),
   and ``cli.train`` on ``mlb_att_trainval.yaml``; (c) NeuralCX at the
   flagship CX width over the MLBNoAtt backbone (phase 2's data, B 768,
   the q / v / z caches, z 1200 wide): the vfeat gate open and the fused
   head's closed by the head's tanh alone, an epoch with an eval counted
   (vfeat, vfeat_bwd and the cache build's GRU forward; no mixture), then
   phase 3's captured-against-eager checks; (e) the demo server over
   MLBNoAtt and MLBAtt (``--prewarm``): buckets 1 and 32 captured against
   eager bit for bit with the GRU forward once a call, ``answer_batch``
   against ``answer`` with a PNG per glimpse, one HTTP round trip each.
15. Runs over several ranks (``parallel/``), every rank on this card:
   (a) NCCL at one rank, in this process (torchrun's environment for
   rank 0 of 1): phase 3's epoch of captured CX steps with the gradients'
   all-reduce captured in the graph against the same epoch with no mesh
   (bit-equal), the eval and the launch counts equal, the host launches a
   step of both (the all-reduce may add at most 2), then
   ``cli.counterexamples --mesh data=1`` (one spawned NCCL rank):
   ``final_results.txt`` bit-equal to phase 4's; (b) gloo, the CX
   flagship (phase 3's data and epoch, dropout on) at ``data=2`` and
   ``data=2,model=2`` (4 spawned ranks, the bf16 feature matrix
   row-sharded over 'model'): every rank's launch counters (GRU forward,
   vfeat forward and backward, mixture), the per-step losses, step 1's
   all-reduced gradients, the eval and the trained parameters held to one
   rank's (``TOL["mesh"]``), the ms of an eager step and of its
   all-reduce alone; (c) ``cli.train --mesh data=2`` (gloo) with
   ``mutan_noatt_train.yaml`` (B 512, 256 a rank) and
   ``mutan_att_train.yaml`` (B 128): every rank's launches of the per-gate
   GRU forward, its backward, MUTAN (and the folded MUTAN pair), the
   logged losses and the val answers against phases 6 and 8; (d)
   ``cli.knn --mesh data=2`` over phase 9's 82,783 x 2048 features (41,392
   and 41,391 rows a rank): the indices, distances and json bit-equal to
   phase 9's, the build's seconds; (e) ``cli.extract --mesh data=2`` on
   160 synthetic images, B 80: the ``.npy``, ``.att.npy`` and ``.txt``
   byte-equal to a one-rank run's.  Ranks that are processes start in
   ``spawn`` mode and import this script as their main module.
16. The JAX package's checkpoint files, viz, ``--approx`` and the
   ablation grid: (a) with a one-rank NCCL group alive in this process,
   phase 3's epoch of captured CX steps with no mesh against eager ones
   (bit-equal, equal evals and launch counts) and a served bucket's
   ``GraphedCall`` against eager (bit-equal, the GRU and MUTAN once);
   (b) ``cli.counterexamples --synthetic 2048 --z_cache -b 768`` trains 2
   epochs, then ``--resume`` runs epoch 3 from the msgpack ``ckpt/``:
   the state it loads bit-equal to the state saved after epoch 2 (every
   parameter, Adam's count and moments, the step), epoch 3 captured, the
   launch counts of both runs exact; (c) ``cli.train`` on MutanNoAtt (B
   512) resumed from its msgpack triple, the loaded state bit-equal to
   the saved one and epoch 2's launches exact; MutanAtt trained by
   ``cli.train`` and served from its triple (``create_server
   --dir_logs``), a bucket's top-5 and maps bit-equal to an engine given
   the trained weights in memory; (d) a reference-named CX state_dict
   (the encoder in the genuine ``BayesianGRUCell``'s per-gate names)
   through ``cli.port_checkpoint --kind cx`` and ``counterexamples
   --init_params``: the CLI starts from exactly those weights, and a
   model loaded from the file scores the val set as the weights loaded
   directly; (e) ``viz/grids.rank_for_viz`` on 200 val examples (vfeat
   and mixture once each) against the eval step's sums on the same
   examples, then the render of two examples' grids, or the
   ``ImportError`` naming matplotlib where the host has none; (f) the
   kNN ``--approx`` route at 82,783 x 2048, k 25 (no kernel: the plain
   scores, 41,472 bins of 2) against the kernel's exact route: recall of
   at least 0.99, the seconds of both; (g) the 19-config ablation grid
   (``scripts/run_ablations``) at 1 epoch and 512 examples, four CLIs at
   once: rc 0 and a finite val loss each.
17. The replication runbook (``scripts/replicate_reference.py``): first
   the kernels at the shapes its ``--rehearsal`` gives them (GRU hidden 64
   at B 16 and B 10, MUTAN 32 / 32 -> 32 at R 2, the CX head over 16 x 24
   candidates at dz 32 and 10 answers, kNN over 32 and 28 rows, k 25),
   each against its plain version with a bit-equal rerun; (a) ``python -m
   vqa_counterexamples_tpu_torch.scripts.replicate_reference --project_dir
   <tmp> --rehearsal`` as a user runs it (``--device cuda``, every CLI its
   own process): rc 0 and ``replication complete``, then the same command
   over the same directory: no CLI runs and the final results are
   verified again; each stage's seconds; (b) its ``main`` in this process
   (``run_cli``: each CLI's ``main``, its launches counted) over a fixture
   in the runbook's layout (``write_fixtures`` with
   ``learnable_questions``: 32 / 28 COCO-named JPEGs, 128 questions an
   image, more than 2,000 train answers, a skip-thoughts set at 2400, the
   fake fbresnet152 ``.pth``) with the full-scale knobs but 32 / 28
   images, 1 VQA and 1 CX epoch and the rehearsal's thresholds: the stock
   YAMLs (nans 2000, GRU 2400, MUTAN 360 / R 10, NeuralCX 300),
   extraction at 448 / B 80 from the ``.pth``; every CLI's launch counts
   exact (kNN once a split; 3f′, 3b and #4 once a train step, 3f and #4
   once a val batch; 3f once per 128 covered answers; the CX CLI's 3f
   once per q-cache build and mixture once per step and eval batch), the
   ``best`` checkpoint written, each stage's seconds and the peak
   allocated memory; then the rerun, which runs no CLI.

Phase 1 also holds the folded MUTAN kernels (forward and backward, each
with a bit-equal rerun) at MutanAtt's attention shape, the kNN kernel at
the builder's, the GRU forward at the val batches' shapes (B 512 and B
128, no mask) and the per-gate forward and the backward at MutanAtt's
batch (B 128), the per-gate forward, the no-mask forward and the
backward at the trainable CX step's B 768 and B 64, and MUTAN at
MutanAtt's classifier shape and over the trainable step's 19,200
duplicated rows (each with a bit-equal rerun, as at B 512), and, at the
demo server's smallest and largest buckets (B 1, B 32), the GRU forward
without a mask, MUTAN at both of its fusion shapes and the folded MUTAN
forward, and UniSkip's training pair (the forward with h_proj out and no
mask, the backward with no mask) at B 512 and B 128; every GRU forward row
logs the tile it launches with.  Phases
3-5, 7 and 10-13 log the peak of allocated device memory.  It prints the card's
name and power limit, a ``{"kernels": [...]}`` line and, last, ``{"ok":
true, "device": {...}}``.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

os.environ["VQACX_COMPUTE_DTYPE"] = "bfloat16"

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
TOL = {
    # GRU states: bf16 state carry, as tests/test_pallas_gru.py bounds it
    "gru": dict(atol=5e-2, rtol=5e-2),
    # vfeat: bf16 GEMM outputs (tests/test_vfeat_kernel.py); dist is f32
    "vfeat_h": dict(atol=3e-2, rtol=3e-2),
    "vfeat_dist": dict(atol=1e-4, rtol=1e-4),
    # vfeat backward: f32 sums over B*K = 18432 rows, in another order
    # than the plain f32 GEMM (g ~ 1e-2, |dW| up to about 6)
    "vfeat_bwd": dict(atol=1e-4, rtol=1e-4),
    # mixture probs: bit-equal.  The kernel keeps the plain version's
    # rounding points (its bf16 pair ops round as f32-then-bf16 does) and
    # its product's k order, so any difference is a fault; a probability
    # is about 5e-4 at A 2000, below any useful atol
    "mixture": dict(atol=0.0, rtol=0.0),
    # GRU backward (dxp, dW, db) relative to each tensor's largest entry:
    # bf16 cotangents from f32 carries summed in another order
    "gru_bwd_rel": 2e-2,
    # MUTAN: f32 sums of exact bf16 products in another order (|out| ~ 10)
    "mutan": dict(atol=1e-3, rtol=1e-4),
    # NeuralCX scores, kernel path vs plain path (tests/test_fused_head.py)
    "scores": dict(atol=5e-2, rtol=5e-2),
    # one train step's grads, kernel path vs plain path, relative to each
    # tensor's largest entry: the vfeat weight grads are f32 sums rounded
    # once to bf16 on both paths, in another order (one bf16 step, 2^-8)
    "grads_rel": 2e-2,
    # one pretraining step's grads, kernel path vs plain path, dropout on:
    # 26 bf16 GRU steps each way, where one rounding flip of a state
    # propagates; the repo's bf16 bound (tests/test_pallas_gru.py)
    "pretrain_grads_rel": 5e-2,
    # the trainable CX step's grads, kernel path vs plain path: where the
    # plain bf16 path is itself far from the f32 policy's grads (a sum of
    # many bf16 softmax-Jacobian terms that cancel, as in the answer
    # head's weight), the two bf16 paths may differ by up to twice that
    # distance; a kernel fault shows beyond it
    "own_bf16": 2.0,
    # folded MUTAN forward: bf16 outputs of f32 sums of the same exact
    # products in another order (|out| ~ 3: one bf16 step either way)
    "attmutan": dict(atol=1e-2, rtol=8e-3),
    # its backward relative to each tensor's largest entry: bf16 dx_v and
    # dhq from f32 sums, f32 dw / db summed over the examples in another
    # order
    "attmutan_bwd_rel": 1e-2,
    # kNN distances (tests/test_pallas_knn.py), and the self-distance: f32
    # cancellation noise of about sqrt(eps |q|^2), some 2e-2 at dim 2048.
    # Where the plain version's f32 GEMM sums in another order than at the
    # builder's shape (a self-kNN over 32 rows), the two self-distances
    # are each sqrt of their own noise, up to 0.075 and 0.031 of an exact
    # 1.5e-6: each is then held to zero instead, within self_zero |q| (the
    # score's noise at most 2^-16 |q|^2; 2^-18 seen at dim 2048)
    "knn": dict(rtol=1e-4, self_atol=2e-2, self_zero=2.0 ** -8),
    # phase 15, ranks against one rank where only the sum order differs
    # (the gradients' all-reduce, the per-rank GEMMs of half the rows):
    # per-step and eval losses, eval recall, the share of val answers that
    # agree; step 1's all-reduced gradients are held to the two halves'
    # sum made in one process ("split_rel": the same kernels on the same
    # rows, added in one f32 sum, so only that sum's order); a trained
    # parameter may differ by 6 lr a step (Adam moves an entry by up to
    # about 3 lr a step while its moments are young, and flips the sign of
    # the move wherever a bf16 gradient's sign is rounding noise)
    "mesh": dict(loss_rel=5e-3, recall_rel=2e-2, adam_lr_steps=6.0,
                 answers=0.98, split_rel=1e-6),
}
# each kernel wrapper (``ops/cuda.launch_counters``) by name: its source
SOURCES = {"gru": "gru", "gru_pg": "gru", "gru_bwd": "gru", "vfeat": "vfeat",
           "vfeat_bwd": "vfeat", "mixture": "mixture", "mutan": "mutan",
           "attmutan": "attmutan", "attmutan_bwd": "attmutan", "knn": "knn"}
REPLACES = {
    "gru": "vqa_counterexamples_tpu/ops/pallas/gru_kernel.py:183",
    "gru_pg": "vqa_counterexamples_tpu/ops/pallas/gru_kernel.py:128",
    "gru_bwd": "vqa_counterexamples_tpu/ops/pallas/gru_kernel.py:423",
    "vfeat": "vqa_counterexamples_tpu/ops/pallas/vfeat_kernel.py:203",
    "vfeat_bwd": "vqa_counterexamples_tpu/ops/pallas/vfeat_kernel.py:166",
    "mixture": "vqa_counterexamples_tpu/ops/pallas/mixture_kernel.py:58",
    "mutan": "vqa_counterexamples_tpu/ops/pallas/mutan_kernel.py:49",
    "attmutan": "vqa_counterexamples_tpu/ops/pallas/attmutan_kernel.py:221",
    "attmutan_bwd":
        "vqa_counterexamples_tpu/ops/pallas/attmutan_kernel.py:180",
    "knn": "vqa_counterexamples_tpu/ops/pallas/knn_kernel.py:91",
}
# H100 SXM5 published peaks (NVIDIA data sheet): dense bf16 and TF32 tensor
# cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
ATT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "vqa2", "mutan_att_train.yaml")
TRAINABLE_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "configs", "cx", "neuralcx_trainable_vqa.yaml")


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check_close(name, got, ref, tol):
    """Max abs / rel error of ``got`` vs ``ref``; raise past ``tol``."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError("%s: shape %s vs %s or non-finite values"
                             % (name, tuple(got.shape), tuple(ref.shape)))
    diff = (got - ref).abs()
    max_abs = diff.max().item()
    max_rel = (diff / ref.abs().clamp_min(1e-6)).max().item()
    bad = (diff > tol["atol"] + tol["rtol"] * ref.abs()).sum().item()
    log("  %-10s max_abs %.3e max_rel %.3e (atol %g, rtol %g): %s"
        % (name, max_abs, max_rel, tol["atol"], tol["rtol"],
           "ok" if bad == 0 else "%d elements out" % bad))
    if bad:
        raise AssertionError("%s disagrees with its plain version" % name)
    return max_abs


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(least ms the card could take, what bounds it): the larger of the
    operations over ``peak`` (the bf16 tensor-core peak unless the kernel
    works in another type) and the bytes over the HBM rate."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def memory_line(card) -> str:
    """The phase's peak of allocated device memory (the counter is reset
    at each phase's start)."""
    return "max_memory_allocated %.1f MiB (%s)" % (
        torch.cuda.max_memory_allocated() / 2 ** 20, card)


def recorded(step, rows, keys):
    """``step`` (a train step or a scan trainer) with its metrics ``keys``
    appended to ``rows``, one (n, len(keys)) tensor a call."""
    def wrapped(*args, **kwargs):
        state, m = step(*args, **kwargs)
        rows.append(torch.stack([torch.as_tensor(m[k]).float().reshape(-1)
                                 .to(m[keys[0]].device) for k in keys], 1))
        return state, m
    return wrapped


def training_tensors(model, optimizer):
    """``(name, tensor)`` of every parameter the optimizer trains, then of
    its Adam moments (``<name>/exp_avg``, ``<name>/exp_avg_sq``)."""
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return ([(names[id(p)], p) for p in params]
            + [("%s/%s" % (names[id(p)], k), optimizer.state[p][k])
               for p in params for k in ("exp_avg", "exp_avg_sq")])


def hold_equal(what, run_a, run_b):
    """Two runs from one starting state, each ``(rows, model,
    optimizer)``: the per-step metrics and the trained tensors must be
    bit-equal."""
    rows_a, rows_b = (torch.cat(r[0]).cpu() for r in (run_a, run_b))
    tens_a, tens_b = (training_tensors(*r[1:]) for r in (run_a, run_b))
    if rows_a.shape != rows_b.shape or [n for n, _ in tens_a] != [
            n for n, _ in tens_b]:
        raise AssertionError("%s: the runs differ in shape" % what)
    differ = ["%s %.2e" % (name, (a.float() - b.float()).abs().max().item())
              for (name, a), (_, b) in zip(tens_a, tens_b)
              if not torch.equal(a, b)]
    rows_ok = torch.equal(rows_a, rows_b)
    log("  %s: %d steps' metrics (largest difference %.3e), %d trained "
        "tensors (parameters, Adam moments): %s"
        % (what, rows_a.shape[0], (rows_a - rows_b).abs().max().item(),
           len(tens_a), "bit-equal" if not differ else
           "DIFFERENT: %s" % ", ".join(differ)))
    if differ or not rows_ok:
        raise AssertionError("%s: not bit-equal" % what)


# each wrapper's kernels in a profiler trace: a name that its kernel
# launches carry, and the launches a call makes ("T": one a timestep)
TRACED = {"gru": ("gru_fwd_step_kernel<1,", "T"),
          "gru_pg": ("gru_fwd_step_kernel<3,", "T"),
          "gru_bwd": ("gru_bwd_step_kernel<", "T"),
          "vfeat": ("vfeat_fwd_kernel<", 1),
          "vfeat_bwd": ("vfeat_bwd_kernel<", 1),
          "mixture": ("::mixture_kernel<", 1),
          "mutan": ("::mutan_fwd_kernel<", 1),
          "attmutan": ("attmutan_fwd_kernel<", 1),
          "attmutan_bwd": ("attmutan_bwd_dx_kernel<", 1),
          "knn": ("knn_merge_kernel", 1)}


def step_profile(label, run_pass, passes, per_pass, card, seq_len=0):
    """Unprofiled ms a step and the profiled breakdown of ``passes`` calls
    of ``run_pass`` (``per_pass`` steps each) after a warm call, logged.
    The launch counters must agree with the trace: each wrapper's count
    over the timed and the profiled calls is twice the launches of its
    kernel that the profiler saw (per call, ``seq_len`` for the GRU's
    per-timestep launches).  The trace can lose a kernel's record (on an
    H100 a captured MutanAtt step, whose kernels are fixed, read 627.38,
    627.44 and 627.50 kernels a step in three runs): where it holds fewer
    launches than the counters, the calls are timed and profiled once
    more, and that profile must agree exactly."""
    from vqa_counterexamples_tpu_torch.cli.profile_cx import profile_calls

    run_pass()   # warm: builds, captures
    per_call = {k: seq_len if per == "T" else per
                for k, (_, per) in TRACED.items()}
    for attempt in (1, 2):
        before = read_counters()
        r = profile_calls(run_pass, passes, per_pass)
        counted = {k: n - before[k] for k, n in read_counters().items()}
        seen = {k: sum(n for name, n in r["kernel_launches"].items()
                       if pattern in name)
                for k, (pattern, _) in TRACED.items()}
        bad = [k for k in TRACED if 2 * seen[k] != per_call[k] * counted[k]
               or (counted[k] and not per_call[k])]
        if not bad:
            break
        if attempt == 1 and all(2 * seen[k] < per_call[k] * counted[k]
                                for k in bad):
            log("  %s: the trace holds fewer launches of %s than the "
                "counters (%s against %s): timing and profiling again"
                % (label, bad, {k: seen[k] for k in bad},
                   {k: counted[k] for k in bad}))
            continue
        raise AssertionError("%s: launch counters %s over the timed and the "
                             "profiled calls, the trace's kernels %s"
                             % (label, counted, seen))
    log("  %s: %.3f ms a step unprofiled (host %.3f, drain %.3f ms); "
        "profiled %.3f ms a step, device busy %.3f ms, idle share %.1f%%; "
        "%.2f kernels and %.2f host launches a step %s; the launch "
        "counters agree with the trace's port kernels %s (%s)"
        % (label, r["wall_ms"], r["host_ms"], r["drain_ms"] / (
            passes * per_pass), r["wall_ms_profiled"], r["device_busy_ms"],
           100 * r["idle_share_profiled"], r["launches"],
           r["host_launches"], r["host_launches_by_call"],
           {k: n for k, n in seen.items() if n}, card))
    return r


def build_all():
    """Build every kernel library from the sources, one nvcc each, all at
    once."""
    from vqa_counterexamples_tpu_torch.ops.cuda import build

    names = sorted(set(SOURCES.values()))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(build.build, names)))
    log("  built %s in %.1f s (in parallel)"
        % (", ".join(p.name for p in paths.values()),
           time.perf_counter() - t0))
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("    %s: %s" % (name, line.strip()))


def phase_kernels(dev, card):
    from vqa_counterexamples_tpu_torch.ops.cuda import (
        mixture_kernel, vfeat_kernel)

    log("== phase 1: kernels vs plain at the main path's shapes")
    build_all()
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    rows = {}
    # A: GRU recurrence, the q-cache build (one call for 2048 questions)
    T, B, H = 26, 2048, 2400
    xp, w_hh = randn(T, B, 3 * H), randn(3 * H, H, scale=H ** -0.5)
    b_hh = randn(3 * H, scale=0.1, dtype=torch.float32)
    rows["gru"] = gru_fwd_row("gru", xp, w_hh, b_hh, None, False)
    del xp
    # B: candidate image features, one train / eval batch, both directions
    N, DV, B, K, HID = 1024, 2048, 768, 24, 300
    table = randn(N, DV)
    idx = torch.randint(0, N, (B, K + 1), generator=gen, device=dev,
                        dtype=torch.int32)
    w_o, w_m = randn(HID, DV, scale=DV ** -0.5), randn(HID, DV,
                                                       scale=DV ** -0.5)
    h1, d1 = vfeat_kernel.vfeat_scores(table, idx, w_o, w_m)
    h2, d2 = vfeat_kernel.vfeat_scores_plain(table, idx, w_o, w_m)
    err = max(check_close("vfeat h", h1, h2, TOL["vfeat_h"]),
              check_close("vfeat dist", d1, d2, TOL["vfeat_dist"]))
    again = vfeat_kernel.vfeat_scores(table, idx, w_o, w_m)
    if not (torch.equal(h1, again[0]) and torch.equal(d1, again[1])):
        raise AssertionError("vfeat: a rerun on the same inputs differs")
    log("  vfeat      rerun on the same inputs: bit-equal")
    # the yardstick for both directions: cuBLAS on the kernels' two bf16
    # products, operands gathered beforehand (the port never calls it)
    x = table[idx[:, 1:].long()].reshape(-1, DV)
    m = (x.view(B, K, DV) * table[idx[:, 0].long()][:, None]).reshape(-1, DV)
    rows["vfeat"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: vfeat_kernel.vfeat_scores(table, idx, w_o, w_m),
                   reps=20),
        plain_ms=time_ms(lambda: vfeat_kernel.vfeat_scores_plain(
            table, idx, w_o, w_m)),
        library_ms=time_ms(lambda: (torch.mm(x, w_o.t()),
                                    torch.mm(m, w_m.t())), reps=20),
        work=(4 * B * K * DV * HID,
              N * DV * 2 + B * (K + 1) * 4 + 2 * HID * DV * 2
              + B * K * HID * 2 + B * K * 4))
    g = randn(B, K, HID, scale=1e-2)
    dwo, dwm = vfeat_kernel.vfeat_weight_grads(table, idx, g)
    ro, rm = vfeat_kernel.vfeat_weight_grads_plain(table, idx, g)
    err = max(check_close("vfeat dWo", dwo, ro, TOL["vfeat_bwd"]),
              check_close("vfeat dWm", dwm, rm, TOL["vfeat_bwd"]))
    again = vfeat_kernel.vfeat_weight_grads(table, idx, g)
    if not (torch.equal(dwo, again[0]) and torch.equal(dwm, again[1])):
        raise AssertionError("vfeat_bwd: a rerun on the same inputs "
                             "differs")
    log("  vfeat_bwd  rerun on the same inputs: bit-equal")
    g2 = g.reshape(-1, HID)
    rows["vfeat_bwd"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: vfeat_kernel.vfeat_weight_grads(table, idx, g),
                   reps=20),
        plain_ms=time_ms(lambda: vfeat_kernel.vfeat_weight_grads_plain(
            table, idx, g)),
        library_ms=time_ms(lambda: (torch.mm(g2.t(), x),
                                    torch.mm(g2.t(), m)), reps=20),
        work=(4 * B * K * DV * HID,
              N * DV * 2 + B * (K + 1) * 4 + B * K * HID * 2
              + 2 * HID * DV * 4))
    # C: answer head + softmax over every candidate row of a batch
    M, DZ, A = B * K, 360, 2000
    z, w_cls, b_cls = randn(M, DZ), randn(A, DZ, scale=DZ ** -0.5), randn(A)
    p1 = mixture_kernel.classify_softmax(z, w_cls, b_cls)
    p2 = mixture_kernel.classify_softmax_plain(z, w_cls, b_cls)
    err = check_close("mixture", p1, p2, TOL["mixture"])
    again = mixture_kernel.classify_softmax(z, w_cls, b_cls)
    if not torch.equal(p1, again):
        raise AssertionError("mixture: a rerun on the same inputs differs")
    log("  mixture    rerun on the same inputs: bit-equal")
    rows["mixture"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: mixture_kernel.classify_softmax(z, w_cls, b_cls),
                   reps=20),
        plain_ms=time_ms(lambda: mixture_kernel.classify_softmax_plain(
            z, w_cls, b_cls), reps=20),
        # the yardstick: one bf16 linear and ATen's softmax (the port
        # never calls it; it rounds the row sum's reciprocal elsewhere)
        library_ms=time_ms(lambda: torch.softmax(
            torch.nn.functional.linear(z, w_cls, b_cls), dim=1), reps=20),
        work=(2 * M * DZ * A, (M * DZ + A * DZ + A + M * A) * 2))
    del again
    del z, w_cls, b_cls, p1, p2
    rows.update(pretrain_kernel_rows(dev, gen, randn))
    rows.update(att_knn_kernel_rows(dev, gen, randn))
    rows.update(serve_kernel_rows(dev, gen, randn))
    log_rows(rows, card)
    return rows


def log_rows(rows, card):
    """Each row's bound from its work, logged beside its times."""
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"] = bound(*row.pop("work"))
        lib = ("  library %.3f ms" % row["library_ms"]
               if "library_ms" in row else "")
        log("  %-9s kernel %.3f ms  plain %.3f ms%s  bound %.4f ms (%s)  (%s)"
            % (name, row["ms"], row["plain_ms"], lib, row["bound_ms"],
               row["bound_by"], card))


def rel_err(name, got, ref, rel):
    """Max abs error of ``got`` vs ``ref`` as a share of ref's largest
    entry; raise past ``rel``."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError("%s: shape %s vs %s or non-finite values"
                             % (name, tuple(got.shape), tuple(ref.shape)))
    max_abs = (got - ref).abs().max().item()
    err = max_abs / max(ref.abs().max().item(), 1e-30)
    log("  %-10s max_abs %.3e = %.3e of the largest entry (bound %g): %s"
        % (name, max_abs, err, rel, "ok" if err <= rel else "out"))
    if err > rel:
        raise AssertionError("%s disagrees with its plain version" % name)
    return max_abs


def gru_bwd_row(name, randn, xp, w_hh, mask, states, hproj):
    """The GRU backward against its plain version at (T, B, H) (dxp, dW, db
    within the stated share of each tensor's largest entry), a bit-equal
    rerun, and both timed."""
    from vqa_counterexamples_tpu_torch.ops.cuda import gru_kernel

    T, B, H = states.shape
    ds = randn(T, B, H)
    args = (xp, w_hh, mask, states, hproj, ds)
    got = gru_kernel.gru_recurrence_bwd(*args)
    ref = gru_kernel.gru_recurrence_bwd_plain(*args)
    err = max(rel_err(name + " " + n, g, r, TOL["gru_bwd_rel"])
              for n, g, r in zip(("dxp", "dW", "db"), got, ref))
    again = gru_kernel.gru_recurrence_bwd(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("%s: a rerun on the same inputs differs" % name)
    log("  %-10s rerun on the same inputs: bit-equal" % name)
    del got, ref, again
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: gru_kernel.gru_recurrence_bwd(*args)),
        plain_ms=time_ms(lambda: gru_kernel.gru_recurrence_bwd_plain(*args),
                         reps=2),
        # the in-kernel back product (T - 1 steps) and the dW product;
        # xp, h_proj, states, dstates, mask, W read, dxp, dW, db written
        work=(2 * (T - 1) * B * 3 * H * H + 2 * T * B * 3 * H * H,
              T * B * 3 * H * 2 * 3 + T * B * H * 2 * 2
              + (0 if mask is None else mask.numel() * 2)
              + 3 * H * H * 2 * 2 + 3 * H * 4))


def gru_fwd_row(name, xp, w_hh, b_hh, mask, want_hproj):
    """The GRU forward against its plain version (states, and h_proj when
    asked for), a bit-equal rerun, the tile it launches with (at H 2400
    the TMA one), and both timed."""
    from vqa_counterexamples_tpu_torch.ops.cuda import gru_kernel

    T, B, H3 = xp.shape
    H = H3 // 3
    tile = gru_kernel.forward_tile(xp, w_hh, b_hh, mask)
    log("  %-10s T %d B %d H %d, %s mask: tile %s" % (
        name, T, B, H, "no" if mask is None else
        "per-gate" if mask.dim() == 3 else "shared", tuple(tile)))
    if H % 8 == 0 and not tile.tma:
        raise AssertionError("%s: H %d should take the TMA tile" % (name, H))
    args = (xp, w_hh, b_hh, mask, want_hproj)
    got = gru_kernel.gru_recurrence(*args)
    ref = gru_kernel.gru_recurrence_plain(*args)
    err = check_close(name, got[0], ref[0], TOL["gru"])
    if want_hproj:
        err = max(err, check_close(name + " hp", got[1], ref[1], TOL["gru"]))
    again = gru_kernel.gru_recurrence(*args)
    if not all(a is None or torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("%s: a rerun on the same inputs differs" % name)
    log("  %-10s rerun on the same inputs: bit-equal" % name)
    del got, ref, again
    ng = 0 if mask is None else mask.numel() // (B * H)
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: gru_kernel.gru_recurrence(*args)),
        plain_ms=time_ms(lambda: gru_kernel.gru_recurrence_plain(*args),
                         reps=2),
        # the product of steps 1..T-1 (h_{-1} = 0: step 0 has none); xp,
        # W, b, the masks read; the states (and h_proj) written
        work=(2 * (T - 1) * B * H * 3 * H,
              (T * B * 3 * H + 3 * H * H + ng * B * H + T * B * H
               + (T * B * 3 * H if want_hproj else 0)) * 2 + 3 * H * 4))


def check_rerun(name, first, again):
    """A kernel's rerun on the same inputs gives the same bits (its sums
    have one order, and no atomics)."""
    if not torch.equal(first, again):
        raise AssertionError("%s: a rerun on the same inputs differs" % name)
    log("  %-10s rerun on the same inputs: bit-equal" % name)


def pretrain_kernel_rows(dev, gen, randn):
    """Phase 1's rows for the pretraining kernels at its shapes: the
    per-gate GRU forward and the GRU backward (T 26, B 512, H 2400; the
    backward also at MutanAtt's B 128), MUTAN (B 512, dh 360, R 10, dmm
    360)."""
    from vqa_counterexamples_tpu_torch.ops.cuda import gru_kernel

    rows = {}
    T, B, H = 26, 512, 2400
    xp, w_hh = randn(T, B, 3 * H), randn(3 * H, H, scale=H ** -0.5)
    b_hh = randn(3 * H, scale=0.1, dtype=torch.float32)
    keep = torch.rand(3, B, H, generator=gen, device=dev) < 0.75
    mask = (keep * (256.0 / 192)).to(torch.bfloat16)
    rows["gru_pg"] = gru_fwd_row("gru_pg", xp, w_hh, b_hh, mask, True)
    # MutanNoAtt's val batch: the shared forward without a mask (logged,
    # outside the kernels line, as are the B 128 rows below)
    rows["gru_b512"] = gru_fwd_row("gru B512", xp, w_hh, b_hh, None, False)
    s1, h1 = gru_kernel.gru_recurrence(xp, w_hh, b_hh, mask, want_hproj=True)
    rows["gru_bwd"] = gru_bwd_row("gru_bwd", randn, xp, w_hh, mask, s1, h1)
    del s1, h1
    # UniSkip's training pair (MLBNoAtt, phase 14a): the forward with
    # h_proj out and no mask, then the backward with no mask
    rows.update(no_mask_pair_rows(randn, xp, w_hh, b_hh, 512))
    del xp, mask
    # the same at MutanAtt's batch: its train step's per-gate forward and
    # backward, its val batch's forward
    B = 128
    xp = randn(T, B, 3 * H)
    keep = torch.rand(3, B, H, generator=gen, device=dev) < 0.75
    mask = (keep * (256.0 / 192)).to(torch.bfloat16)
    rows["gru_pg_b128"] = gru_fwd_row("gru_pg B128", xp, w_hh, b_hh, mask,
                                      True)
    rows["gru_b128"] = gru_fwd_row("gru B128", xp, w_hh, b_hh, None, False)
    s1, h1 = gru_kernel.gru_recurrence(xp, w_hh, b_hh, mask, want_hproj=True)
    rows["gru_bwd_att"] = gru_bwd_row("gru_bwd B128", randn, xp, w_hh, mask,
                                      s1, h1)
    del s1, h1
    rows.update(no_mask_pair_rows(randn, xp, w_hh, b_hh, 128))
    del xp, mask
    # the trainable CX step's batches (B 768 here, the CLI's default B 64):
    # its per-gate forward and backward, its eval batch's forward
    for B in (768, 64):
        xp = randn(T, B, 3 * H)
        keep = torch.rand(3, B, H, generator=gen, device=dev) < 0.75
        mask = (keep * (256.0 / 192)).to(torch.bfloat16)
        rows["gru_pg_b%d" % B] = gru_fwd_row("gru_pg B%d" % B, xp, w_hh,
                                             b_hh, mask, True)
        rows["gru_b%d" % B] = gru_fwd_row("gru B%d" % B, xp, w_hh, b_hh,
                                          None, False)
        s1, h1 = gru_kernel.gru_recurrence(xp, w_hh, b_hh, mask,
                                           want_hproj=True)
        rows["gru_bwd_b%d" % B] = gru_bwd_row("gru_bwd B%d" % B, randn, xp,
                                              w_hh, mask, s1, h1)
        del xp, s1, h1, mask
    # MutanNoAtt's batch, and the trainable CX step's duplicated fusion
    # over B 768 x 25 candidates (logged outside the kernels line)
    for name, B in (("mutan", 512), ("mutan_b19200", 768 * 25)):
        rows[name] = mutan_row(name, randn, B, 360, 360, 10, 360)
    return rows


def no_mask_pair_rows(randn, xp, w_hh, b_hh, batch):
    """The GRU forward with h_proj out and no mask, and the backward with
    no mask (UniSkip's training path), at (T, ``batch``, H): each against
    its plain version, a bit-equal rerun, timed, with its bound."""
    from vqa_counterexamples_tpu_torch.ops.cuda import gru_kernel

    rows = {"gru_hp_b%d" % batch: gru_fwd_row(
        "gru_hp B%d" % batch, xp, w_hh, b_hh, None, True)}
    s1, h1 = gru_kernel.gru_recurrence(xp, w_hh, b_hh, None, want_hproj=True)
    rows["gru_bwd_nm_b%d" % batch] = gru_bwd_row(
        "gru_bwd nm B%d" % batch, randn, xp, w_hh, None, s1, h1)
    return rows


def check_knn(name, dist, idx, ref_dist, ref_idx, self_idx=None,
              qnorm=None):
    """The kernel's (dist, idx) (Bq, k) against the plain version's with one
    more neighbour (Bq, k + 1): distances within the stated tolerance, the
    same neighbour wherever it is further than twice that from both of
    its neighbours in the plain ranking, and rank 0 the query itself when
    ``self_idx`` is given.  With ``qnorm`` (the queries' |q|), the
    self-distance of each side is held to zero within ``self_zero`` |q|
    instead of to the other's.  Returns the max abs distance error."""
    k = dist.shape[1]
    tol = TOL["knn"]["rtol"] * ref_dist.abs()
    tol[:, 0] += (TOL["knn"]["self_atol"] if qnorm is None
                  else float("inf"))
    zero_ok = True
    if qnorm is not None:
        worst = max((d[:, 0] / qnorm).max().item() for d in (dist, ref_dist))
        zero_ok = worst <= TOL["knn"]["self_zero"]
        log("  %-10s self-distances at most %.3e |q| on both routes (bound "
            "%g |q|): %s" % (name, worst, TOL["knn"]["self_zero"],
                             "ok" if zero_ok else "out"))
    err = (dist - ref_dist[:, :k]).abs()
    held = err if qnorm is None else err[:, 1:]
    gap = ref_dist[:, 1:] - ref_dist[:, :-1]             # (Bq, k)
    prev = torch.cat([torch.full_like(gap[:, :1], float("inf")),
                      gap[:, :-1]], 1)
    clear = (gap > 2 * tol[:, 1:]) & (prev > 2 * tol[:, :k])
    same = (idx == ref_idx[:, :k]) | ~clear
    ok_self = self_idx is None or torch.equal(idx[:, 0].long(),
                                              self_idx.long())
    bad = int((err > tol[:, :k]).sum().item())
    log("  %-10s max_abs %.3e (rtol %g, self-distance atol %g): %s; "
        "neighbours equal at %d of %d clear ranks%s"
        % (name, held.max().item(), TOL["knn"]["rtol"],
           TOL["knn"]["self_atol"], "ok" if bad == 0 else "%d out" % bad,
           int((clear & (idx == ref_idx[:, :k])).sum().item()),
           int(clear.sum().item()),
           "" if self_idx is None else ", rank 0 the query: %s" % ok_self))
    if bad or not bool(same.all()) or not ok_self or not zero_ok:
        raise AssertionError("%s disagrees with its plain version" % name)
    return held.max().item()


def att_knn_kernel_rows(dev, gen, randn):
    """Phase 1's rows for this slice's kernels: the folded MUTAN forward and
    backward at MutanAtt's attention shape (B 128, K 196, Dh 310, R 5,
    M 510), the kNN kernel at the builder's (1024 queries against 82,783 x
    2048, k 25), and MUTAN at MutanAtt's classifier shape (B 128, 620 / 310
    -> 510, R 5; logged, outside the kernels line)."""
    from vqa_counterexamples_tpu_torch.ops.cuda import (
        attmutan_kernel, knn_kernel)

    rows = {}
    B, K, DH, R, M = 128, 196, 310, 5, 510
    xv, g = randn(B, K, DH), randn(B, K, M, scale=0.1)
    w = randn(R * M, DH, scale=DH ** -0.5)
    b = randn(R * M, scale=0.1, dtype=torch.float32)
    hq = randn(B, R, M, dtype=torch.float32)
    args = (xv, w, b, hq)
    first = attmutan_kernel.folded_mutan(*args)
    err = check_close("attmutan", first,
                      attmutan_kernel.folded_mutan_plain(*args),
                      TOL["attmutan"])
    check_rerun("attmutan", first, attmutan_kernel.folded_mutan(*args))
    gemm = 2 * B * K * DH * M
    fold = 2 * B * R * DH * M
    io_in = B * K * DH * 2 + R * M * DH * 2 + R * M * 4 + B * R * M * 4
    rows["attmutan"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: attmutan_kernel.folded_mutan(*args), reps=20),
        plain_ms=time_ms(lambda: attmutan_kernel.folded_mutan_plain(*args),
                         reps=20),
        work=(gemm + fold, io_in + B * K * M * 2))
    got = attmutan_kernel.folded_mutan_bwd(*args, g)
    ref = attmutan_kernel.folded_mutan_bwd_plain(*args, g)
    err = max(rel_err("attmutan_bwd " + n, a, r, TOL["attmutan_bwd_rel"])
              for n, a, r in zip(("dx_v", "dw", "db", "dhq"), got, ref))
    again = attmutan_kernel.folded_mutan_bwd(*args, g)
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError("attmutan_bwd: a rerun on the same inputs "
                             "differs")
    log("  attmutan_bwd rerun on the same inputs: bit-equal")
    del got, ref, again
    rows["attmutan_bwd"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: attmutan_kernel.folded_mutan_bwd(*args, g),
                   reps=20),
        plain_ms=time_ms(lambda: attmutan_kernel.folded_mutan_bwd_plain(
            *args, g), reps=20),
        # dx_v and dweff GEMMs, weff, dw and dhq; x_v, w, b, hq, g read,
        # dx_v, dw (f32), db, dhq written
        work=(2 * gemm + 3 * fold,
              io_in + B * K * M * 2 + B * K * DH * 2 + R * M * DH * 4
              + R * M * 4 + B * R * M * 2))
    del xv, g, w, b, hq, args
    # MUTAN at MutanAtt's classifier shape
    rows["mutan_att"] = mutan_row("mutan_att", randn, B, 620, 310, R, M)
    # kNN: one chunk of the COCO-train self-kNN
    N, D, Q, KN = 82783, 2048, 1024, 25
    corpus = torch.randn(N, D, generator=gen, device=dev)
    pick = torch.randperm(N, generator=gen, device=dev)[:Q]
    queries = corpus[pick].contiguous()
    csq = (corpus * corpus).sum(1)
    dist, idx = knn_kernel.knn_chunk(queries, corpus, KN, csq)
    ref_d, ref_i = knn_kernel.knn_chunk_plain(queries, corpus, KN + 1, csq)
    err = check_knn("knn", dist, idx, ref_d, ref_i, self_idx=pick)
    again = knn_kernel.knn_chunk(queries, corpus, KN, csq)
    if not (torch.equal(dist, again[0]) and torch.equal(idx, again[1])):
        raise AssertionError("knn: a rerun on the same inputs differs")
    log("  knn        rerun on the same inputs: bit-equal")
    del dist, idx, ref_d, ref_i, again
    rows["knn"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: knn_kernel.knn_chunk(queries, corpus, KN, csq)),
        plain_ms=time_ms(lambda: knn_kernel.knn_chunk_plain(
            queries, corpus, KN, csq)),
        # split TF32: three TF32 products per f32 one, against the TF32
        # peak (the k winners' f32 rescoring is 0.03% of that)
        work=(3 * 2 * Q * N * D + 3 * Q * N,
              (Q * D + N * D + Q + N) * 4 + Q * KN * 8, PEAK_TF32_FLOPS))
    return rows


def mutan_row(name, randn, B, DHV, DHQ, R, M):
    """MUTAN at (B, dhv, dhq, R, dmm) against its plain version, a bit-equal
    rerun, both timed."""
    from vqa_counterexamples_tpu_torch.ops.cuda import mutan_kernel

    xv, xq = randn(B, DHV), randn(B, DHQ)
    wv, wq = randn(R * M, DHV, scale=DHV ** -0.5), randn(R * M, DHQ,
                                                         scale=DHQ ** -0.5)
    bv, bq = (randn(R * M, scale=0.1, dtype=torch.float32) for _ in range(2))
    args = (xv, xq, wv, bv, wq, bq, R)
    first = mutan_kernel.tucker_fusion(*args)
    err = check_close(name, first, mutan_kernel.tucker_fusion_plain(*args),
                      TOL["mutan"])
    check_rerun(name, first, mutan_kernel.tucker_fusion(*args))
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: mutan_kernel.tucker_fusion(*args), reps=20),
        plain_ms=time_ms(lambda: mutan_kernel.tucker_fusion_plain(*args),
                         reps=20),
        work=(2 * B * R * M * (DHV + DHQ),
              B * (DHV + DHQ) * 2 + R * M * (DHV + DHQ) * 2 + 2 * R * M * 4
              + B * M * 4))


def attmutan_row(name, randn, B, K=196, DH=310, R=5, M=510):
    """The folded MUTAN forward at (B, K, Dh, R, M) against its plain
    version, a bit-equal rerun, both timed."""
    from vqa_counterexamples_tpu_torch.ops.cuda import attmutan_kernel

    xv = randn(B, K, DH)
    w = randn(R * M, DH, scale=DH ** -0.5)
    b = randn(R * M, scale=0.1, dtype=torch.float32)
    hq = randn(B, R, M, dtype=torch.float32)
    args = (xv, w, b, hq)
    first = attmutan_kernel.folded_mutan(*args)
    err = check_close(name, first, attmutan_kernel.folded_mutan_plain(*args),
                      TOL["attmutan"])
    check_rerun(name, first, attmutan_kernel.folded_mutan(*args))
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: attmutan_kernel.folded_mutan(*args), reps=20),
        plain_ms=time_ms(lambda: attmutan_kernel.folded_mutan_plain(*args),
                         reps=20),
        work=(2 * B * K * DH * M + 2 * B * R * DH * M,
              B * K * DH * 2 + R * M * DH * 2 + R * M * 4 + B * R * M * 4
              + B * K * M * 2))


def serve_kernel_rows(dev, gen, randn):
    """Phase 1's rows at the demo server's batch sizes, its smallest and
    largest buckets (B 1 and B 32; logged, outside the kernels line): the
    GRU forward without a mask (the question encoder), MUTAN at MutanNoAtt's
    fusion (dh 360, R 10, dmm 360) and at MutanAtt's classifier (620 / 310
    -> 510, R 5), the folded MUTAN forward at MutanAtt's attention shape."""
    rows = {}
    T, H = 26, 2400
    w_hh = randn(3 * H, H, scale=H ** -0.5)
    b_hh = randn(3 * H, scale=0.1, dtype=torch.float32)
    for B in (1, 32):
        rows["gru_serve_b%d" % B] = gru_fwd_row(
            "gru B%d" % B, randn(T, B, 3 * H), w_hh, b_hh, None, False)
        rows["mutan_serve_b%d" % B] = mutan_row(
            "mutan B%d" % B, randn, B, 360, 360, 10, 360)
        rows["mutan_att_serve_b%d" % B] = mutan_row(
            "mutan_att B%d" % B, randn, B, 620, 310, 5, 510)
        rows["attmutan_serve_b%d" % B] = attmutan_row(
            "attmutan B%d" % B, randn, B)
    return rows


def counters():
    from vqa_counterexamples_tpu_torch.ops.cuda import launch_counters

    wrappers = launch_counters()
    if set(wrappers) != set(SOURCES):
        raise AssertionError("kernel wrappers %s, expected %s"
                             % (sorted(wrappers), sorted(SOURCES)))
    return wrappers


def reset_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in counters().items()}


class plain_kernels:
    """Swap the kernel wrappers the model modules call for their plain
    versions (the reference computation on the same card)."""

    def __enter__(self):
        from vqa_counterexamples_tpu_torch.models import cx
        from vqa_counterexamples_tpu_torch.ops import rnn, scorer
        from vqa_counterexamples_tpu_torch.ops.cuda import (
            attmutan_kernel, gru_kernel, mixture_kernel, mutan_kernel,
            vfeat_kernel)

        self.swaps = [(attmutan_kernel, "folded_mutan",
                       attmutan_kernel.folded_mutan_plain),
                      (attmutan_kernel, "folded_mutan_bwd",
                       attmutan_kernel.folded_mutan_bwd_plain),
                      (rnn, "gru_recurrence",
                       gru_kernel.gru_recurrence_plain),
                      (gru_kernel, "gru_recurrence",
                       gru_kernel.gru_recurrence_plain),
                      (gru_kernel, "gru_recurrence_bwd",
                       gru_kernel.gru_recurrence_bwd_plain),
                      (mutan_kernel, "tucker_fusion",
                       mutan_kernel.tucker_fusion_plain),
                      (cx, "vfeat_scores", vfeat_kernel.vfeat_scores_plain),
                      (scorer, "classify_softmax",
                       mixture_kernel.classify_softmax_plain)]
        self.saved = [getattr(m, n) for m, n, _ in self.swaps]
        for m, n, f in self.swaps:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for (m, n, _), f in zip(self.swaps, self.saved):
            setattr(m, n, f)


def flagship_model(dataset, dev):
    from vqa_counterexamples_tpu_torch.engines import cx_engine
    from vqa_counterexamples_tpu_torch.models import factory

    model = factory.flagship_cx(dataset["vocab_words"],
                                dataset["vocab_answers"])
    return cx_engine.init_cx_params(model, seed=SEED).to(dev)


def phase_slice(dev, card):
    from vqa_counterexamples_tpu_torch.data import synthetic, vqacx
    from vqa_counterexamples_tpu_torch.engines import cx_engine

    log("== phase 2: the scoring slice at the flagship width")
    batch_size = 768
    dataset, store = synthetic.make_synthetic_cx(
        n_examples=2048, n_images=1024, dim_v=2048, knn_size=24,
        n_answers=2000, seed=SEED)
    arrays = vqacx.CXArrays.from_examples(dataset["examples_list"],
                                          dataset["name_to_index"])
    model = flagship_model(dataset, dev)
    features = store.to_device(dev)
    eval_step = cx_engine.make_cx_eval_step(model, recall_k=5,
                                            use_z_cache=True)
    if not model.wants_table_features():
        raise AssertionError("the vfeat kernel's gate is off")
    torch.cuda.synchronize()

    # --- the main path, counted ---
    reset_counters()
    t0 = time.perf_counter()
    q, _, z, stage_s = cx_engine.build_frozen_caches(
        model, features, arrays, use_q=True, use_v=False, use_z=True)
    feats_bf, q, _, z = cx_engine.make_tables_bf16_resident(features, q,
                                                           None, z)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    res = cx_engine.eval_model(eval_step, feats_bf, arrays, batch_size,
                               q_table=q, z_table=z)
    eval_s = time.perf_counter() - t1
    launches = read_counters()
    log("  launches on the scoring path: %s" % launches)
    if min(launches[k] for k in ("gru", "vfeat", "mixture")) <= 0:
        raise AssertionError("a kernel of the path never launched: %s"
                             % launches)
    log("  results: %s" % res)
    if not (np.isfinite(res["loss"]) and 0.0 <= res["recall_1"]
            <= res["recall"] <= 1.0):
        raise AssertionError("bad eval results %s" % res)
    if tuple(q.shape) != (2048, 2400) or tuple(z.shape) != (2048, 25, 360):
        raise AssertionError("cache shapes q %s z %s"
                             % (tuple(q.shape), tuple(z.shape)))

    # --- one batch: kernel path vs the plain versions on the same card ---
    idx = np.arange(batch_size)
    batch = cx_engine.batch_to_device(vqacx.gather_batch(arrays, idx), dev)
    with torch.no_grad():
        kw = cx_engine.cache_kwargs(batch, q, None, z)
        got = model(None, batch["question_wids"], batch["answer_aids"],
                    features_table=feats_bf, image_idxs=batch["image_idxs"],
                    **kw)
        sub = vqacx.CXArrays(*(a[idx] for a in arrays))
        with plain_kernels():
            q_p, _, z_p, _ = cx_engine.build_frozen_caches(
                model, features, sub, use_q=True, use_v=False, use_z=True)
            f_p, q_p, _, z_p = cx_engine.make_tables_bf16_resident(
                features, q_p, None, z_p)
            ref = model(None, batch["question_wids"], batch["answer_aids"],
                        features_table=f_p, image_idxs=batch["image_idxs"],
                        q_emb=q_p, z_emb=z_p)
    check_close("scores", got, ref, TOL["scores"])

    # --- rates (warm: kernels built, caches resident) ---
    reps = 5
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(reps):
        cx_engine.eval_model(eval_step, feats_bf, arrays, batch_size,
                             q_table=q, z_table=z)
    torch.cuda.synchronize()
    warm_s = (time.perf_counter() - t2) / reps
    log("  cache build %.3f s (stages %s), first eval %.3f s (%s)"
        % (cache_s, {k: round(v, 4) for k, v in stage_s.items()}, eval_s,
           card))
    log("  eval %.1f examples/s (warm, mean of %d passes over %d examples,"
        " B=%d; %s)" % (arrays.size / warm_s, reps, arrays.size, batch_size,
                        card))
    return launches, (arrays, model, features)


def step_grads(model, feats, batch, n_valid, q, z, parts=1):
    """One train step's loss and gradients (no update) -> {name: grad}.
    With ``parts`` > 1: the sum of the gradients of the batch's ``parts``
    row ranges, each computed as a data-parallel rank computes its rows
    (the loss over the global ``n_valid``, the draws at the global shape),
    in rank order: what the ranks' all-reduce adds up."""
    from vqa_counterexamples_tpu_torch.core import rng
    from vqa_counterexamples_tpu_torch.engines import cx_engine
    from vqa_counterexamples_tpu_torch.ops.metrics import nll

    rows = batch["comp_idxs"].shape[0]
    size = rows // parts
    total = None
    for d in range(parts):
        part = {k: v[d * size:(d + 1) * size] for k, v in batch.items()}
        gens = rng.step_generators(SEED, 0, ("dropout", "lesion"),
                                   feats.device)
        model.train()
        with (rng.global_batch(rows, d * size, size) if parts > 1
              else contextlib.nullcontext()):
            scores = model(None, part["question_wids"], part["answer_aids"],
                           features_table=feats,
                           image_idxs=part["image_idxs"],
                           dropout_gen=gens["dropout"],
                           lesion_gen=gens["lesion"],
                           **cx_engine.cache_kwargs(part, q, None, z))
        mask = (torch.arange(scores.shape[0], device=scores.device)
                + d * size < n_valid).float()
        loss = torch.sum(nll(scores, part["comp_idxs"]) * mask) / n_valid
        model.zero_grad(set_to_none=True)
        loss.backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in cx_engine.trainable_parameters(model)}
        total = grads if total is None else {
            n: total[n] + g for n, g in grads.items()}
    return total


def phase_train(dev, card, ctx):
    from vqa_counterexamples_tpu_torch.data import vqacx
    from vqa_counterexamples_tpu_torch.engines import cx_engine

    log("== phase 3: training at the flagship width")
    torch.cuda.reset_peak_memory_stats()
    arrays, model, features = ctx
    batch_size, epochs = 768, 2
    val = vqacx.CXArrays(*(a[:batch_size] for a in arrays))
    state = cx_engine.init_cx_state(model, lr=1e-4)
    train_step = cx_engine.make_cx_train_step(model, state.optimizer,
                                              base_seed=SEED,
                                              use_z_cache=True)
    eval_step = cx_engine.make_cx_eval_step(model, use_z_cache=True)
    losses, evals = [], []
    torch.cuda.synchronize()

    # --- the main path, counted ---
    reset_counters()
    q, _, z, _ = cx_engine.build_frozen_caches(
        model, features, arrays, use_q=True, use_v=False, use_z=True)
    feats_bf, q, _, z = cx_engine.make_tables_bf16_resident(features, q,
                                                           None, z)

    def run_eval(_state):
        evals.append(cx_engine.eval_model(eval_step, feats_bf, val,
                                          batch_size, q_table=q, z_table=z))
        return evals[-1]

    rng = np.random.default_rng(SEED)
    for epoch in range(1, epochs + 1):
        state, res = cx_engine.train_epoch(
            train_step, state, feats_bf, arrays, batch_size, rng=rng,
            log_fn=lambda b, m: losses.append(m["loss"]), print_freq=1,
            eval_fn=run_eval, q_table=q, z_table=z)
        log("  epoch %d: val %s" % (epoch, res))
    torch.cuda.synchronize()
    launches = read_counters()
    steps = state.step
    eval_batches = len(evals) * -(-val.size // batch_size)
    log("  %d steps, %d eval batches; launches on the training path: %s"
        % (steps, eval_batches, launches))
    want = {"gru": 1, "gru_pg": 0, "gru_bwd": 0,
            "vfeat": steps + eval_batches, "vfeat_bwd": steps,
            "mixture": steps + eval_batches, "mutan": 0, "attmutan": 0,
            "attmutan_bwd": 0, "knn": 0}
    if launches != want:
        raise AssertionError("launch counts %s, expected %s"
                             % (launches, want))
    log("  losses: %s" % ["%.4f" % x for x in losses])
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError("non-finite or missing losses %s" % losses)

    # --- one step's grads: kernel path vs the plain versions, dropout off ---
    idx, n_valid = next(vqacx.batch_indices(arrays.size, batch_size,
                                            shuffle=False))
    batch = cx_engine.batch_to_device(vqacx.gather_batch(arrays, idx), dev)
    model.drop_p, drop_p = 0.0, model.drop_p
    got = step_grads(model, feats_bf, batch, n_valid, q, z)
    with plain_kernels():
        ref = step_grads(model, feats_bf, batch, n_valid, q, z)
    model.drop_p = drop_p
    worst = 0.0
    # out.bias shifts all K scores alike, which the K-way CE cannot see:
    # its gradient is 0 up to rounding on both paths
    for name in (n for n in got if n != "out.bias"):
        scale = ref[name].abs().max().item()
        err = (got[name] - ref[name]).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, err)
        if not (torch.isfinite(got[name]).all() and err <= TOL["grads_rel"]):
            raise AssertionError("grad %s: kernel path vs plain path, max "
                                 "error %.3e of the largest entry" % (name,
                                                                      err))
    log("  grads of %d tensors: kernel path vs plain path, worst max error "
        "%.3e of the largest entry (bound %g): ok"
        % (len(got) - 1, worst, TOL["grads_rel"]))

    # --- the warm train rate ---
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        state, _ = cx_engine.train_epoch(train_step, state, feats_bf, arrays,
                                         batch_size, rng=rng, q_table=q,
                                         z_table=z)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_steps = reps * -(-arrays.size // batch_size)
    log("  train %.1f examples/s, %.3f ms per step (warm, %d epochs of %d "
        "examples, B=%d, dropout %.2f, captured steps; %s)"
        % (reps * arrays.size / secs, secs / n_steps * 1e3, reps,
           arrays.size, batch_size, drop_p, card))
    compare_cx(model, feats_bf, q, z, arrays, batch_size, card)
    log("  phase 3: " + memory_line(card))
    return launches


def compare_cx(model, feats, q, z, arrays, batch_size, card):
    """The captured CX steps against the eager ones from one starting state
    (copies of ``model``, fresh Adam), dropout on: an epoch of train steps
    (the third batch padded: 512 valid of 768), the same epoch through
    ``make_cx_train_scan`` with S 3, and an eval pass; then the warm ms a
    step of both, unprofiled and profiled."""
    import copy

    from vqa_counterexamples_tpu_torch.engines import cx_engine

    keys = ("loss", "correct")
    tables = dict(q_table=q, z_table=z)
    runs = {}
    for name, capture, scan in (("captured", None, 0), ("eager", False, 0),
                                ("scan", None, 3)):
        m = copy.deepcopy(model)
        m.zero_grad(set_to_none=True)
        st = cx_engine.init_cx_state(m, lr=1e-4)
        rows = []
        step = cx_engine.make_cx_train_step(
            m, st.optimizer, base_seed=SEED, use_z_cache=True,
            capture=capture)
        scan_step = (recorded(cx_engine.make_cx_train_scan(step), rows,
                              keys) if scan else None)
        st, _ = cx_engine.train_epoch(
            recorded(step, rows, keys), st, feats, arrays, batch_size,
            rng=np.random.default_rng(SEED + 1), scan_step=scan_step,
            scan_len=scan, **tables)
        runs[name] = (rows, m, st.optimizer, st, step)
    hold_equal("CX train, captured vs eager", runs["captured"][:3],
               runs["eager"][:3])
    hold_equal("CX train, make_cx_train_scan S 3 vs single captured steps",
               runs["scan"][:3], runs["captured"][:3])
    evals = [cx_engine.eval_model(
        cx_engine.make_cx_eval_step(model, use_z_cache=True,
                                    capture=capture),
        feats, arrays, batch_size, **tables) for capture in (None, False)]
    log("  CX eval, captured vs eager: %s vs %s" % tuple(evals))
    if evals[0] != evals[1]:
        raise AssertionError("captured eval differs from eager")
    per_pass = -(-arrays.size // batch_size)
    for name in ("eager", "captured"):
        _, _, _, st, step = runs[name]
        rng = np.random.default_rng(SEED + 2)
        step_profile("CX train step, %s" % name,
                     lambda: cx_engine.train_epoch(
                         step, st, feats, arrays, batch_size, rng=rng,
                         **tables), 3, per_pass, card)
        eval_step = cx_engine.make_cx_eval_step(
            st.model, use_z_cache=True,
            capture=None if name == "captured" else False)
        step_profile("CX eval batch, %s" % name,
                     lambda: cx_engine.eval_model(
                         eval_step, feats, arrays, batch_size, **tables),
                     3, per_pass, card)


def phase_cli(dev, card):
    from vqa_counterexamples_tpu_torch.cli import counterexamples

    log("== phase 4: the CLI")
    torch.cuda.reset_peak_memory_stats()
    texts = []
    for extra in ([], ["--scan_steps", "2"]):
        reset_counters()
        with tempfile.TemporaryDirectory() as tmp:
            counterexamples.main(["--cx_model", "NeuralModel", "--synthetic",
                                  "2048", "--z_cache", "--epochs", "1",
                                  "--test", "-b", "768", "--seed", str(SEED),
                                  "--device", str(dev), "--project_dir",
                                  tmp, *extra])
            (run,) = os.listdir(os.path.join(tmp, "logs", "cx"))
            run_dir = os.path.join(tmp, "logs", "cx", run)
            files = sorted(os.path.join(sub, name)
                           for sub in ("ckpt", "best")
                           for name in os.listdir(os.path.join(run_dir,
                                                               sub)))
            with open(os.path.join(run_dir, "final_results.txt")) as f:
                texts.append(f.read())
        res = json.loads(texts[-1])
        launches = read_counters()
        log("  %s: checkpoint files %s; final_results.txt: %s; launches %s"
            % (" ".join(extra) or "one step a call", files, res, launches))
        if files != ["best/info.ckpt", "best/model.ckpt", "ckpt/info.ckpt",
                     "ckpt/model.ckpt"]:
            raise AssertionError("checkpoint files %s" % files)
        if min(launches[k] for k in ("gru", "vfeat", "vfeat_bwd",
                                     "mixture")) <= 0:
            raise AssertionError("the CLI run missed a kernel: %s"
                                 % launches)
        # one epoch: best_epoch is the epoch after the best checkpoint's,
        # as the JAX CLI writes it
        if not (np.isfinite(res["loss"]) and 0.0 <= res["recall"] <= 1.0
                and res["best_epoch"] == 2):
            raise AssertionError("bad CLI results %s" % res)
    if texts[0] != texts[1]:
        raise AssertionError("--scan_steps 2 changed final_results.txt: "
                             "%s vs %s" % tuple(texts))
    log("  --scan_steps 2 (a group of 2 and a single step): the same "
        "final_results.txt, to the bit")
    log("  phase 4: " + memory_line(card))
    return texts[0]


def pretrain_grads(model, batch, dev, plain):
    """One pretraining step's loss and gradients of every parameter (no
    update), dropout on, the masks from the step-0 generator."""
    from vqa_counterexamples_tpu_torch.core import rng
    from vqa_counterexamples_tpu_torch.ops.metrics import cross_entropy_mean

    gen = rng.step_generators(SEED, 0, ("dropout",), dev)["dropout"]
    model.zero_grad(set_to_none=True)
    model.train()
    if plain:
        with plain_kernels():
            out = model(batch["visual"], batch["question"], training=True,
                        generator=gen)
            cross_entropy_mean(out, batch["answer"]).backward()
    else:
        out = model(batch["visual"], batch["question"], training=True,
                    generator=gen)
        cross_entropy_mean(out, batch["answer"]).backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def phase_pretrain(dev, card):
    from vqa_counterexamples_tpu_torch.cli.profile_vqa import flagship_vqa
    from vqa_counterexamples_tpu_torch.core.experiment import Experiment
    from vqa_counterexamples_tpu_torch.core.meters import AvgMeter
    from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays
    from vqa_counterexamples_tpu_torch.engines import vqa_engine

    log("== phase 5: VQA pretraining at full width")
    torch.cuda.reset_peak_memory_stats()
    batch_size, epochs = 512, 2
    model, examples, store, _ = flagship_vqa(seed=SEED)
    model.to(dev)
    arrays = VQAArrays(examples, store, samplingans=True)
    val = VQAArrays(examples[:1024], store)
    feats = store.to_device(dev)
    state = vqa_engine.init_vqa_state(model, lr=1e-4)
    train_step = vqa_engine.make_vqa_train_step(model, state.optimizer,
                                                base_seed=SEED)
    eval_step = vqa_engine.make_vqa_eval_step(model)
    exp = Experiment("chip_smoke")
    for tag in ("train", "val"):
        exp.add_meters(tag, {k: AvgMeter() for k in (
            "loss", "acc1", "acc5", "batch_time", "data_time")})
    losses = []

    def counted_step(st, batch):
        st, m = train_step(st, batch)
        losses.append(m["loss"])
        return st, m

    rng = np.random.default_rng(SEED)

    def train_loader():
        return arrays.batches(batch_size, shuffle=True, rng=rng,
                              drop_remainder=True, device_features=feats)

    def val_loader():
        return val.batches(batch_size, shuffle=False, drop_remainder=True,
                           device_features=feats)

    torch.cuda.synchronize()
    # --- the main path, counted ---
    reset_counters()
    val_res = []
    for epoch in range(1, epochs + 1):
        state = vqa_engine.train_epoch(counted_step, state, train_loader(),
                                       exp, epoch, print_freq=10 ** 9)
        val_res.append(vqa_engine.validate(eval_step, val_loader(), exp,
                                           epoch))
        log("  epoch %d: val %s" % (epoch, val_res[-1]))
    torch.cuda.synchronize()
    launches = read_counters()
    steps = state.step
    val_batches = epochs * (val.size // batch_size)
    log("  %d train steps, %d val batches; launches on the pretraining "
        "path: %s" % (steps, val_batches, launches))
    want = {"gru": val_batches, "gru_pg": steps, "gru_bwd": steps,
            "vfeat": 0, "vfeat_bwd": 0, "mixture": 0,
            "mutan": steps + val_batches, "attmutan": 0, "attmutan_bwd": 0,
            "knn": 0}
    if launches != want:
        raise AssertionError("launch counts %s, expected %s"
                             % (launches, want))
    losses = [float(x) for x in losses]
    log("  losses: %s" % ["%.4f" % x for x in losses])
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError("non-finite or missing losses %s" % losses)
    if not all(np.isfinite(r["loss"]) and 0 <= r["acc1"] <= r["acc5"] <= 100
               for r in val_res):
        raise AssertionError("bad val results %s" % val_res)

    # --- one step's grads: kernel path vs the plain versions, dropout on ---
    batch = vqa_engine.batch_to_device(
        next(arrays.batches(batch_size, shuffle=False,
                            device_features=feats)), dev)
    got = pretrain_grads(model, batch, dev, plain=False)
    ref = pretrain_grads(model, batch, dev, plain=True)
    worst, worst_name = 0.0, ""
    for name in got:
        scale = ref[name].abs().max().item()
        err = (got[name] - ref[name]).abs().max().item() / max(scale, 1e-30)
        if err > worst:
            worst, worst_name = err, name
        if not (torch.isfinite(got[name]).all()
                and err <= TOL["pretrain_grads_rel"]):
            raise AssertionError("grad %s: kernel path vs plain path, max "
                                 "error %.3e of the largest entry"
                                 % (name, err))
    log("  grads of %d tensors (dropout on): kernel path vs plain path, "
        "worst max error %.3e of the largest entry (%s; bound %g): ok"
        % (len(got), worst, worst_name, TOL["pretrain_grads_rel"]))
    model.zero_grad(set_to_none=True)

    # --- the warm rates ---
    reps = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for epoch in range(reps):
        state = vqa_engine.train_epoch(train_step, state, train_loader(),
                                       exp, epoch, print_freq=10 ** 9)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_steps = reps * (arrays.size // batch_size)
    log("  train %.1f examples/s, %.3f ms per step (warm, %d epochs of %d "
        "examples, B=%d, dropout on; %s)"
        % (n_steps * batch_size / secs, secs / n_steps * 1e3, reps,
           arrays.size, batch_size, card))
    t0 = time.perf_counter()
    for _ in range(reps):
        vqa_engine.validate(eval_step, arrays.batches(
            batch_size, shuffle=False, drop_remainder=True,
            device_features=feats), exp, 0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log("  val %.1f examples/s, %.3f ms per batch (warm, %d passes over %d "
        "examples; %s)" % (reps * arrays.size / secs,
                           secs / (reps * arrays.size // batch_size) * 1e3,
                           reps, arrays.size, card))
    embedding_bwd_reruns(model, batch["question"])
    compare_vqa("MutanNoAtt", model, lambda rng: arrays.batches(
        batch_size, shuffle=True, rng=rng, drop_remainder=True,
        device_features=feats), arrays.size // batch_size, exp, card,
        batch["question"].shape[1])
    log("  phase 5: " + memory_line(card))
    return launches


def embedding_bwd_reruns(model, wids, calls=5):
    """The word embedding's backward on ``wids`` with one cotangent,
    ``calls`` times: PyTorch's default CUDA path (logged: it may differ
    between calls) and the port's (``models/seq2vec.embedding``), which
    must give the same bits every call."""
    from vqa_counterexamples_tpu_torch.models import seq2vec

    table = model.seq2vec.embedding.weight.detach()
    ids = wids.long()
    gen = torch.Generator(device=table.device).manual_seed(SEED)
    cot = torch.randn(*ids.shape, table.shape[1], generator=gen,
                      device=table.device)
    worst, ms = {}, {}
    for name, fn in (("default", torch.nn.functional.embedding),
                     ("port", seq2vec.embedding)):
        grads = []
        for _ in range(calls):
            t = table.clone().requires_grad_(True)
            fn(ids, t).backward(cot)
            grads.append(t.grad)
        worst[name] = max((g - grads[0]).abs().max().item() for g in grads)
        ms[name] = time_ms(lambda: torch.autograd.grad(fn(ids, t), t, cot),
                           reps=20)
    log("  embedding backward on %d word ids (%d distinct), %d calls: "
        "largest difference between calls %.3e on PyTorch's default path, "
        "%.3e on the port's; lookup and backward %.4f / %.4f ms a call"
        % (ids.numel(), ids.unique().numel(), calls, worst["default"],
           worst["port"], ms["default"], ms["port"]))
    if worst["port"] != 0.0:
        raise AssertionError("the port's embedding backward differs "
                             "between calls")


def compare_vqa(label, model, loader, per_pass, exp, card, seq_len,
                passes=2, profiled=("eager", "captured")):
    """The captured pretraining step against the eager one from one
    starting state (copies of ``model``, fresh Adam), dropout on: an epoch
    of ``loader(rng)``'s batches each; then the warm ms a step of both,
    unprofiled and profiled (``seq_len``: the questions' length), of the
    ``profiled`` ones.  Returns the captured run's (steps, 3) loss / acc1
    / acc5 rows and the profiles."""
    import copy

    from vqa_counterexamples_tpu_torch.engines import vqa_engine

    keys = ("loss", "acc1", "acc5")
    runs = {}
    for name, capture in (("captured", None), ("eager", False)):
        m = copy.deepcopy(model)
        m.zero_grad(set_to_none=True)
        st = vqa_engine.init_vqa_state(m, lr=1e-4)
        step = vqa_engine.make_vqa_train_step(m, st.optimizer,
                                              base_seed=SEED,
                                              capture=capture)
        rows = []
        rstep = recorded(step, rows, keys)
        for batch in loader(np.random.default_rng(SEED + 1)):
            st, _ = rstep(st, batch)
        runs[name] = (rows, m, st.optimizer, st, step)
    hold_equal("%s train, captured vs eager" % label, runs["captured"][:3],
               runs["eager"][:3])
    profiles = {}
    for name in profiled:
        _, _, _, st, step = runs[name]
        rng = np.random.default_rng(SEED + 2)
        profiles[name] = step_profile(
            "%s train step, %s" % (label, name),
            lambda: vqa_engine.train_epoch(step, st, loader(rng), exp, 0,
                                           print_freq=10 ** 9),
            passes, per_pass, card, seq_len=seq_len)
    return torch.cat(runs["captured"][0]).cpu(), profiles


def phase_train_cli(dev):
    from vqa_counterexamples_tpu_torch.cli import train

    log("== phase 6: the pretraining CLI")
    reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        state = train.main([
            "--path_opt", os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "configs", "vqa2",
                "mutan_noatt_train.yaml"),
            "--synthetic", "2048", "--epochs", "1", "-b", "512",
            "--seed", str(SEED), "--device", str(dev), "--dir_logs", tmp])
        files = sorted(n for n in os.listdir(tmp)
                       if os.path.isfile(os.path.join(tmp, n)))
        with open(os.path.join(tmp, "logger.json")) as f:
            logged = json.load(f)["logged"]
        with open(os.path.join(tmp, "ckpt_info.json")) as f:
            info = json.load(f)
        with open(os.path.join(tmp, "results", "val",
                               "vqa_OpenEnded_mscoco_epoch_1.json")) as f:
            rows = json.load(f)
    launches = read_counters()
    log("  files %s; ckpt_info %s; %d val rows; %d steps; launches %s"
        % (files, info, len(rows), state.step, launches))
    want_files = ["best_info.json", "best_model.msgpack",
                  "best_optim.msgpack", "ckpt_info.json",
                  "ckpt_model.msgpack", "ckpt_optim.msgpack", "logger.json",
                  "options.yaml"]
    if files != want_files:
        raise AssertionError("run files %s, expected %s" % (files,
                                                            want_files))
    if (info["epoch"] != 1 or not np.isfinite(info["acc1"])
            or set(logged["val"]["acc1"]) != {"1"} or len(rows) != 2048
            or state.step != 4):
        raise AssertionError("bad CLI run: info %s, logged %s, %d rows"
                             % (info, sorted(logged["val"]), len(rows)))
    if min(launches[k] for k in ("gru", "gru_pg", "gru_bwd", "mutan")) <= 0:
        raise AssertionError("the CLI run missed a kernel: %s" % launches)
    return logged, rows


def phase_att_pretrain(dev, card):
    from vqa_counterexamples_tpu_torch.cli.profile_vqa import flagship_vqa
    from vqa_counterexamples_tpu_torch.core.experiment import Experiment
    from vqa_counterexamples_tpu_torch.core.meters import AvgMeter
    from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays
    from vqa_counterexamples_tpu_torch.engines import vqa_engine

    log("== phase 7: MutanAtt pretraining at full width")
    torch.cuda.reset_peak_memory_stats()
    batch_size, epochs = 128, 2
    t0 = time.perf_counter()
    model, examples, store, _ = flagship_vqa(seed=SEED, path_opt=ATT_CONFIG,
                                             n_examples=1024)
    model.to(dev)
    log("  model and %d examples over %d maps %s (%.0f MB on the host) in "
        "%.1f s" % (len(examples), len(store), store.row_shape,
                    store.features.nbytes / 1e6, time.perf_counter() - t0))
    arrays = VQAArrays(examples, store, samplingans=True)
    val = VQAArrays(examples[:256], store)
    state = vqa_engine.init_vqa_state(model, lr=1e-4)
    train_step = vqa_engine.make_vqa_train_step(model, state.optimizer,
                                                base_seed=SEED)
    eval_step = vqa_engine.make_vqa_eval_step(model)
    exp = Experiment("chip_smoke_att")
    for tag in ("train", "val"):
        exp.add_meters(tag, {k: AvgMeter() for k in (
            "loss", "acc1", "acc5", "batch_time", "data_time")})
    losses = []

    def counted_step(st, batch):
        st, m = train_step(st, batch)
        losses.append(m["loss"])
        return st, m

    rng = np.random.default_rng(SEED)

    def train_loader():
        return arrays.batches(batch_size, shuffle=True, rng=rng,
                              drop_remainder=True, device=dev)

    def val_loader(data):
        return data.batches(batch_size, shuffle=False, drop_remainder=True,
                            device=dev)

    torch.cuda.synchronize()
    # --- the main path, counted ---
    reset_counters()
    val_res = []
    for epoch in range(1, epochs + 1):
        state = vqa_engine.train_epoch(counted_step, state, train_loader(),
                                       exp, epoch, print_freq=10 ** 9)
        val_res.append(vqa_engine.validate(eval_step, val_loader(val), exp,
                                           epoch))
        log("  epoch %d: val %s" % (epoch, val_res[-1]))
    torch.cuda.synchronize()
    launches = read_counters()
    steps = state.step
    val_batches = epochs * (val.size // batch_size)
    log("  %d train steps, %d val batches; launches on the MutanAtt path: %s"
        % (steps, val_batches, launches))
    want = {"gru": val_batches, "gru_pg": steps, "gru_bwd": steps,
            "vfeat": 0, "vfeat_bwd": 0, "mixture": 0,
            "mutan": steps + val_batches, "attmutan": steps + val_batches,
            "attmutan_bwd": steps, "knn": 0}
    if launches != want:
        raise AssertionError("launch counts %s, expected %s"
                             % (launches, want))
    losses = [float(x) for x in losses]
    log("  losses: %s" % ["%.4f" % x for x in losses])
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError("non-finite or missing losses %s" % losses)
    if not all(np.isfinite(r["loss"]) and 0 <= r["acc1"] <= r["acc5"] <= 100
               for r in val_res):
        raise AssertionError("bad val results %s" % val_res)

    # --- one step's grads: kernel path vs the plain versions, dropout on ---
    batch = vqa_engine.batch_to_device(next(val_loader(arrays)), dev)
    got = pretrain_grads(model, batch, dev, plain=False)
    ref = pretrain_grads(model, batch, dev, plain=True)
    worst, worst_name = 0.0, ""
    # conv_att's bias shifts every position's score alike, which the
    # softmax over the positions cannot see: its gradient is 0 up to
    # rounding on both paths
    for name in (n for n in got if n != "conv_att.bias"):
        scale = ref[name].abs().max().item()
        err = (got[name] - ref[name]).abs().max().item() / max(scale, 1e-30)
        if err > worst:
            worst, worst_name = err, name
        if not (torch.isfinite(got[name]).all()
                and err <= TOL["pretrain_grads_rel"]):
            raise AssertionError("grad %s: kernel path vs plain path, max "
                                 "error %.3e of the largest entry"
                                 % (name, err))
    log("  grads of %d tensors (dropout on): kernel path vs plain path, "
        "worst max error %.3e of the largest entry (%s; bound %g): ok"
        % (len(got) - 1, worst, worst_name, TOL["pretrain_grads_rel"]))
    model.zero_grad(set_to_none=True)

    # --- the warm rates ---
    reps = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for epoch in range(reps):
        state = vqa_engine.train_epoch(train_step, state, train_loader(),
                                       exp, epoch, print_freq=10 ** 9)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_steps = reps * (arrays.size // batch_size)
    log("  train %.1f examples/s, %.3f ms per step (warm, %d epochs of %d "
        "examples, B=%d, dropout on; %s)"
        % (n_steps * batch_size / secs, secs / n_steps * 1e3, reps,
           arrays.size, batch_size, card))
    t0 = time.perf_counter()
    for _ in range(reps):
        vqa_engine.validate(eval_step, val_loader(arrays), exp, 0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log("  val %.1f examples/s, %.3f ms per batch (warm, %d passes over %d "
        "examples; %s)" % (reps * arrays.size / secs,
                           secs / (reps * arrays.size // batch_size) * 1e3,
                           reps, arrays.size, card))
    compare_vqa("MutanAtt", model, lambda rng: arrays.batches(
        batch_size, shuffle=True, rng=rng, drop_remainder=True, device=dev),
        arrays.size // batch_size, exp, card, batch["question"].shape[1])
    log("  phase 7: " + memory_line(card))
    return launches


def phase_att_cli(dev):
    from vqa_counterexamples_tpu_torch.cli import train

    log("== phase 8: the pretraining CLI with MutanAtt")
    reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        state = train.main([
            "--path_opt", ATT_CONFIG, "--synthetic", "1024", "--epochs", "1",
            "-b", "128", "--seed", str(SEED), "--device", str(dev),
            "--dir_logs", tmp])
        files = sorted(n for n in os.listdir(tmp)
                       if os.path.isfile(os.path.join(tmp, n)))
        with open(os.path.join(tmp, "logger.json")) as f:
            logged = json.load(f)["logged"]
        with open(os.path.join(tmp, "ckpt_info.json")) as f:
            info = json.load(f)
        with open(os.path.join(tmp, "results", "val",
                               "vqa_OpenEnded_mscoco_epoch_1.json")) as f:
            rows = json.load(f)
    launches = read_counters()
    log("  files %s; ckpt_info %s; %d val rows; %d steps; launches %s"
        % (files, info, len(rows), state.step, launches))
    want_files = ["ckpt_info.json", "ckpt_model.msgpack",
                  "ckpt_optim.msgpack", "logger.json", "options.yaml"]
    if info["acc1"] > 0:   # a best epoch only when val acc@1 beat 0
        want_files = sorted(want_files + ["best_info.json",
                                          "best_model.msgpack",
                                          "best_optim.msgpack"])
    if files != want_files:
        raise AssertionError("run files %s, expected %s" % (files,
                                                            want_files))
    if (info["epoch"] != 1 or not np.isfinite(info["acc1"])
            or set(logged["val"]["acc1"]) != {"1"} or len(rows) != 1024
            or state.step != 8):
        raise AssertionError("bad CLI run: info %s, logged %s, %d rows"
                             % (info, sorted(logged["val"]), len(rows)))
    if min(launches[k] for k in ("gru", "gru_pg", "gru_bwd", "mutan",
                                 "attmutan", "attmutan_bwd")) <= 0:
        raise AssertionError("the CLI run missed a kernel: %s" % launches)
    return logged, rows


def phase_knn(dev, card, n=82783):
    from vqa_counterexamples_tpu_torch.cli import knn
    from vqa_counterexamples_tpu_torch.data.features import FeatureStore
    from vqa_counterexamples_tpu_torch.data.vqacx import coco_num_to_name
    from vqa_counterexamples_tpu_torch.ops.cuda import knn_kernel

    log("== phase 9: the kNN builder at COCO-train scale")
    dim, k = 2048, 25
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        feats = np.random.default_rng(SEED).standard_normal(
            (n, dim), dtype=np.float32)
        prefix = os.path.join(tmp, "trainset")
        FeatureStore(feats, [coco_num_to_name(i) for i in range(n)]).save(
            prefix)
        log("  %d x %d f32 features written in %.1f s"
            % (n, dim, time.perf_counter() - t0))
        torch.cuda.synchronize()
        # --- the main path, counted ---
        reset_counters()
        t0 = time.perf_counter()
        dist, idx = knn.main(["--path_features", prefix, "-k", str(k),
                              "--json-out", os.path.join(tmp, "knn.json"),
                              "--device", str(dev)])
        build_s = time.perf_counter() - t0
        launches = read_counters()
        with open(os.path.join(tmp, "knn.json")) as f:
            text = f.read()
            table = json.loads(text)
        saved = np.load(prefix + "_knn_results.npy", allow_pickle=True).item()
    want = {name: 0 for name in SOURCES}
    want["knn"] = -(-n // 1024)
    log("  launches on the kNN path: %s" % launches)
    if launches != want:
        raise AssertionError("launch counts %s, expected %s"
                             % (launches, want))
    if (dist.shape != (n, k) or idx.shape != (n, k) or len(table) != n
            or not np.array_equal(saved["indices"], idx)
            or any(len(v) != k - 1 for v in table.values())):
        raise AssertionError("bad kNN outputs: %s %s, %d json rows"
                             % (dist.shape, idx.shape, len(table)))
    # a 1024-query sample of the output against the plain version
    pick = np.random.default_rng(SEED + 1).choice(n, 1024, replace=False)
    corpus = torch.from_numpy(feats).to(dev)
    ref_d, ref_i = knn_kernel.knn_chunk_plain(corpus[pick], corpus, k + 1)
    check_knn("knn build", torch.from_numpy(dist[pick]).to(dev),
              torch.from_numpy(idx[pick]).to(dev), ref_d, ref_i,
              self_idx=torch.from_numpy(pick).to(dev))
    log("  kNN build: %d queries x %d x %d, k %d, %.2f s through the CLI "
        "(load, %d chunks, the .npy and the json; %s)"
        % (n, n, dim, k, build_s, want["knn"], card))
    return launches, dict(dist=dist, idx=idx, json=text, seconds=build_s)


def trainable_model(dataset, dev):
    """NeuralCX over a trainable MutanNoAtt at
    ``configs/cx/neuralcx_trainable_vqa.yaml``'s widths, built through
    ``core/config.resolve_options`` and the factory, random weights from
    the seed."""
    from vqa_counterexamples_tpu_torch.core import config
    from vqa_counterexamples_tpu_torch.engines import cx_engine
    from vqa_counterexamples_tpu_torch.models import factory

    options = config.resolve_options({}, TRAINABLE_CONFIG)
    model = factory.cx_from_options("NeuralModel", options,
                                    dataset["vocab_words"],
                                    dataset["vocab_answers"])
    if not model.trainable_vqa:
        raise AssertionError("%s: trainable_vqa is off" % TRAINABLE_CONFIG)
    return cx_engine.init_cx_params(model, seed=SEED).to(dev), options


def trainable_grads(model, feats, batch, n_valid, plain, dtype="bfloat16"):
    """One trainable step's loss and the gradients of every parameter, the
    backbone's included (no update), dropout on, the masks from the step-0
    generators: through the kernels, or with ``plain`` through their
    plain versions; under the ``dtype`` policy (float32: no kernel, the
    reference the two bf16 paths are measured from)."""
    from vqa_counterexamples_tpu_torch.core import rng
    from vqa_counterexamples_tpu_torch.ops.metrics import nll

    gens = rng.step_generators(SEED, 0, ("dropout", "lesion"), feats.device)
    model.zero_grad(set_to_none=True)
    model.train()
    os.environ["VQACX_COMPUTE_DTYPE"] = dtype
    with plain_kernels() if plain else contextlib.nullcontext():
        scores = model(feats[batch["image_idxs"].long()],
                       batch["question_wids"], batch["answer_aids"],
                       dropout_gen=gens["dropout"], lesion_gen=gens["lesion"])
        mask = (torch.arange(scores.shape[0], device=scores.device)
                < n_valid).float()
        loss = torch.sum(nll(scores, batch["comp_idxs"]) * mask) / n_valid
        loss.backward()
    os.environ["VQACX_COMPUTE_DTYPE"] = "bfloat16"
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def phase_trainable(dev, card):
    import copy

    from vqa_counterexamples_tpu_torch.data import synthetic, vqacx
    from vqa_counterexamples_tpu_torch.engines import cx_engine

    log("== phase 10: the trainable backbone at neuralcx_trainable_vqa.yaml's "
        "width")
    torch.cuda.reset_peak_memory_stats()
    batch_size = 768
    dataset, store = synthetic.make_synthetic_cx(
        n_examples=2048, n_images=1024, dim_v=2048, knn_size=24,
        n_answers=2000, seed=SEED)
    arrays = vqacx.CXArrays.from_examples(dataset["examples_list"],
                                          dataset["name_to_index"])
    val = vqacx.CXArrays(*(a[:batch_size] for a in arrays))
    model, options = trainable_model(dataset, dev)
    fus = options["model"]["fusion"]
    log("  NeuralCX %d x %d (drop_p %.2f) over MutanNoAtt: dim_v %d, %s "
        "%d -> %d (dropout %.2f), MUTAN R %d at %d (dropout_v %.1f, "
        "dropout_q %.1f), classifier dropout %.1f, %d answers; %d "
        "parameters, all trained"
        % (model.dim_h, model.n_layers, model.drop_p, fus["dim_v"],
           options["model"]["seq2vec"]["type"],
           model.vqa_model.seq2vec.embedding.weight.shape[1],
           model.vqa_model.seq2vec.gru_cell.hidden_size,
           options["model"]["seq2vec"]["dropout"], fus["R"], fus["dim_mm"],
           fus["dropout_v"], fus["dropout_q"],
           options["model"]["classif"]["dropout"],
           len(dataset["vocab_answers"]),
           sum(p.numel() for p in model.parameters())))
    features = store.to_device(dev)
    start = copy.deepcopy(model)
    state = cx_engine.init_cx_state(model, lr=options["optim"]["lr"])
    if len(state.optimizer.param_groups[0]["params"]) != len(
            list(model.parameters())):
        raise AssertionError("Adam does not cover the backbone")
    train_step = cx_engine.make_cx_train_step(model, state.optimizer,
                                              base_seed=SEED)
    eval_step = cx_engine.make_cx_eval_step(model)
    losses, evals = [], []
    torch.cuda.synchronize()

    # --- the main path, counted ---
    reset_counters()

    def run_eval(_state):
        evals.append(cx_engine.eval_model(eval_step, features, val,
                                          batch_size))
        return evals[-1]

    state, res = cx_engine.train_epoch(
        train_step, state, features, arrays, batch_size,
        rng=np.random.default_rng(SEED),
        log_fn=lambda b, m: losses.append(m["loss"]), print_freq=1,
        eval_fn=run_eval)
    torch.cuda.synchronize()
    launches = read_counters()
    steps = state.step
    eval_batches = len(evals) * -(-val.size // batch_size)
    log("  1 epoch: val %s; %d steps, %d eval batches; launches: %s"
        % (res, steps, eval_batches, launches))
    want = {"gru": eval_batches, "gru_pg": steps, "gru_bwd": steps,
            "vfeat": 0, "vfeat_bwd": 0, "mixture": 0, "mutan": steps,
            "attmutan": 0, "attmutan_bwd": 0, "knn": 0}
    if launches != want:
        raise AssertionError("launch counts %s, expected %s"
                             % (launches, want))
    log("  losses: %s" % ["%.4f" % x for x in losses])
    if (len(losses) != steps or not np.isfinite(losses).all()
            or not np.isfinite(res["loss"])):
        raise AssertionError("non-finite or missing losses %s, %s"
                             % (losses, res))

    # --- one step's grads: kernel path vs the plain versions, dropout on ---
    idx, n_valid = next(vqacx.batch_indices(arrays.size, batch_size,
                                            shuffle=False))
    batch = cx_engine.batch_to_device(vqacx.gather_batch(arrays, idx), dev)
    got = trainable_grads(model, features, batch, n_valid, plain=False)
    ref = trainable_grads(model, features, batch, n_valid, plain=True)
    f32 = trainable_grads(model, features, batch, n_valid, plain=True,
                          dtype="float32")
    model.zero_grad(set_to_none=True)

    def rel(a, b):
        return ((a - b).abs().max().item()
                / max(b.abs().max().item(), 1e-30))

    worst = (0.0, "", 0.0, 0.0)
    # out.bias shifts all K scores alike, which the K-way CE cannot see:
    # its gradient is 0 up to rounding on both paths
    for name in (n for n in got if n != "out.bias"):
        err, own = rel(got[name], ref[name]), rel(ref[name], f32[name])
        bound_rel = max(TOL["pretrain_grads_rel"], TOL["own_bf16"] * own)
        if err > worst[0]:
            worst = (err, name, own, rel(got[name], f32[name]))
        if not (torch.isfinite(got[name]).all() and err <= bound_rel):
            raise AssertionError(
                "grad %s: kernel path vs plain path, max error %.3e of the "
                "largest entry (bound %.3e; the plain bf16 path vs f32: "
                "%.3e)" % (name, err, bound_rel, own))
    def cos(a, b):
        return torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0).item()

    cosines = [(cos(got[n], f32[n]), cos(ref[n], f32[n]), n) for n in got
               if n != "out.bias"]
    log("  gradient direction against the f32 policy's: the lowest cosine "
        "similarity of a tensor's gradient, kernel path %.5f (%s), plain "
        "path %.5f (%s)" % (min(cosines)[0], min(cosines)[2],
                            min(cosines, key=lambda c: c[1])[1],
                            min(cosines, key=lambda c: c[1])[2]))
    n_backbone = sum(n.startswith("vqa_model.") for n in got)
    noisy = {n: round(rel(ref[n], f32[n]), 4) for n in got
             if n != "out.bias" and rel(ref[n], f32[n])
             > TOL["pretrain_grads_rel"] / TOL["own_bf16"]}
    log("  grads of %d tensors (%d of the backbone; dropout on): kernel "
        "path vs plain path, worst max error %.3e of the largest entry (%s;"
        " there the plain bf16 path is %.3e from the f32 policy's grads and "
        "the kernel path %.3e); bound max(%g, %g x the plain path's own "
        "distance from f32); tensors whose plain bf16 grads are more than "
        "%g from f32: %s: ok"
        % (len(got) - 1, n_backbone, worst[0], worst[1], worst[2], worst[3],
           TOL["pretrain_grads_rel"], TOL["own_bf16"],
           TOL["pretrain_grads_rel"] / TOL["own_bf16"], noisy))
    del got, ref, f32

    # --- captured vs eager from one starting state, and their ms ---
    keys = ("loss", "correct")
    runs = {}
    for name, capture in (("captured", None), ("eager", False)):
        m = copy.deepcopy(start)
        st = cx_engine.init_cx_state(m, lr=options["optim"]["lr"])
        step = cx_engine.make_cx_train_step(m, st.optimizer, base_seed=SEED,
                                            capture=capture)
        rows = []
        st, _ = cx_engine.train_epoch(recorded(step, rows, keys), st,
                                      features, arrays, batch_size,
                                      rng=np.random.default_rng(SEED + 1))
        runs[name] = (rows, m, st.optimizer, st, step)
    hold_equal("trainable NeuralCX train, captured vs eager",
               runs["captured"][:3], runs["eager"][:3])
    evals = [cx_engine.eval_model(cx_engine.make_cx_eval_step(
        runs["captured"][1], capture=capture), features, val, batch_size)
        for capture in (None, False)]
    log("  trainable NeuralCX eval, captured vs eager: %s vs %s"
        % tuple(evals))
    if evals[0] != evals[1]:
        raise AssertionError("captured eval differs from eager")
    per_pass = -(-arrays.size // batch_size)
    seq_len = arrays.question_wids.shape[1]
    for name in ("eager", "captured"):
        _, m, _, st, step = runs[name]
        rng = np.random.default_rng(SEED + 2)
        step_profile("trainable NeuralCX train step, %s" % name,
                     lambda: cx_engine.train_epoch(
                         step, st, features, arrays, batch_size, rng=rng),
                     2, per_pass, card, seq_len=seq_len)
        eval_step = cx_engine.make_cx_eval_step(
            m, capture=None if name == "captured" else False)
        step_profile("trainable NeuralCX eval batch, %s" % name,
                     lambda: cx_engine.eval_model(eval_step, features,
                                                  arrays, batch_size),
                     2, per_pass, card, seq_len=seq_len)
    log("  phase 10: " + memory_line(card))
    return launches


class counted_cache_builds:
    """Wrap ``cx_engine.build_frozen_caches``: every build that encodes
    questions must move the GRU forward's launch counter."""

    def __enter__(self):
        from vqa_counterexamples_tpu_torch.engines import cx_engine

        self.builds = 0
        self.saved = build = cx_engine.build_frozen_caches

        def counted(model, features, arrays, *, use_q=True, **kw):
            before = read_counters()["gru"]
            out = build(model, features, arrays, use_q=use_q, **kw)
            if use_q:
                self.builds += 1
                if read_counters()["gru"] <= before:
                    raise AssertionError("a q-cache build launched no GRU "
                                         "forward")
            return out

        cx_engine.build_frozen_caches = counted
        return self

    def __exit__(self, *exc):
        from vqa_counterexamples_tpu_torch.engines import cx_engine

        cx_engine.build_frozen_caches = self.saved


def cli_run(main, argv):
    """``main(argv)`` in a temporary project dir -> (info, the run dir's
    files, final_results.txt's dict or None)."""
    with tempfile.TemporaryDirectory() as tmp:
        info = main(argv + ["--project_dir", tmp])
        (run,) = os.listdir(os.path.join(tmp, "logs", "cx"))
        run_dir = os.path.join(tmp, "logs", "cx", run)
        files = sorted(os.path.join(sub, name) for sub in ("ckpt", "best")
                       for name in os.listdir(os.path.join(run_dir, sub)))
        final = os.path.join(run_dir, "final_results.txt")
        res = None
        if os.path.exists(final):
            with open(final) as f:
                res = json.load(f)
    return info, files, res


def zoo_step_pairs(dev, card):
    """One model each of LinearContext, PairwiseModel (on a pairwise view,
    K 2) and the contrastive step at the flagship backbone's width over
    the phase-2 dataset, B 768, the q/v caches on: two captured train
    steps against two eager ones from one starting state, bit-equal."""
    import copy

    from vqa_counterexamples_tpu_torch.data import synthetic, vqacx
    from vqa_counterexamples_tpu_torch.engines import contrastive_engine as ce
    from vqa_counterexamples_tpu_torch.engines import cx_engine
    from vqa_counterexamples_tpu_torch.models import factory

    batch_size = 768
    dataset, store = synthetic.make_synthetic_cx(
        n_examples=2048, n_images=1024, dim_v=2048, knn_size=24,
        n_answers=2000, seed=SEED)
    arrays = vqacx.CXArrays.from_examples(dataset["examples_list"],
                                          dataset["name_to_index"])
    features = store.to_device(dev)
    pw = arrays.pairwise_view(np.random.default_rng(SEED))
    batches = [vqacx.gather_batch(view, np.arange(i * batch_size,
                                                  (i + 1) * batch_size))
               for view in (arrays, pw) for i in range(2)]
    for name, view_batches, make in (
            ("LinearContext", batches[:2], None),
            ("PairwiseModel", batches[2:], None),
            ("ContrastiveModel", batches[2:], ce.make_contrastive_train_step)):
        # the flagship's backbone, built anew for each model (its init
        # draws from a CPU generator)
        vqa = factory.flagship_cx(dataset["vocab_words"],
                                  dataset["vocab_answers"]).vqa_model
        model = cx_engine.init_cx_params(factory.factory_cx(
            name, vqa, knn_size=24), seed=SEED).to(dev)
        q, v, _, _ = cx_engine.build_frozen_caches(
            model, features, arrays, use_q=True, use_v=True, use_z=False)
        keys = (("loss", "loss_comp", "loss_other", "dist_comp",
                 "dist_other") if make else ("loss", "correct"))
        runs = {}
        for how, capture in (("captured", None), ("eager", False)):
            m = copy.deepcopy(model)
            st = cx_engine.init_cx_state(m, lr=1e-4)
            if make:
                step = make(m, st.optimizer, base_seed=SEED, capture=capture)
            else:
                step = cx_engine.make_cx_train_step(
                    m, st.optimizer, base_seed=SEED, capture=capture,
                    recall_k=1 if name == "PairwiseModel" else 5)
            rows = []
            rstep = recorded(step, rows, keys)
            for batch in view_batches:
                st, _ = rstep(st, features, batch, batch_size, q_table=q,
                              v_table=v)
            runs[how] = (rows, m, st.optimizer)
        hold_equal("%s train (B %d, K %d), captured vs eager"
                   % (name, batch_size, view_batches[0]["image_idxs"].shape[1]
                      - 1), runs["captured"], runs["eager"])
        del runs, model, q, v


def phase_zoo(dev, card):
    from vqa_counterexamples_tpu_torch.cli import contrastive, counterexamples
    from vqa_counterexamples_tpu_torch.models.factory import cx_model_names

    log("== phase 11: the CX zoo and the contrastive trainer")
    torch.cuda.reset_peak_memory_stats()
    zoo_step_pairs(dev, card)
    base = ["--synthetic", "2048", "--epochs", "1", "--test", "-b", "768",
            "--seed", str(SEED), "--device", str(dev)]
    trained = ("LinearContext", "PairwiseModel", "PairwiseLinearModel")
    for name in (n for n in cx_model_names if n != "NeuralModel"):
        argv = ["--cx_model", name] + base
        if name == "ContrastiveModel":
            # as JAX's CLI: its embeddings are no K-way scores
            try:
                counterexamples.main(argv + ["--project_dir", "unused"])
            except ValueError as exc:
                log("  ContrastiveModel through the CX CLI: ValueError "
                    "(%s), as in JAX's CLI" % exc)
                continue
            raise AssertionError("the CX CLI ran ContrastiveModel")
        if name == "SemanticBaseline":
            argv += ["--sb_lambda", "0.5"]
        if name == "PairwiseModel":
            argv += ["--pairwise"]
        reset_counters()
        t0 = time.perf_counter()
        with counted_cache_builds() as cb:
            info, files, res = cli_run(counterexamples.main, argv)
        launches = read_counters()
        log("  %s: %.1f s; val %s; final_results.txt %s; files %s; %d "
            "cache builds; launches %s"
            % (" ".join(argv[:2] + argv[len(base) + 2:]),
               time.perf_counter() - t0, info[-1], res, files, cb.builds,
               launches))
        backbone = name not in ("RandomBaseline", "DistanceBaseline")
        if cb.builds != (3 if name in trained else 2 if backbone else 0):
            raise AssertionError("%s: %d cache builds" % (name, cb.builds))
        if not backbone and any(launches.values()):
            raise AssertionError("%s launched kernels: %s"
                                 % (name, launches))
        want = {"loss", "recall", "recall_1", "best_epoch"}
        if name == "PairwiseModel":
            want |= {"loss_pairwise", "acc_pairwise"}
        if (files != ["best/info.ckpt", "best/model.ckpt",
                      "ckpt/info.ckpt", "ckpt/model.ckpt"]
                or set(res) != want
                or not all(np.isfinite(v) for v in res.values())
                or not 0.0 <= res["recall_1"] <= res["recall"] <= 1.0
                or res["best_epoch"] != (2 if name in trained else 0)):
            raise AssertionError("%s: files %s, results %s"
                                 % (name, files, res))
    reset_counters()
    t0 = time.perf_counter()
    with counted_cache_builds() as cb:
        info, files, _ = cli_run(contrastive.main, [
            "--synthetic", "2048", "--epochs", "1", "-b", "768", "--seed",
            str(SEED), "--device", str(dev)])
    log("  cli.contrastive --synthetic 2048 --epochs 1 -b 768: %.1f s; %s; "
        "files %s; %d cache builds; launches %s"
        % (time.perf_counter() - t0, info, files, cb.builds,
           read_counters()))
    if (len(info) != 1 or cb.builds != 2
            or set(info[0]) != {"contrastive/recall", "recall"}
            or not 0.0 <= info[0]["recall"] <= 1.0
            or files != ["best/info.ckpt", "best/model.ckpt",
                         "ckpt/info.ckpt", "ckpt/model.ckpt"]):
        raise AssertionError("contrastive CLI: %s, files %s" % (info, files))
    log("  phase 11: " + memory_line(card))


# phase 12's fixture: the real file layouts at full width, from the seed
RD_IMAGES = {"train": 512, "val": 128}
RD_QUESTIONS = 8           # questions an image
RD_COMP = 4                # of them shared with the image's pair mate
RD_CLUSTER = 32            # images around one feature centre
RD_WORDS = 1200            # question words
NOATT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "configs", "vqa2", "mutan_noatt_train.yaml")
CX_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "configs", "cx", "counterexamples_default.yaml")


def write_realdata(root, seed=SEED):
    """The raw files of a miniature COCO / VQA2 / skip-thoughts set under
    ``root`` in the real names and layouts, made with numpy: 512 train and
    128 val images with 8 questions each, ten human answers a question and
    ``multiple_choice_answer``; more than 2,000 distinct train answers
    (1,500 seen twice, the rest once), so ``nans`` 2000 cuts the tail;
    complementary pairs between images 2i-1 and 2i on 4 shared questions;
    features in clusters of 32 images (``trainset.npy`` (N, 2048) f32 and
    ``trainset.att.npy`` (N, 14, 14, 2048) f32, COCO-named rows in
    ``trainset.txt``), each pair inside one cluster; a skip-thoughts set
    at the published widths (``dictionary.txt`` without one question word,
    ``utable.npy`` (V, 620), a theano-layout ``uni_skip.npz`` at hidden
    2400).  Returns the paths by name."""
    rng = np.random.default_rng(seed)
    paths = {"vqa": os.path.join(root, "data", "vqa2"),
             "coco": os.path.join(root, "data", "coco"),
             "st": os.path.join(root, "data", "skip-thoughts"),
             "cx": os.path.join(root, "data", "cx"),
             "logs": os.path.join(root, "logs")}
    paths["ann"] = os.path.join(paths["vqa"], "raw", "annotations")
    paths["knn"] = os.path.join(paths["coco"], "knn")
    paths["features"] = os.path.join(paths["coco"], "extract",
                                     "arch,fbresnet152_size,448")
    for key in ("ann", "knn", "features", "st", "cx"):
        os.makedirs(paths[key], exist_ok=True)
    words = ["w%04d" % i for i in range(RD_WORDS)]
    common = (words[:1000]
              + ["%s %s" % (words[a], words[b]) for a, b in
                 rng.integers(0, RD_WORDS, (300, 2))]
              + ["x%03d" % i for i in range(200)])   # not question words
    n_train_q = RD_IMAGES["train"] * RD_QUESTIONS
    train_answers = common * 2 + ["t%04d" % i
                                  for i in range(n_train_q - 2 * 1500)]
    train_answers = [train_answers[i] for i in rng.permutation(n_train_q)]

    def question():
        n = int(rng.integers(4, 15))
        return " ".join(words[i] for i in rng.integers(0, RD_WORDS, n)) \
            + " ?"

    for split, n in RD_IMAGES.items():
        questions, annotations, pairs = [], [], []
        for image in range(1, n + 1):
            mate = image - 1 if image % 2 == 0 else None
            for q in range(RD_QUESTIONS):
                qid = image * 10 + q
                text = (questions[-RD_QUESTIONS]["question"]
                        if mate and q < RD_COMP else question())
                if mate and q < RD_COMP:
                    pairs.append([mate * 10 + q, qid])
                k = len(questions)
                answer = (train_answers[k] if split == "train"
                          else common[int(rng.integers(0, 1500))])
                other = common[int(rng.integers(0, 1500))]
                humans = [answer] * int(rng.integers(6, 11))
                humans += [other] * (10 - len(humans))
                questions.append({"question_id": qid, "image_id": image,
                                  "question": text})
                annotations.append({
                    "question_id": qid, "image_id": image,
                    "multiple_choice_answer": answer,
                    "answers": [{"answer": a, "answer_id": j + 1}
                                for j, a in enumerate(humans)]})
        for name, obj in (
                ("v2_OpenEnded_mscoco_%s2014_questions.json",
                 {"questions": questions}),
                ("v2_mscoco_%s2014_annotations.json",
                 {"annotations": annotations}),
                ("v2_mscoco_%s2014_complementary_pairs.json", pairs)):
            with open(os.path.join(paths["ann"], name % split), "w") as f:
                json.dump(obj, f)
        names = ["COCO_%s2014_%012d.jpg" % (split, i)
                 for i in range(1, n + 1)]
        centres = rng.standard_normal((n // RD_CLUSTER, 2048),
                                      dtype=np.float32)
        feats = (np.repeat(centres, RD_CLUSTER, axis=0) + 0.1
                 * rng.standard_normal((n, 2048), dtype=np.float32))
        prefix = os.path.join(paths["features"], "%sset" % split)
        np.save(prefix + ".npy", feats)
        maps = np.lib.format.open_memmap(prefix + ".att.npy", mode="w+",
                                         dtype=np.float32,
                                         shape=(n, 14, 14, 2048))
        for i in range(0, n, 64):
            maps[i:i + 64] = rng.standard_normal(
                (min(64, n - i), 14, 14, 2048), dtype=np.float32)
        maps.flush()
        del maps
        with open(prefix + ".txt", "w") as f:
            f.write("\n".join(names) + "\n")
    dictionary = ["UNK"] + words[:-1] + ["extra%d" % i for i in range(50)]
    with open(os.path.join(paths["st"], "dictionary.txt"), "w") as f:
        f.write("\n".join(dictionary) + "\n")
    np.save(os.path.join(paths["st"], "utable.npy"),
            0.3 * rng.standard_normal((len(dictionary), 620),
                                      dtype=np.float32))
    h, s = 2400, 2400 ** -0.5
    np.savez(os.path.join(paths["st"], "uni_skip.npz"),
             encoder_W=0.04 * rng.standard_normal((620, 2 * h),
                                                  dtype=np.float32),
             encoder_U=s * rng.standard_normal((h, 2 * h), dtype=np.float32),
             encoder_b=np.zeros(2 * h, np.float32),
             encoder_Wx=0.04 * rng.standard_normal((620, h),
                                                   dtype=np.float32),
             encoder_Ux=s * rng.standard_normal((h, h), dtype=np.float32),
             encoder_bx=np.zeros(h, np.float32))
    return paths


def realdata_yaml(paths, config, name, **sections):
    """``config`` with its data paths rewritten to the fixture's, as
    ``scripts/replicate_reference.write_vqa_train_yaml`` and
    ``stage_counterexamples`` rewrite them, at the published widths."""
    import yaml

    with open(config) as f:
        opt = yaml.safe_load(f)
    opt["vqa"]["dir"] = paths["vqa"]
    opt["coco"]["dir"] = paths["coco"]
    opt["coco"]["path_features"] = paths["features"]
    opt["model"]["seq2vec"]["dir_st"] = paths["st"]
    for section, values in sections.items():
        opt[section].update(values)
    path = os.path.join(os.path.dirname(paths["vqa"]), name)
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path


class stage_clock:
    """Logs a stage's seconds and its launches; ``want`` (name -> count,
    the others 0) must equal the counters read at its end."""

    def __init__(self, name, seconds):
        self.name, self.seconds = name, seconds

    def __enter__(self):
        reset_counters()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def check(self, want, note=""):
        torch.cuda.synchronize()
        self.seconds[self.name] = time.perf_counter() - self.t0
        launches = read_counters()
        want = {k: want.get(k, 0) for k in SOURCES}
        log("  %s: %.2f s; launches %s%s" % (self.name,
                                             self.seconds[self.name],
                                             launches, note))
        if launches != want:
            raise AssertionError("%s: launch counts %s, expected %s"
                                 % (self.name, launches, want))
        return launches

    def __exit__(self, *exc):
        return False


def join_threads():
    """Wait for the train CLI's scoring threads (``eval_res``)."""
    import threading

    for thread in threading.enumerate():
        if thread is not threading.current_thread():
            thread.join(timeout=300)


def phase_realdata(dev, card):
    """Phase 12: the real-data pipeline through the port's CLIs."""
    import pickle

    from vqa_counterexamples_tpu_torch.cli import (
        build_answer_embedding, build_vqacx, counterexamples, knn,
        port_skipthoughts, preprocess, train)
    from vqa_counterexamples_tpu_torch.core import msgpack_tree
    from vqa_counterexamples_tpu_torch.engines import cx_engine
    from vqa_counterexamples_tpu_torch.models import from_jax

    log("== phase 12: the real-data pipeline at full width")
    torch.cuda.reset_peak_memory_stats()
    seconds = {}
    d = ["--device", str(dev)]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = write_realdata(root)
        seconds["fixture"] = time.perf_counter() - t0
        log("  fixture (512 train / 128 val images, 8 questions each, "
            "att maps included): %.2f s" % seconds["fixture"])
        processed = os.path.join(
            paths["vqa"], "processed", "nans,2000_maxlength,26_minwcount,0_"
            "nlp,mcb_pad,right_trainsplit,train")

        # 1. preprocess
        with stage_clock("preprocess", seconds) as st:
            preprocess.main(["interim", "--dir_vqa", paths["vqa"]])
            preprocess.main(["processed", "--dirname", paths["vqa"],
                             "--nans", "2000", "--maxlength", "26",
                             "--minwcount", "0", "--nlp", "mcb", "--pad",
                             "right"])
            st.check({})
        with open(os.path.join(processed, "aid_to_ans.pickle"), "rb") as f:
            vocab_answers = pickle.load(f)
        with open(os.path.join(processed, "trainset.pickle"), "rb") as f:
            n_train = len(pickle.load(f))
        with open(os.path.join(processed, "valset.pickle"), "rb") as f:
            n_val = len(pickle.load(f))
        log("  %d answers; %d of %d train questions kept (OOV answers "
            "dropped); %d val questions"
            % (len(vocab_answers), n_train,
               RD_IMAGES["train"] * RD_QUESTIONS, n_val))
        if len(vocab_answers) != 2000 or not (
                3000 <= n_train < RD_IMAGES["train"] * RD_QUESTIONS):
            raise AssertionError("preprocess: %d answers, %d train "
                                 "questions" % (len(vocab_answers), n_train))

        # 2. the skip-thoughts porter
        with stage_clock("port_skipthoughts", seconds) as st:
            port_skipthoughts.main([
                "--dir_st", paths["st"], "--vocab",
                os.path.join(processed, "wid_to_word.pickle"), "--table",
                "utable", "--out",
                os.path.join(paths["st"], "adapted_uniskip.npz")])
            st.check({})
        z = np.load(os.path.join(paths["st"], "adapted_uniskip.npz"))
        if (z["embedding"].shape[1] != 620
                or z["w_hh"].shape != (2400, 7200)):
            raise AssertionError("adapted npz %s"
                                 % {k: z[k].shape for k in z.files})

        # 3. kNN, -k 25, train and val
        for split in ("train", "val"):
            with stage_clock("knn " + split, seconds) as st:
                out = os.path.join(paths["knn"],
                                   "computed_%s2014_nn_images.json" % split)
                knn.main(["--path_features", os.path.join(
                    paths["features"], "%sset" % split), "-k", "25",
                    "--split", split, "--json-out", out] + d)
                st.check({"knn": -(-RD_IMAGES[split] // 1024)})
            with open(out) as f:
                lists = json.load(f)
            cluster = {int(k): {(int(k) - 1) // RD_CLUSTER} for k in lists}
            strays = sum((j - 1) // RD_CLUSTER not in cluster[int(k)]
                         for k, v in lists.items() for j in v)
            if (len(lists) != RD_IMAGES[split] or strays
                    or {len(v) for v in lists.values()} != {24}):
                raise AssertionError("knn %s: %d lists, %d neighbours "
                                     "outside the cluster"
                                     % (split, len(lists), strays))

        # 4. MutanNoAtt pretraining, 1 epoch, B 512, eval_res on the rows
        vqa_logs = os.path.join(paths["logs"], "vqa2", "mutan_noatt_train")
        noatt_yaml = realdata_yaml(paths, NOATT_CONFIG, "noatt.yaml")
        steps, val_batches = n_train // 512, n_val // 512
        with stage_clock("train MutanNoAtt", seconds) as st:
            state = train.main(["--path_opt", noatt_yaml, "--dir_logs",
                                vqa_logs, "--epochs", "1", "-b", "512",
                                "--seed", str(SEED)] + d)
            st.check({"gru_pg": steps, "gru_bwd": steps,
                      "mutan": steps + val_batches, "gru": val_batches},
                     "; %d steps, %d val batches" % (state.step,
                                                     val_batches))
        join_threads()
        with open(os.path.join(vqa_logs, "results", "val",
                               "vqa_OpenEnded_mscoco_epoch_1_accuracy.json"
                               )) as f:
            scores = json.load(f)
        with open(os.path.join(vqa_logs, "ckpt_info.json")) as f:
            info = json.load(f)
        log("  val %s; eval_res OpenEnded %.2f over %d rows"
            % (info, scores["overall"], scores["n"]))
        if (state.step != steps or scores["n"] != val_batches * 512
                or not 0.0 <= scores["overall"] <= 100.0
                or not np.isfinite(info["acc1"])):
            raise AssertionError("pretraining: %d steps, %s, %s"
                                 % (state.step, info, scores))
        if not os.path.isfile(os.path.join(vqa_logs,
                                           "best_model.msgpack")):
            # a best checkpoint needs a val acc@1 above 0: save the last
            import shutil

            for name in ("info.json", "model.msgpack", "optim.msgpack"):
                shutil.copyfile(os.path.join(vqa_logs, "ckpt_" + name),
                                os.path.join(vqa_logs, "best_" + name))
            log("  (val acc@1 0: ckpt_* copied to best_*)")

        # 5. the answer embedding, kernel path vs the plain GRU
        emb_path = os.path.join(paths["cx"], "answer_embedding.pickle")
        argv = ["--path_opt", noatt_yaml, "--path_processed", processed,
                "--dir_logs", vqa_logs] + d
        with open(os.path.join(processed, "wid_to_word.pickle"), "rb") as f:
            vocab_words = set(pickle.load(f).values())
        covered = sum(all(w in vocab_words for w in a.split())
                      for a in vocab_answers)
        with stage_clock("build_answer_embedding", seconds) as st:
            table = build_answer_embedding.main(argv + ["--out", emb_path])
            st.check({"gru": -(-covered // 128)},
                     "; %d covered answers" % covered)
        with plain_kernels():
            plain = build_answer_embedding.main(argv + [
                "--out", os.path.join(root, "plain.pickle")])
        rows = np.abs(table).sum(1) > 0
        log("  table %s, %d rows covered" % (table.shape, rows.sum()))
        if table.shape != (2000, 2400) or rows.sum() != covered \
                or not covered:
            raise AssertionError("answer embedding %s, %d covered"
                                 % (table.shape, rows.sum()))
        check_close("answer_emb", torch.from_numpy(table),
                    torch.from_numpy(plain), TOL["gru"])

        # 6. the augmented VQA-CX sets
        with stage_clock("build_vqacx", seconds) as st:
            for split in ("train", "val"):
                build_vqacx.main([
                    "--split", split, "--path_processed", processed,
                    "--path_comp_pairs", os.path.join(
                        paths["ann"],
                        "v2_mscoco_%s2014_complementary_pairs.json" % split),
                    "--path_knn_json", os.path.join(
                        paths["knn"], "computed_%s2014_nn_images.json"
                        % split),
                    "--path_features_txt", os.path.join(
                        paths["features"], "%sset.txt" % split),
                    "--out_dir", paths["cx"]])
            st.check({})
        sizes = {}
        for split in ("train", "val"):
            with open(os.path.join(paths["cx"], "%sset_augmented.pickle"
                                   % split), "rb") as f:
                examples = pickle.load(f)["examples_list"]
            sizes[split] = len(examples)
            pairs = RD_IMAGES[split] // 2 * RD_COMP * 2
            if not (pairs // 2 < sizes[split] <= pairs and all(
                    len(ex["knns"]) == 24
                    and 0 <= ex["comp"]["knn_index"] < 24
                    for ex in examples)):
                raise AssertionError("build_vqacx %s: %d of %d kept"
                                     % (split, sizes[split], pairs))
        log("  augmented: %d train, %d val examples" % (sizes["train"],
                                                      sizes["val"]))

        # 7. NeuralCX over the real sets, --test (the --z_cache step: the
        # one that takes the vfeat kernels)
        cx_yaml = realdata_yaml(
            paths, CX_CONFIG, "cx.yaml", logs={"dir_logs": vqa_logs},
            vqa={"path_trainset": paths["cx"]})
        seen = {}
        init_state = cx_engine.init_cx_state

        def spy(model, *args, **kwargs):
            seen["start"] = {k: v.detach().clone()
                             for k, v in model.state_dict().items()}
            return init_state(model, *args, **kwargs)

        cx_steps = -(-sizes["train"] // 64)
        eval_batches = 2 * -(-sizes["val"] // 64)   # the val pass, --test
        cx_engine.init_cx_state = spy
        try:
            with stage_clock("counterexamples", seconds) as st, \
                    counted_cache_builds() as cb:
                info, files, res = cli_run(counterexamples.main, [
                    "--cx_model", "NeuralModel", "--epochs", "1", "--test",
                    "--z_cache", "--path_opt", cx_yaml, "--seed", str(SEED)]
                    + d)
                st.check({"gru": 3, "vfeat": cx_steps + eval_batches,
                          "vfeat_bwd": cx_steps,
                          "mixture": cx_steps + eval_batches},
                         "; %d steps, %d eval batches, %d cache builds"
                         % (cx_steps, eval_batches, cb.builds))
        finally:
            cx_engine.init_cx_state = init_state
        log("  val %s; final_results.txt %s" % (info[-1], res))
        if (cb.builds != 3 or set(res) != {"loss", "recall", "recall_1",
                                             "best_epoch"}
                or not np.isfinite(res["loss"])
                or not 0.0 <= res["recall_1"] <= res["recall"] <= 1.0):
            raise AssertionError("counterexamples: %s, %d cache builds"
                                 % (res, cb.builds))
        best = from_jax.vqa_state_dict_from_jax(msgpack_tree.load(
            os.path.join(vqa_logs, "best_model.msgpack")))
        start = seen["start"]
        differ = [k for k, v in best.items()
                  if not torch.equal(start["vqa_model." + k].cpu(), v)]
        emb_equal = np.array_equal(
            start["answer_embedding.weight"].cpu().numpy(), table)
        log("  the CX model's backbone at its start: %d tensors, %s the "
            "best VQA checkpoint's; its answer embedding %s the pickle's"
            % (len(best), "bit-equal to" if not differ else
               "DIFFERENT from (%s)" % differ,
               "bit-equal to" if emb_equal else "DIFFERENT from"))
        if differ or not emb_equal:
            raise AssertionError("the grafted backbone or answer embedding "
                                 "differs from its file")

        # 8. MutanAtt pretraining, 1 epoch, B 128, over the att maps
        att_yaml = realdata_yaml(paths, ATT_CONFIG, "att.yaml")
        steps, val_batches = n_train // 128, n_val // 128
        with stage_clock("train MutanAtt", seconds) as st:
            state = train.main([
                "--path_opt", att_yaml, "--dir_logs",
                os.path.join(paths["logs"], "vqa2", "mutan_att_train"),
                "--epochs", "1", "-b", "128", "--seed", str(SEED)] + d)
            st.check({"gru_pg": steps, "gru_bwd": steps,
                      "mutan": steps + val_batches,
                      "attmutan": steps + val_batches,
                      "attmutan_bwd": steps, "gru": val_batches},
                     "; %d steps, %d val batches" % (state.step,
                                                     val_batches))
        join_threads()
        if state.step != steps:
            raise AssertionError("MutanAtt: %d steps" % state.step)
    log("  stage seconds: %s (%s)" % ({k: round(v, 2) for k, v in
                                        seconds.items()}, card))
    log("  phase 12: " + memory_line(card))


# the card's host has no libjpeg (no jpeglib.h, no libjpeg.so; ROADMAP.md,
# "Constraints of the card's host"), so the native decoder cannot be built
# there: phase 13 decodes with PIL, which it has.  Where a host has
# libjpeg, set this and the phase builds the decoder and checks it too.
CARD_HOST_HAS_LIBJPEG = False
EXTRACT_IMAGES, EXTRACT_BATCH, RAW_IMAGES = 400, 80, 240
SERVE_CLIENTS, SERVE_REQUESTS = 16, 8


def check_fixture_digests(decoder):
    """Decode the committed fixtures at 448 (``decoder`` None: PIL for
    all) and hold each to its recorded SHA-256."""
    from vqa_counterexamples_tpu_torch.data import image_fixtures
    from vqa_counterexamples_tpu_torch.data.native_decoder import (
        decode_files)

    want = image_fixtures.load_digests()
    out = decode_files(decoder, image_fixtures.fixture_paths(), 448)
    got = {name: image_fixtures.digest(o)
           for (name, *_), o in zip(image_fixtures.SHAPES, out)}
    bad = sorted(k for k in want if got.get(k) != want[k])
    log("  fixtures through %s: %d of %d match their recorded SHA-256%s"
        % ("the native decoder (PIL for the PNG)" if decoder else "PIL",
           len(want) - len(bad), len(want),
           "" if not bad else "; DIFFERENT: %s" % bad))
    if bad:
        raise AssertionError("decoded fixtures differ from their digests")


def trunk_batch_equal(att_file, model, images, dev, what):
    """A direct trunk call on ``images`` (the CLI's first batch) against
    the extracted rows, bit for bit."""
    from vqa_counterexamples_tpu_torch.models import convnets

    with torch.no_grad():
        x = torch.from_numpy(images).to(dev)
        if x.dtype == torch.uint8:
            x = convnets.normalize_images_device(x)
        direct = model(x).cpu().numpy()
    rows = np.asarray(att_file[:len(images)])
    equal = np.array_equal(direct, rows)
    log("  %s: the first batch against a direct trunk call: %s" % (
        what, "bit-equal" if equal else "DIFFERENT (max %.3e)"
        % np.abs(direct - rows).max()))
    if not equal:
        raise AssertionError("%s: extraction differs from the trunk" % what)


def phase_extract(dev, card, root):
    """Phase 13a-b: the fixtures' decode, then ``cli.extract`` at
    ResNet-152 / 448 / B 80 on synthetic images and on a raw folder."""
    import shutil

    from vqa_counterexamples_tpu_torch.cli import extract
    from vqa_counterexamples_tpu_torch.data import image_fixtures
    from vqa_counterexamples_tpu_torch.data import native_decoder
    from vqa_counterexamples_tpu_torch.models import convnets

    # a. the decoder
    if CARD_HOST_HAS_LIBJPEG:
        native = native_decoder.NativeImageDecoder()
        if not native.available:
            raise AssertionError("the native decoder did not build")
        check_fixture_digests(native)
    else:
        log("  native decoder: not built (no libjpeg on this host); "
            "decoding with PIL")
    check_fixture_digests(None)

    # b. extraction, synthetic
    model = convnets.init_resnet(convnets.factory({"arch": "fbresnet152"}))
    model.to(dev).eval()
    stats = {}
    t0 = time.perf_counter()
    prefix = extract.main([
        "--synthetic", str(EXTRACT_IMAGES), "-b", str(EXTRACT_BATCH),
        "--arch", "fbresnet152", "--size", "448", "--mode", "both",
        "--dir_data", os.path.join(root, "synthetic")], stats=stats)
    seconds = time.perf_counter() - t0
    att = np.load(prefix + ".att.npy", mmap_mode="r")
    noatt = np.load(prefix + ".npy")
    with open(prefix + ".txt") as f:
        names = f.read().splitlines()
    mean = np.asarray(att, dtype=np.float64).mean(axis=(1, 2))
    mean_err = np.abs(mean - noatt).max() / np.abs(mean).max()
    log("  extract --synthetic %d -b %d (fbresnet152, 448): %.2f s; att %s "
        "noatt %s, %d names; .npy vs the spatial mean of .att.npy: %.3e of "
        "its largest entry; stats %s (%s)"
        % (EXTRACT_IMAGES, EXTRACT_BATCH, seconds, att.shape, noatt.shape,
           len(names), mean_err, stats, card))
    if (att.shape != (EXTRACT_IMAGES, 14, 14, 2048)
            or noatt.shape != (EXTRACT_IMAGES, 2048)
            or len(names) != EXTRACT_IMAGES or mean_err > 1e-5
            or not np.isfinite(noatt).all()):
        raise AssertionError("synthetic extraction: wrong files")
    images = np.random.default_rng(0).normal(
        size=(EXTRACT_BATCH, 448, 448, 3)).astype(np.float32)
    trunk_batch_equal(att, model, images, dev, "synthetic")
    del att

    # b.4 extraction of a raw COCO folder made from the fixtures
    img_dir = os.path.join(root, "raw_coco", "raw", "train2014")
    os.makedirs(img_dir)
    sources = image_fixtures.fixture_paths()
    for i in range(RAW_IMAGES):
        src = sources[i % len(sources)]
        shutil.copyfile(src, os.path.join(img_dir, "COCO_train2014_%012d%s"
                                          % (i, os.path.splitext(src)[1])))
    stats = {}
    t0 = time.perf_counter()
    prefix = extract.main([
        "-b", str(EXTRACT_BATCH), "--arch", "fbresnet152", "--size", "448",
        "--dir_data", os.path.join(root, "raw_coco")], stats=stats)
    seconds = time.perf_counter() - t0
    att = np.load(prefix + ".att.npy", mmap_mode="r")
    with open(prefix + ".txt") as f:
        names = f.read().splitlines()
    log("  extract of %d raw images (%d of them PNG): %.2f s; att %s; stats "
        "%s (%s)" % (RAW_IMAGES, sum(n.endswith(".png") for n in names),
                     seconds, att.shape, stats, card))
    if att.shape != (RAW_IMAGES, 14, 14, 2048) or len(names) != RAW_IMAGES:
        raise AssertionError("raw extraction: wrong files")
    first = native_decoder.decode_files(
        None, [os.path.join(img_dir, n) for n in names[:EXTRACT_BATCH]], 448)
    trunk_batch_equal(att, model, first, dev, "raw folder")
    del att, model


def fixture_items(n):
    """``n`` request items: the fixtures as base64, questions of the
    synthetic vocab."""
    import base64

    from vqa_counterexamples_tpu_torch.data import image_fixtures

    paths = image_fixtures.fixture_paths()
    items = []
    for i in range(n):
        with open(paths[i % len(paths)], "rb") as f:
            visual = base64.b64encode(f.read()).decode()
        items.append({"visual": visual, "question":
                      "w%d w%d w%d ?" % (i, 3 * i + 1, 7 * i + 2)})
    return items


def engine_checks(engine, options, attention, card,
                  buckets=(1, 2, 4, 8, 16, 32)):
    """Phase 13c (and 14e) on one engine: six captured buckets, captured
    against eager at each of ``buckets`` (bit for bit), exact launch
    counts (the GRU forward, and MUTAN and the folded forward where the
    arch has them), ms a call; ``answer_batch`` of 3 against ``answer`` of
    each, with a PNG per glimpse."""
    from vqa_counterexamples_tpu_torch.cli.profile_cx import profile_calls
    from vqa_counterexamples_tpu_torch.data import synthetic
    from vqa_counterexamples_tpu_torch.serve.demo_server import DemoEngine

    if engine.n_graphs != 6:
        raise AssertionError("prewarm captured %d buckets, not 6"
                             % engine.n_graphs)
    # the same models, run eagerly
    eager = DemoEngine(options, engine.vqa_model, engine.cnn,
                       *synthetic.synthetic_vocab(2000,
                                                  options["vqa"]["nans"]),
                       attention, capture=False)
    arch = options["model"]["arch"]
    want = {"gru": 1, "mutan": int(arch.startswith("Mutan")),
            "attmutan": int(arch == "MutanAtt")}
    want = {k: want.get(k, 0) for k in SOURCES}
    glimpses = (options["model"]["attention"]["nb_glimpses"] if attention
                else 0)
    rng = np.random.default_rng(SEED)
    for bucket in buckets:
        images = rng.integers(0, 256, (bucket, 448, 448, 3), dtype=np.uint8)
        lengths = rng.integers(3, 15, bucket)
        wids = np.where(np.arange(26)[None] < lengths[:, None],
                        rng.integers(1, 2001, (bucket, 26)), 0).astype(
                            np.int32)
        outs = {}
        for label, eng in (("captured", engine), ("eager", eager)):
            reset_counters()
            outs[label] = eng.predict_prepared(images, wids)
            got = read_counters()
            if got != want:
                raise AssertionError("bucket %d, %s: launches %s, expected %s"
                                     % (bucket, label, got, want))
        same = all(np.array_equal(a, b) for a, b in zip(outs["captured"],
                                                         outs["eager"]))
        timing = {}
        for label, eng in (("captured", engine), ("eager", eager)):
            eng.predict_prepared(images, wids)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                eng.predict_prepared(images, wids)
            timing[label] = (time.perf_counter() - t0) / 5 * 1e3
        log("  bucket %2d: captured %s eager; launches a call %s; %.3f ms a "
            "call captured (%.1f images/s), %.3f eager (%s)"
            % (bucket, "bit-equal to" if same else "DIFFERENT from",
               {k: v for k, v in want.items() if v}, timing["captured"],
               bucket / timing["captured"] * 1e3, timing["eager"], card))
        if not same:
            raise AssertionError("bucket %d: captured and eager differ"
                                 % bucket)
        if bucket in (1, 32):
            r = profile_calls(lambda: engine.predict_prepared(images, wids),
                              3, 1)
            log("    profiled (captured): %.3f ms a call, device busy %.3f "
                "ms, idle share %.1f%%, %.1f kernels a call; device ms by "
                "group %s" % (r["wall_ms_profiled"], r["device_busy_ms"],
                              100 * r["idle_share_profiled"], r["launches"],
                              {k: round(v, 3) for k, v in
                               r["device_ms_by_group"].items()}))
        vals = outs["captured"][0]
        if not (np.isfinite(vals).all() and (vals >= 0).all()
                and (vals <= 1).all()):
            raise AssertionError("bucket %d: probabilities out of range"
                                 % bucket)
    items = fixture_items(3)
    batch = engine.answer_batch(items)
    swaps = 0
    for item, got in zip(items, batch):
        one = engine.answer(item["visual"], item["question"])
        if not (top5_agree(one, got) and top5_agree(got, one)):
            raise AssertionError("answer vs answer_batch: %s vs %s"
                                 % (one, got))
        swaps += one["ans"] != got["ans"]
        if len(got["att"]) != glimpses:
            raise AssertionError("%d glimpses" % len(got["att"]))
    log("  answer_batch of 3 against answer of each: vals within 1e-3, "
        "top-5 ids equal (%d of 3 with near-tied candidates in swapped "
        "places); %d glimpse PNGs an item" % (swaps, len(batch[0]["att"])))


def top5_agree(a, b, rel=1e-3):
    """Two answers to one item, from two buckets: the vals within JAX's
    1e-3 at every rank, and the ids equal but where candidates whose
    probabilities agree to ``rel`` (bf16 logits a rounding step apart,
    common among 2,000 answers at random weights) trade places, or the
    fifth place goes to such a candidate."""
    if np.abs(np.subtract(a["val"], b["val"])).max() > 1e-3:
        return False

    def close(p, q):
        return abs(p - q) <= rel * max(p, q)

    for r, name in enumerate(a["ans"]):
        if name == b["ans"][r]:
            continue
        if name in b["ans"]:
            if not close(a["val"][r], b["val"][b["ans"].index(name)]):
                return False
        elif r != 4 or not close(a["val"][4], b["val"][4]):
            return False
    return True


def post(url, payload):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=120) as resp:
        return json.loads(resp.read())


@contextlib.contextmanager
def serving(server):
    import threading

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield "http://127.0.0.1:%d" % server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)


def load_test(url, label, card):
    """SERVE_CLIENTS threads x SERVE_REQUESTS POST / each: items/s and the
    p50 / p99 latency."""
    import threading

    items = fixture_items(SERVE_CLIENTS)
    lat, errors = [], []

    def client(i):
        for _ in range(SERVE_REQUESTS):
            t = time.perf_counter()
            try:
                out = post(url + "/", items[i])
                if len(out.get("ans", ())) != 5:
                    errors.append(out)
            except Exception as exc:  # noqa: BLE001 — counted, then raised
                errors.append(exc)
            lat.append(time.perf_counter() - t)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_CLIENTS)]
    # the handler's per-request log lines are dropped meanwhile
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError("%s: %d failed requests: %s"
                             % (label, len(errors), errors[:3]))
    ms = np.sort(np.asarray(lat)) * 1e3
    log("  %d clients x %d requests, --batcher %s: %.2f items/s, p50 %.2f "
        "ms, p99 %.2f ms (%s)" % (SERVE_CLIENTS, SERVE_REQUESTS, label,
                                  len(ms) / wall, np.percentile(ms, 50),
                                  np.percentile(ms, 99), card))


def http_checks(server, root, card):
    """Phase 13d: every route of the server, the hot swap and back, then
    the load of SERVE_CLIENTS threads with the batcher off and adaptive."""
    from vqa_counterexamples_tpu_torch.serve.demo_server import (
        DemoHTTPServer, MicroBatcher, make_handler)

    engine = server.engine
    items = fixture_items(3)
    with serving(server) as url:
        if get(url + "/health") != {"ok": True}:
            raise AssertionError("/health")
        listed = [c["name"] for c in get(url + "/checkpoints")["checkpoints"]]
        if listed != ["a_original", "b_perturbed"]:
            raise AssertionError("/checkpoints: %s" % listed)
        first = post(url + "/", items[0])
        batch = post(url + "/batch", {"items": items})["results"]
        post(url + "/checkpoint", {"name": "b_perturbed"})
        swapped = post(url + "/", items[0])
        post(url + "/checkpoint", {"name": "a_original"})
        back = post(url + "/", items[0])
        log("  routes: /health, /checkpoints %s, POST / %s, /batch of %d, "
            "/checkpoint b_perturbed: answers %s, back to a_original: %s; "
            "graphs %d" % (listed, first["ans"], len(batch),
                           "changed" if swapped["val"] != first["val"]
                           else "UNCHANGED",
                           "bit-equal" if back == first else "DIFFERENT",
                           engine.n_graphs))
        if (swapped["val"] == first["val"] or back != first
                or not top5_agree(batch[0], first)
                or not top5_agree(first, batch[0]) or engine.n_graphs != 6):
            raise AssertionError("the hot swap or /batch went wrong")
        load_test(url, "off", card)
    batcher = MicroBatcher(engine, adaptive=True)
    adaptive = DemoHTTPServer(("127.0.0.1", 0), make_handler(
        engine, None, root, batcher))
    with serving(adaptive) as url:
        load_test(url, "adaptive", card)


def phase_serve(dev, card):
    """Phase 13: extraction and serving at full width (see the module
    docstring)."""
    from vqa_counterexamples_tpu_torch.core import checkpoint
    from vqa_counterexamples_tpu_torch.core import config as config_lib
    from vqa_counterexamples_tpu_torch.data import synthetic
    from vqa_counterexamples_tpu_torch.engines import vqa_engine
    from vqa_counterexamples_tpu_torch.models import factory
    from vqa_counterexamples_tpu_torch.serve import demo_server

    log("== phase 13: extraction and the demo server at full width")
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        phase_extract(dev, card, root)
        torch.cuda.empty_cache()
        for config, attention in ((NOATT_CONFIG, False), (ATT_CONFIG, True)):
            options = config_lib.resolve_options({}, config, {})
            ckpt_root = os.path.join(root, "runs_%s" % attention)
            model = factory.factory_vqa(options["model"],
                                        *synthetic.synthetic_vocab(
                                            2000, options["vqa"]["nans"]))
            vqa_engine.init_vqa_params(model, seed=0)   # main's weights
            model.to(dev)
            for name in ("a_original", "b_perturbed"):
                state = vqa_engine.init_vqa_state(model)
                checkpoint.save_vqa_checkpoint(
                    {"epoch": 1, "best_acc1": 0.0}, state,
                    os.path.join(ckpt_root, name), is_best=True)
                with torch.no_grad():
                    for p in model.parameters():
                        p.add_(0.05 * torch.randn_like(p))
            del model, state
            t0 = time.perf_counter()
            server = demo_server.create_server([
                "--path_opt", config, "--port", "0", "--prewarm",
                "--ckpt_root", ckpt_root])
            log("  %s: server built, six buckets captured in %.2f s"
                % (options["model"]["arch"], time.perf_counter() - t0))
            try:
                engine_checks(server.engine, options, attention, card)
                if not attention:
                    http_checks(server, ckpt_root, card)
            finally:
                server.server_close()
            del server
            torch.cuda.empty_cache()
    log("  phase 13: %.1f s; %s" % (time.perf_counter() - t_phase,
                                    memory_line(card)))


# phase 14's configurations: the reference's default VQA model (MLBNoAtt,
# UniSkip) and MLBAtt (BayesianUniSkip, 4 glimpses), at their YAMLs' widths
MLB_NOATT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "configs", "vqa2", "default.yaml")
MLB_ATT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "configs", "vqa2", "mlb_att_trainval.yaml")
# mlb_noatt_train.yaml is default.yaml under another log dir (its base)
MLB_NOATT_TRAIN_CONFIG = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "configs", "vqa2",
    "mlb_noatt_train.yaml")


def vqa_experiment(name):
    from vqa_counterexamples_tpu_torch.core.experiment import Experiment
    from vqa_counterexamples_tpu_torch.core.meters import AvgMeter

    exp = Experiment(name)
    for tag in ("train", "val"):
        exp.add_meters(tag, {k: AvgMeter() for k in (
            "loss", "acc1", "acc5", "batch_time", "data_time")})
    return exp


def counted_pretrain(label, model, loader, val_loader, want, exp):
    """The main path of a pretraining cell, counted: one epoch of
    ``train_epoch`` (captured steps) and a ``validate``, every launch
    counter zeroed just before and read just after; ``want(steps,
    val_batches)`` names the counts of the kernels that must move (the
    others must stay 0); every loss finite.  -> the train state."""
    from vqa_counterexamples_tpu_torch.engines import vqa_engine

    state = vqa_engine.init_vqa_state(model, lr=1e-4)
    step = vqa_engine.make_vqa_train_step(model, state.optimizer,
                                          base_seed=SEED)
    eval_step = vqa_engine.make_vqa_eval_step(model)
    rows = []
    torch.cuda.synchronize()
    reset_counters()
    state = vqa_engine.train_epoch(recorded(step, rows, ("loss", "acc1")),
                                   state, loader(np.random.default_rng(SEED)),
                                   exp, 1, print_freq=10 ** 9)
    batches = list(val_loader())
    val_batches = len(batches)
    res = vqa_engine.validate(eval_step, batches, exp, 1)
    torch.cuda.synchronize()
    launches = read_counters()
    expect = {k: 0 for k in SOURCES}
    expect.update(want(state.step, val_batches))
    log("  %s: %d train steps, %d val batches, val %s; launches %s"
        % (label, state.step, val_batches, res, launches))
    if launches != expect:
        raise AssertionError("%s: launch counts %s, expected %s"
                             % (label, launches, expect))
    losses = torch.cat(rows)[:, 0].cpu().numpy()
    log("  losses: %s" % ["%.4f" % x for x in losses])
    if len(losses) != state.step or not np.isfinite(losses).all() or not (
            np.isfinite(res["loss"]) and 0 <= res["acc1"] <= res["acc5"]):
        raise AssertionError("%s: bad losses %s or val %s"
                             % (label, losses, res))
    state.step_fn = step
    return state


def grads_vs_plain(label, model, batch, dev, shift_free=()):
    """One step's gradients of every parameter through the kernels against
    the plain versions, dropout on (the same masks), within phase 5's
    bound of each tensor's largest entry; ``shift_free`` parameters (a
    softmax cannot see them: their gradient is 0 up to rounding) are
    skipped."""
    got = pretrain_grads(model, batch, dev, plain=False)
    ref = pretrain_grads(model, batch, dev, plain=True)
    worst, worst_name = 0.0, ""
    for name in (n for n in got if n not in shift_free):
        scale = ref[name].abs().max().item()
        err = (got[name] - ref[name]).abs().max().item() / max(scale, 1e-30)
        if err > worst:
            worst, worst_name = err, name
        if not (torch.isfinite(got[name]).all()
                and err <= TOL["pretrain_grads_rel"]):
            raise AssertionError("%s grad %s: kernel path vs plain path, max "
                                 "error %.3e of the largest entry"
                                 % (label, name, err))
    log("  %s grads of %d tensors (dropout on): kernel path vs plain path, "
        "worst max error %.3e of the largest entry (%s; bound %g): ok"
        % (label, len(got) - len(shift_free), worst, worst_name,
           TOL["pretrain_grads_rel"]))
    model.zero_grad(set_to_none=True)


def train_cli_run(config, n, batch_size, dev, kernels):
    """``cli.train.main`` for one epoch on ``n`` synthetic examples: the
    checkpoint files, the val (or, for a trainval YAML, test) rows, the
    steps, and ``kernels``' counters moving."""
    from vqa_counterexamples_tpu_torch.cli import train
    from vqa_counterexamples_tpu_torch.core import config as config_lib

    trainval = config_lib.load_options_file(config)["vqa"][
        "trainsplit"] == "trainval"
    reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        state = train.main([
            "--path_opt", config, "--synthetic", str(n), "--epochs", "1",
            "-b", str(batch_size), "--seed", str(SEED), "--device", str(dev),
            "--dir_logs", tmp])
        files = sorted(f for f in os.listdir(tmp)
                       if os.path.isfile(os.path.join(tmp, f)))
        split = "test2015" if trainval else "val"
        with open(os.path.join(tmp, "results", split,
                               "vqa_OpenEnded_mscoco_epoch_1.json")) as f:
            rows = json.load(f)
    launches = read_counters()
    log("  cli.train %s: %s, %d steps, files %s, %d %s rows; launches %s"
        % (os.path.basename(config), type(state.model).__name__, state.step,
           files, len(rows), split, launches))
    if (not {"ckpt_info.json", "ckpt_model.msgpack", "ckpt_optim.msgpack",
             "logger.json"} <= set(files)
            or state.step != n // batch_size or not rows
            or min(launches[k] for k in kernels) <= 0):
        raise AssertionError("bad CLI run of %s" % config)


def phase_mlb_noatt(dev, card):
    """14a: MLBNoAtt pretraining at ``configs/vqa2/default.yaml``."""
    from vqa_counterexamples_tpu_torch.cli.profile_vqa import flagship_vqa
    from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays
    from vqa_counterexamples_tpu_torch.engines import vqa_engine

    log("== phase 14a: MLBNoAtt pretraining at default.yaml's width")
    torch.cuda.reset_peak_memory_stats()
    batch_size = 512
    model, examples, store, _ = flagship_vqa(seed=SEED,
                                             path_opt=MLB_NOATT_CONFIG)
    if type(model).__name__ != "MLBNoAtt" or model.seq2vec.bayesian:
        raise AssertionError("default.yaml: not MLBNoAtt over UniSkip")
    model.to(dev)
    arrays = VQAArrays(examples, store, samplingans=True)
    val = VQAArrays(examples[:1024], store)
    feats = store.to_device(dev)

    def loader(rng):
        return arrays.batches(batch_size, shuffle=True, rng=rng,
                              drop_remainder=True, device_features=feats)

    def val_loader():
        return val.batches(batch_size, shuffle=False, drop_remainder=True,
                           device_features=feats)

    exp = vqa_experiment("chip_smoke_mlb")
    # UniSkip in training: the forward with h_proj and no mask (the "gru"
    # counter), then the backward with no mask; each val batch the forward
    counted_pretrain("MLBNoAtt", model, loader, val_loader,
                     lambda st, vb: {"gru": st + vb, "gru_bwd": st}, exp)
    batch = vqa_engine.batch_to_device(next(val_loader()), dev)
    grads_vs_plain("MLBNoAtt", model, batch, dev)
    compare_vqa("MLBNoAtt", model, loader, arrays.size // batch_size, exp,
                card, batch["question"].shape[1])
    for config in (MLB_NOATT_CONFIG, MLB_NOATT_TRAIN_CONFIG):
        train_cli_run(config, 2048, batch_size, dev, ("gru", "gru_bwd"))
    log("  phase 14a: " + memory_line(card))
    return model.vocab_words, model.vocab_answers, examples, store, feats


def write_att_store(root, name, store, bf16=False):
    """``store``'s maps as ``<root>/<name>.att.npy`` (f32, or bf16 as the
    uint16 bit-view ``cli/extract.py --feat-dtype bfloat16`` writes) and
    its ``.txt``, loaded back lazily -> the on-disk store."""
    from vqa_counterexamples_tpu_torch.data.features import FeatureStore

    prefix = os.path.join(root, name)
    maps = store.features
    if bf16:
        maps = torch.from_numpy(maps).to(torch.bfloat16).view(
            torch.int16).numpy().view(np.uint16)
    np.save(prefix + ".att.npy", maps)
    with open(prefix + ".txt", "w") as f:
        f.write("\n".join(store.names) + "\n")
    return FeatureStore.load(prefix, dataset="att")


def store_ab(model, examples, disk, numpy_store, batch_size, dev, card):
    """MutanAtt's captured step through the native store and through the
    four-thread numpy gather over the same file, in turns (native, numpy,
    numpy, native), two epochs each after a warm one: wall ms a step."""
    from vqa_counterexamples_tpu_torch.data.vqa_dataset import (
        GATHER_THREADS, VQAArrays)
    from vqa_counterexamples_tpu_torch.engines import vqa_engine

    state = vqa_engine.init_vqa_state(model, lr=1e-4)
    step = vqa_engine.make_vqa_train_step(model, state.optimizer,
                                          base_seed=SEED)
    exp = vqa_experiment("chip_smoke_store")
    rng = np.random.default_rng(SEED)
    ms = {"native": [], "numpy": []}
    for name in ("native", "numpy", "numpy", "native"):
        arrays = VQAArrays(examples, disk if name == "native"
                           else numpy_store, samplingans=True)
        if arrays.gather_path != name:
            raise AssertionError("%s gather expected, %s served"
                                 % (name, arrays.gather_path))

        def epoch():
            return vqa_engine.train_epoch(step, state, arrays.batches(
                batch_size, shuffle=True, rng=rng, drop_remainder=True,
                device=dev), exp, 0, print_freq=10 ** 9)

        epoch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            epoch()
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3
                        / (2 * (arrays.size // batch_size)))
    log("  MutanAtt captured train step, B %d, maps gathered on the host: "
        "native store %s ms a step, numpy gather (%d threads) %s ms a step "
        "(in turns native, numpy, numpy, native; %s)"
        % (batch_size, ["%.3f" % x for x in ms["native"]],
           GATHER_THREADS, ["%.3f" % x for x in ms["numpy"]], card))


def phase_mlb_att(dev, card):
    """14b: MLBAtt pretraining at ``configs/vqa2/mlb_att_trainval.yaml``
    over maps read through the native store, a bf16 epoch, and the store
    against the numpy gather under MutanAtt."""
    from vqa_counterexamples_tpu_torch.cli.profile_vqa import flagship_vqa
    from vqa_counterexamples_tpu_torch.core import config as config_lib
    from vqa_counterexamples_tpu_torch.data.features import FeatureStore
    from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays
    from vqa_counterexamples_tpu_torch.engines import vqa_engine
    from vqa_counterexamples_tpu_torch.models import factory

    log("== phase 14b: MLBAtt pretraining at mlb_att_trainval.yaml's width, "
        "maps through the native store")
    torch.cuda.reset_peak_memory_stats()
    batch_size = 128
    model, examples, store, _ = flagship_vqa(seed=SEED,
                                             path_opt=MLB_ATT_CONFIG,
                                             n_examples=1024)
    if (type(model).__name__ != "MLBAtt" or not model.seq2vec.bayesian
            or len(model.list_linear_v_fusion) != 4):
        raise AssertionError("mlb_att_trainval.yaml: not a 4-glimpse MLBAtt")
    model.to(dev)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        disk = write_att_store(root, "trainset", store)
        log("  %d maps %s written as .att.npy (%.0f MB f32) in %.1f s; "
            "gather path: %s" % (len(disk), disk.row_shape,
                                 os.path.getsize(os.path.join(
                                     root, "trainset.att.npy")) / 1e6,
                                 time.perf_counter() - t0, disk.gather_path))
        if disk.gather_path != "native":
            raise AssertionError("the native store did not serve 14b")
        arrays = VQAArrays(examples, disk, samplingans=True)
        val = VQAArrays(examples[:256], disk)

        def loader(rng, data=arrays):
            return data.batches(batch_size, shuffle=True, rng=rng,
                                drop_remainder=True, device=dev)

        def val_loader():
            return val.batches(batch_size, shuffle=False,
                               drop_remainder=True, device=dev)

        exp = vqa_experiment("chip_smoke_mlb_att")
        want = lambda st, vb: {"gru_pg": st, "gru_bwd": st, "gru": vb}
        state = counted_pretrain("MLBAtt", model, loader, val_loader, want,
                                 exp)
        if disk.outstanding:
            raise AssertionError("prefetch tickets left outstanding")
        batch = vqa_engine.batch_to_device(next(val_loader()), dev)
        grads_vs_plain("MLBAtt", model, batch, dev,
                       shift_free=("conv_att.bias",))
        compare_vqa("MLBAtt", model, loader, arrays.size // batch_size, exp,
                    card, batch["question"].shape[1])
        # one epoch on the bf16 copy of the maps
        disk_bf = write_att_store(root, "trainset_bf16", store, bf16=True)
        arrays_bf = VQAArrays(examples, disk_bf, samplingans=True)
        first = next(loader(np.random.default_rng(SEED), arrays_bf))
        rows = []
        reset_counters()
        state = vqa_engine.train_epoch(
            recorded(state.step_fn, rows, ("loss", "acc1")), state,
            loader(np.random.default_rng(SEED), arrays_bf), exp, 2,
            print_freq=10 ** 9)
        torch.cuda.synchronize()
        losses = torch.cat(rows)[:, 0].cpu().numpy()
        launches = read_counters()
        log("  bf16 maps (%.0f MB, %s gather, batches %s): %d steps, losses "
            "%s, launches %s" % (
                os.path.getsize(os.path.join(root, "trainset_bf16.att.npy"))
                / 1e6, arrays_bf.gather_path, first["visual"].dtype,
                len(losses), ["%.4f" % x for x in losses], launches))
        if (first["visual"].dtype != torch.bfloat16
                or arrays_bf.gather_path != "native"
                or not np.isfinite(losses).all() or len(losses) != 8
                or launches["gru_pg"] != 8 or launches["gru_bwd"] != 8):
            raise AssertionError("the bf16 epoch went wrong")
        words, answers = model.vocab_words, model.vocab_answers
        del model, state, first
        torch.cuda.empty_cache()
        # the store's effect, under MutanAtt at mutan_att_train.yaml, B 128
        att_opt = config_lib.load_options_file(ATT_CONFIG)["model"]
        mutan = vqa_engine.init_vqa_params(
            factory.factory_vqa(att_opt, words, answers), seed=SEED).to(dev)
        numpy_store = FeatureStore(
            np.load(os.path.join(root, "trainset.att.npy"), mmap_mode="r"),
            disk.names)
        store_ab(mutan, examples, disk, numpy_store, batch_size, dev, card)
        del mutan
        torch.cuda.empty_cache()
    train_cli_run(MLB_ATT_CONFIG, 1024, batch_size, dev,
                  ("gru", "gru_pg", "gru_bwd"))
    log("  phase 14b: " + memory_line(card))


def phase_mlb_cx(dev, card):
    """14c: NeuralCX over the MLBNoAtt backbone at the flagship CX width,
    the q / v / z caches on (z 1200 wide)."""
    from vqa_counterexamples_tpu_torch.core import config as config_lib
    from vqa_counterexamples_tpu_torch.data import synthetic, vqacx
    from vqa_counterexamples_tpu_torch.engines import cx_engine
    from vqa_counterexamples_tpu_torch.models import factory

    log("== phase 14c: NeuralCX over the MLBNoAtt backbone")
    torch.cuda.reset_peak_memory_stats()
    batch_size = 768
    dataset, store = synthetic.make_synthetic_cx(
        n_examples=2048, n_images=1024, dim_v=2048, knn_size=24,
        n_answers=2000, seed=SEED)
    arrays = vqacx.CXArrays.from_examples(dataset["examples_list"],
                                          dataset["name_to_index"])
    vqa = factory.factory_vqa(
        config_lib.load_options_file(MLB_NOATT_CONFIG)["model"],
        dataset["vocab_words"], dataset["vocab_answers"])
    spec = dict(dim_h=300, n_layers=2, drop_p=0.25, v_emb=True, v_mult=True,
                v_dist=True, v_rank=True, q_emb=True, a_emb=True, z_emb=True,
                pretrained_emb=False, trainable_vqa=False)
    model = cx_engine.init_cx_params(factory.factory_cx(
        "NeuralModel", vqa, knn_size=24, model_spec=spec), seed=SEED).to(dev)
    head_opt = model.vqa_model.opt["classif"]
    act = head_opt.pop("activation")
    gate_without_tanh = model._fused_head_ok()
    head_opt["activation"] = act
    log("  vfeat gate %s; fused head gate %s (%s without the head's %s)"
        % (model.wants_table_features(), model._fused_head_ok(),
           gate_without_tanh, act))
    if (not model.wants_table_features() or model._fused_head_ok()
            or not gate_without_tanh):
        raise AssertionError("the gates: vfeat on, the fused head off by "
                             "the tanh alone")
    features = store.to_device(dev)
    val = vqacx.CXArrays(*(a[:batch_size] for a in arrays))
    state = cx_engine.init_cx_state(model, lr=1e-4)
    train_step = cx_engine.make_cx_train_step(model, state.optimizer,
                                              base_seed=SEED,
                                              use_z_cache=True)
    eval_step = cx_engine.make_cx_eval_step(model, use_z_cache=True)
    losses, evals = [], []
    torch.cuda.synchronize()
    # --- the main path, counted ---
    reset_counters()
    q, _, z, stage_s = cx_engine.build_frozen_caches(
        model, features, arrays, use_q=True, use_v=False, use_z=True)
    feats_bf, q, _, z = cx_engine.make_tables_bf16_resident(features, q,
                                                           None, z)

    def run_eval(_state):
        evals.append(cx_engine.eval_model(eval_step, feats_bf, val,
                                          batch_size, q_table=q, z_table=z))
        return evals[-1]

    state, res = cx_engine.train_epoch(
        train_step, state, feats_bf, arrays, batch_size,
        rng=np.random.default_rng(SEED),
        log_fn=lambda b, m: losses.append(m["loss"]), print_freq=1,
        eval_fn=run_eval, q_table=q, z_table=z)
    torch.cuda.synchronize()
    launches = read_counters()
    steps = state.step
    eval_batches = len(evals) * -(-val.size // batch_size)
    log("  caches q %s z %s (stages %s); %d steps, %d eval batches, val %s; "
        "launches %s" % (tuple(q.shape), tuple(z.shape),
                         {k: round(v, 4) for k, v in stage_s.items()}, steps,
                         eval_batches, res, launches))
    want = {k: 0 for k in SOURCES}
    want.update(gru=1, vfeat=steps + eval_batches, vfeat_bwd=steps)
    if launches != want:
        raise AssertionError("launch counts %s, expected %s"
                             % (launches, want))
    losses = [float(x) for x in losses]
    if (tuple(z.shape) != (2048, 25, 1200) or len(losses) != steps
            or not np.isfinite(losses).all()):
        raise AssertionError("z %s, losses %s" % (tuple(z.shape), losses))
    compare_cx(model, feats_bf, q, z, arrays, batch_size, card)
    log("  phase 14c: " + memory_line(card))


def phase_lstm(dev, card, words, answers, examples, store, feats):
    """14d: MLBNoAtt (default.yaml) over the LSTM encoders at the
    skip-thoughts widths (620 -> 2400; no published config names an LSTM
    width), B 512, 8 captured steps against 8 eager ones each."""
    import copy

    from vqa_counterexamples_tpu_torch.core import config as config_lib
    from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays
    from vqa_counterexamples_tpu_torch.engines import vqa_engine
    from vqa_counterexamples_tpu_torch.models import factory

    log("== phase 14d: the LSTM encoders (MLBNoAtt, 620 -> 2400, B 512)")
    torch.cuda.reset_peak_memory_stats()
    batch_size = 512
    arrays = VQAArrays(examples, store, samplingans=True)

    def loader(rng):     # two epochs: 8 steps
        for _ in range(2):
            yield from arrays.batches(batch_size, shuffle=True, rng=rng,
                                      drop_remainder=True,
                                      device_features=feats)

    exp = vqa_experiment("chip_smoke_lstm")
    for arch, width in (("lstm", 2400), ("2-lstm", 4800)):
        opt = copy.deepcopy(config_lib.load_options_file(
            MLB_NOATT_CONFIG)["model"])
        opt["seq2vec"] = {"arch": arch, "emb_size": 620, "hidden_size": 2400}
        opt["fusion"]["dim_q"] = width
        model = vqa_engine.init_vqa_params(
            factory.factory_vqa(opt, words, answers), seed=SEED).to(dev)
        # the captured step profiled over one pass of its 8 steps: the
        # steps are device-bound (eager within 3% of captured on an H100)
        rows, prof = compare_vqa("MLBNoAtt over %s" % arch, model, loader,
                                 2 * (arrays.size // batch_size), exp, card,
                                 26, passes=1, profiled=("captured",))
        if rows.shape[0] != 8 or not torch.isfinite(rows).all():
            raise AssertionError("%s: losses %s" % (arch, rows[:, 0]))
        log("  %s: losses %s; %.3f ms a step captured (%s)"
            % (arch, ["%.4f" % x for x in rows[:, 0].tolist()],
               prof["captured"]["wall_ms"], card))
        del model
        torch.cuda.empty_cache()
    log("  phase 14d: " + memory_line(card))


def phase_mlb_serve(dev, card):
    """14e: the demo server over MLBNoAtt and MLBAtt (their YAMLs, random
    weights): buckets 1 and 32 captured against eager, one HTTP round
    trip each."""
    from vqa_counterexamples_tpu_torch.core import config as config_lib
    from vqa_counterexamples_tpu_torch.serve import demo_server

    log("== phase 14e: the demo server over MLBNoAtt and MLBAtt")
    torch.cuda.reset_peak_memory_stats()
    for config, attention in ((MLB_NOATT_CONFIG, False),
                              (MLB_ATT_CONFIG, True)):
        options = config_lib.resolve_options({}, config, {})
        t0 = time.perf_counter()
        server = demo_server.create_server(["--path_opt", config, "--port",
                                            "0", "--prewarm"])
        log("  %s: server built, six buckets captured in %.2f s"
            % (options["model"]["arch"], time.perf_counter() - t0))
        try:
            engine_checks(server.engine, options, attention, card,
                          buckets=(1, 32))
            with serving(server) as url:
                out = post(url + "/", fixture_items(1)[0])
            glimpses = (options["model"]["attention"]["nb_glimpses"]
                        if attention else 0)
            log("  POST /: %s, %d glimpse PNGs" % (out["ans"],
                                                    len(out["att"])))
            if len(out["ans"]) != 5 or len(out["att"]) != glimpses:
                raise AssertionError("bad HTTP answer %s" % out)
        finally:
            server.server_close()
        del server
        torch.cuda.empty_cache()
    log("  phase 14e: " + memory_line(card))


def phase_mlb(dev, card):
    """Phase 14: the MLB family, the LSTM encoders and the native store;
    each part's seconds logged."""
    t_phase = t = time.perf_counter()
    seconds = {}

    def lap(name):
        nonlocal t
        seconds[name] = round(time.perf_counter() - t, 1)
        t = time.perf_counter()

    words, answers, examples, store, feats = phase_mlb_noatt(dev, card)
    lap("14a")
    phase_lstm(dev, card, words, answers, examples, store, feats)
    lap("14d")
    del store, feats
    phase_mlb_att(dev, card)
    lap("14b")
    phase_mlb_cx(dev, card)
    lap("14c")
    phase_mlb_serve(dev, card)
    lap("14e")
    log("  phase 14: %.1f s (%s)" % (time.perf_counter() - t_phase, seconds))


# ---------------------------------------------------------------- phase 15

def torch_flags():
    """The numerics flags ``main`` sets (a spawned rank sets them too)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def torchrun_env(rank=0, world=1):
    """torchrun's environment for one rank of ``world`` on this host."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"RANK": str(rank), "WORLD_SIZE": str(world),
           "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cx_epoch(dev, mesh, capture=None, parts=1):
    """Phase 2's data and the flagship model from the seed on ``dev``, the
    q / z caches, an epoch of train steps (dropout on, Adam at 1e-4, B
    768: the third batch 512 valid rows of 768) and an eval pass, under
    ``mesh`` (None: one rank), counted; step 1's gradients.  With
    ``model`` > 1 the bf16 feature matrix is row-sharded.  ``parts`` > 1
    (one rank): also the first batch's gradients as the sum of ``parts``
    ranks' (``step_grads``), before any step."""
    from vqa_counterexamples_tpu_torch import parallel
    from vqa_counterexamples_tpu_torch.data import synthetic, vqacx
    from vqa_counterexamples_tpu_torch.engines import cx_engine

    dataset, store = synthetic.make_synthetic_cx(
        n_examples=2048, n_images=1024, dim_v=2048, knn_size=24,
        n_answers=2000, seed=SEED)
    arrays = vqacx.CXArrays.from_examples(dataset["examples_list"],
                                          dataset["name_to_index"])
    model = flagship_model(dataset, dev)
    init = {n: p.detach().float().cpu().clone()
            for n, p in cx_engine.trainable_parameters(model)}
    torch.cuda.synchronize()
    reset_counters()
    q, _, z, _ = cx_engine.build_frozen_caches(
        model, store.to_device(dev), arrays, use_q=True, use_v=False,
        use_z=True)
    feats, q, _, z = cx_engine.make_tables_bf16_resident(
        store.to_device(dev), q, None, z)
    if mesh is not None and mesh.size("model") > 1:
        feats = parallel.shard_rows(feats, mesh)
    tables = dict(q_table=q, z_table=z)
    split = None
    if parts > 1:    # what the ranks' all-reduce adds up, made here
        idx, n_valid = next(vqacx.batch_indices(
            arrays.size, 768, shuffle=True,
            rng=np.random.default_rng(SEED + 1)))
        split = {n: g.float().cpu() for n, g in step_grads(
            model, feats, cx_engine.batch_to_device(
                vqacx.gather_batch(arrays, idx), dev), n_valid, q, z,
            parts=parts).items()}
        model.zero_grad(set_to_none=True)
    state = cx_engine.init_cx_state(model, lr=1e-4)
    step = cx_engine.make_cx_train_step(model, state.optimizer,
                                        base_seed=SEED, use_z_cache=True,
                                        capture=capture, mesh=mesh)
    rows, grads = [], {}

    def first_grads(*args, **kwargs):
        out = step(*args, **kwargs)
        if not grads:    # step 1's gradients (all-reduced under a mesh)
            grads.update({n: p.grad.detach().float().cpu().clone() for n, p
                          in cx_engine.trainable_parameters(model)})
        return out

    state, _ = cx_engine.train_epoch(
        recorded(first_grads, rows, ("loss", "correct")), state, feats,
        arrays, 768, rng=np.random.default_rng(SEED + 1), **tables)
    res = cx_engine.eval_model(
        cx_engine.make_cx_eval_step(model, use_z_cache=True,
                                    capture=capture, mesh=mesh),
        feats, arrays, 768, **tables)
    torch.cuda.synchronize()
    return dict(rows=rows, eval=res, counts=read_counters(), init=init,
                grads=grads, split=split, model=model, state=state,
                step=step, feats=feats, arrays=arrays, tables=tables)


def rank_counts(mesh):
    """Every rank's launch counters, (world, 10), on every rank."""
    from vqa_counterexamples_tpu_torch import parallel

    mine = torch.tensor([list(read_counters().values())], dtype=torch.int64,
                        device=mesh.device)
    return parallel.gather_rows(mine, mesh.rank, mesh.world_size, mesh,
                                None).cpu()


def require_counts(what, counts, want):
    """Each rank's row of ``counts`` must have moved every kernel of
    ``want``."""
    names = list(SOURCES)
    for rank, row in enumerate(counts.tolist()):
        missed = [k for k in want if row[names.index(k)] <= 0]
        if missed:
            raise AssertionError("%s: rank %d never launched %s (%s)"
                                 % (what, rank, missed, dict(zip(names,
                                                                 row))))


def time_allreduce(mesh, numel, reps=5):
    """ms of one all-reduce of ``numel`` f32 over the data group (the
    gradients' and the metrics' concatenation of a step)."""
    flat = torch.zeros(numel, device=mesh.device)
    mesh.all_reduce(flat, "data")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        mesh.all_reduce(flat, "data")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def rank_cx(axes):
    """A rank of phase 15b: :func:`cx_epoch` on ``cuda:0`` under gloo, its
    kernels counted on every rank, its trained parameters, then the ms of
    an eager step and of its all-reduce alone."""
    from vqa_counterexamples_tpu_torch import parallel
    from vqa_counterexamples_tpu_torch.data import vqacx
    from vqa_counterexamples_tpu_torch.engines import cx_engine

    torch_flags()
    with parallel.mesh_from_env(axes, "cuda", "gloo") as mesh:
        r = cx_epoch(mesh.device, mesh)
        counts = rank_counts(mesh)
        require_counts("CX %s" % axes, counts,
                       ("gru", "vfeat", "vfeat_bwd", "mixture"))
        params = {n: p.detach().float().cpu() for n, p in
                  cx_engine.trainable_parameters(r["model"])}
        batch = vqacx.gather_batch(r["arrays"], np.arange(768))
        reps = 3
        state = r["state"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            state, _ = r["step"](state, r["feats"], batch, 768,
                                 **r["tables"])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / reps * 1e3
        numel = sum(p.numel() for _, p in
                    cx_engine.trainable_parameters(r["model"])) + 2
        return dict(rows=torch.cat(r["rows"]).cpu(), eval=r["eval"],
                    counts=counts, params=params, grads=r["grads"],
                    step_ms=step_ms,
                    allreduce_ms=time_allreduce(mesh, numel),
                    eager=r["step"].graphed.eager_reason)


def rank_cli(module, argv, axes, want):
    """A rank of a CLI run, started as torchrun starts one: the numerics
    flags, the process group (gloo, every rank on ``cuda:0``), the CLI's
    ``main`` with ``--distributed``, then every rank's launch counters
    (each of ``want`` must have moved on every rank), the run's seconds
    and, where the CLI returned a train state, the ms of an all-reduce of
    its parameters' size."""
    import importlib

    from vqa_counterexamples_tpu_torch import parallel

    torch_flags()
    with parallel.mesh_from_env(axes, "cuda", "gloo") as mesh:
        reset_counters()
        t0 = time.perf_counter()
        out = importlib.import_module(module).main(
            argv + ["--distributed", "--dist_backend", "gloo"])
        seconds = time.perf_counter() - t0
        counts = rank_counts(mesh)
        require_counts(module, counts, want)
        allreduce_ms = None
        if hasattr(out, "model"):
            allreduce_ms = time_allreduce(mesh, sum(
                p.numel() for p in out.model.parameters()) + 3)
            out = out.step
        return dict(out=out, counts=counts, seconds=seconds,
                    allreduce_ms=allreduce_ms)


def spawn_ranks(fn, args, world):
    """``parallel.spawn`` of a phase-15 rank function -> (rank 0's result,
    seconds with the ranks' start-up)."""
    from vqa_counterexamples_tpu_torch import parallel

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = parallel.spawn(fn, args, world=world)
    return out, time.perf_counter() - t0


def held(what, got, ref, rel):
    """``|got - ref| <= rel |ref|`` or raise; returns the relative
    difference."""
    err = abs(got - ref) / max(abs(ref), 1e-30)
    if not err <= rel:
        raise AssertionError("%s: %r against one rank's %r (rel %.2e > %g)"
                             % (what, got, ref, err, rel))
    return err


def hold_to_one_rank(what, got, ref, card, seconds):
    """15b: the ranks' per-step losses, the eval results and the trained
    parameters against one rank's (sum order only); step 1's all-reduced
    gradients against the sum of the two halves' gradients made in this
    process (``step_grads(parts=2)``: the all-reduce must add them
    exactly), and, for the record, against one rank's."""
    tol = TOL["mesh"]
    losses = got["rows"][:, 0].tolist()
    ref_losses = torch.cat(ref["rows"]).cpu()[:, 0].tolist()
    worst = max(held("%s step %d loss" % (what, i), a, b, tol["loss_rel"])
                for i, (a, b) in enumerate(zip(losses, ref_losses)))
    for k in ("loss", "recall", "recall_1"):
        held("%s eval %s" % (what, k), got["eval"][k], ref["eval"][k],
             tol["loss_rel"] if k == "loss" else tol["recall_rel"])
    def grad_errs(ours, theirs):
        return {n: (ours[n] - g).abs().max().item()
                / max(g.abs().max().item(), 1e-30)
                for n, g in theirs.items()}

    split_err = max(grad_errs(got["grads"], ref["split"]).values())
    # against one rank: out.bias shifts all K scores alike, its gradient
    # is rounding noise
    one = grad_errs(got["grads"], ref["grads"])
    one.pop("out.bias")
    worst_one = sorted(one.items(), key=lambda kv: -kv[1])[:3]
    state = ref["model"].state_dict()
    names = sorted(ref["init"])
    param_err = max((got["params"][n] - state[n].detach().float().cpu())
                    .abs().max().item() for n in names)
    moved = torch.cat([(got["params"][n] - ref["init"][n]).reshape(-1)
                       for n in names])
    ref_moved = torch.cat([(state[n].detach().float().cpu()
                            - ref["init"][n]).reshape(-1) for n in names])
    dtheta = ((moved - ref_moved).norm() / ref_moved.norm()).item()
    bound = tol["adam_lr_steps"] * 1e-4 * len(losses)
    log("  %s: %d steps, losses %s (one rank %s; worst rel %.2e, bound "
        "%g), eval %s; step 1's all-reduced gradients within %.2e of the "
        "two halves' sum made in one process (of each tensor's largest "
        "entry, bound %g), within %s of one rank's whole-batch gradients; "
        "the trained parameters within %.2e of one rank's (bound %.1e: %g "
        "lr a step), their move from the seed %.2e of one rank's "
        "(relative norm); launches by rank %s; %.1f s with the ranks' "
        "start-up (%s)"
        % (what, len(losses), ["%.4f" % x for x in losses],
           ["%.4f" % x for x in ref_losses], worst, tol["loss_rel"],
           got["eval"], split_err, tol["split_rel"],
           ", ".join("%s %.2e" % kv for kv in worst_one), param_err, bound,
           tol["adam_lr_steps"], dtheta, got["counts"].tolist(), seconds,
           card))
    if not (split_err <= tol["split_rel"] and param_err <= bound):
        raise AssertionError("%s: gradients %.2e from the halves' sum, "
                             "parameters %.2e from one rank's"
                             % (what, split_err, param_err))


def phase_parallel(dev, card, refs):
    """Phase 15: the runs over several ranks (``parallel/``).  ``refs``:
    phase 4's final_results.txt, phase 6's and 8's (logged, val rows) and
    phase 9's kNN build."""
    from vqa_counterexamples_tpu_torch import parallel
    from vqa_counterexamples_tpu_torch.cli import counterexamples
    from vqa_counterexamples_tpu_torch.engines import cx_engine

    t_phase = time.perf_counter()
    seconds = {}

    # --- (a) NCCL at one rank: the all-reduce captured in the graph ---
    log("== phase 15a: the CX step under NCCL at one rank (data=1)")
    t = time.perf_counter()
    ref = cx_epoch(dev, None)
    with torchrun_env(), parallel.mesh_from_env({"data": 1}, dev) as mesh:
        one = cx_epoch(dev, mesh)
        if one["step"].graphed.capture is not True:
            raise AssertionError("the NCCL step is not captured")
        hold_equal("CX train, NCCL data=1 (captured, all-reduce in the "
                   "graph) vs no mesh",
                   (one["rows"], one["model"], one["state"].optimizer),
                   (ref["rows"], ref["model"], ref["state"].optimizer))
        if one["eval"] != ref["eval"] or one["counts"] != ref["counts"]:
            raise AssertionError("NCCL data=1: eval %s / launches %s, no "
                                 "mesh %s / %s" % (one["eval"],
                                                   one["counts"],
                                                   ref["eval"],
                                                   ref["counts"]))
        launches = {}
        for name, r in (("no mesh", ref), ("NCCL data=1", one)):
            rng = np.random.default_rng(SEED + 2)
            launches[name] = step_profile(
                "CX train step, captured, %s" % name,
                lambda: cx_engine.train_epoch(
                    r["step"], r["state"], r["feats"], r["arrays"], 768,
                    rng=rng, **r["tables"]),
                3, 3, card)["host_launches"]
        extra = launches["NCCL data=1"] - launches["no mesh"]
        log("  host launches a step: %.2f with the all-reduce, %.2f "
            "without (+%.2f; bound 2)" % (launches["NCCL data=1"],
                                          launches["no mesh"], extra))
        if extra > 2:
            raise AssertionError("the all-reduce added %.2f host launches a "
                                 "step" % extra)
    del ref, one
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        counterexamples.main(["--cx_model", "NeuralModel", "--synthetic",
                              "2048", "--z_cache", "--epochs", "1", "--test",
                              "-b", "768", "--seed", str(SEED), "--device",
                              str(dev), "--project_dir", tmp, "--mesh",
                              "data=1"])
        (run,) = os.listdir(os.path.join(tmp, "logs", "cx"))
        with open(os.path.join(tmp, "logs", "cx", run,
                               "final_results.txt")) as f:
            text = f.read()
    log("  cli.counterexamples --mesh data=1 (one spawned NCCL rank): "
        "final_results.txt %s phase 4's: %s"
        % ("equal to" if text == refs["cli"] else "DIFFERS from", text))
    if text != refs["cli"]:
        raise AssertionError("--mesh data=1 changed final_results.txt")
    seconds["15a"] = round(time.perf_counter() - t, 1)

    # --- (b) gloo: the CX flagship on 2 and 4 ranks of cuda:0 ---
    log("== phase 15b: the CX step over gloo ranks on one card")
    t = time.perf_counter()
    ref = cx_epoch(dev, None, parts=2)
    for axes in ({"data": 2}, {"data": 2, "model": 2}):
        got, secs = spawn_ranks(rank_cx, (axes,), int(np.prod(list(
            axes.values()))))
        label = "CX %s" % ",".join("%s=%d" % kv for kv in axes.items())
        hold_to_one_rank(label, got, ref, card, secs)
        log("  %s: %.1f ms a step (eager: %s), the all-reduce of the "
            "gradients alone %.1f ms (%.0f%% of the step) (%s)"
            % (label, got["step_ms"], got["eager"], got["allreduce_ms"],
               100 * got["allreduce_ms"] / got["step_ms"], card))
    del ref
    torch.cuda.empty_cache()
    seconds["15b"] = round(time.perf_counter() - t, 1)

    # --- (c) gloo: VQA pretraining through cli.train --mesh data=2 ---
    log("== phase 15c: VQA pretraining through cli.train --mesh data=2")
    t = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    for label, config, n, batch, key, want in (
            ("MutanNoAtt", os.path.join(root, "configs", "vqa2",
                                        "mutan_noatt_train.yaml"),
             2048, 512, "train_cli", ("gru", "gru_pg", "gru_bwd", "mutan")),
            ("MutanAtt", ATT_CONFIG, 1024, 128, "att_cli",
             ("gru", "gru_pg", "gru_bwd", "mutan", "attmutan",
              "attmutan_bwd"))):
        with tempfile.TemporaryDirectory() as tmp:
            got, secs = spawn_ranks(rank_cli, (
                "vqa_counterexamples_tpu_torch.cli.train",
                ["--path_opt", config, "--synthetic", str(n), "--epochs",
                 "1", "-b", str(batch), "--seed", str(SEED), "--dir_logs",
                 tmp, "--mesh", "data=2"], {"data": 2}, want), 2)
            with open(os.path.join(tmp, "logger.json")) as f:
                logged = json.load(f)["logged"]
            with open(os.path.join(tmp, "results", "val",
                                   "vqa_OpenEnded_mscoco_epoch_1.json")) as f:
                rows = json.load(f)
        ref_logged, ref_rows = refs[key]
        tol = TOL["mesh"]
        for tag, meter in (("train", "loss"), ("val", "loss")):
            held("%s %s %s" % (label, tag, meter),
                 logged[tag][meter]["1"], ref_logged[tag][meter]["1"],
                 tol["loss_rel"])
        same = np.mean([a == b for a, b in zip(rows, ref_rows)])
        steps = got["out"]
        log("  %s (B %d, %d a rank): %d steps; train loss %.4f, val loss "
            "%.4f, acc1 %.3f (one rank %.4f, %.4f, %.3f); %.1f%% of %d val "
            "answers as one rank's (bound %.0f%%); launches by rank %s; "
            "%.1f ms a step (the batch_time meter), an all-reduce of the "
            "parameters %.1f ms; %.1f s in the ranks, %.1f s with their "
            "start-up (%s)"
            % (label, batch, batch // 2, steps, logged["train"]["loss"]["1"],
               logged["val"]["loss"]["1"], logged["val"]["acc1"]["1"],
               ref_logged["train"]["loss"]["1"],
               ref_logged["val"]["loss"]["1"],
               ref_logged["val"]["acc1"]["1"], 100 * same, len(rows),
               100 * tol["answers"], got["counts"].tolist(),
               1e3 * logged["train"]["batch_time"]["1"],
               got["allreduce_ms"], got["seconds"], secs, card))
        if len(rows) != len(ref_rows) or same < tol["answers"]:
            raise AssertionError("%s: %d val rows, %.3f equal to one rank's"
                                 % (label, len(rows), same))
    seconds["15c"] = round(time.perf_counter() - t, 1)

    # --- (d) the sharded kNN build at COCO-train scale ---
    log("== phase 15d: the kNN builder over two ranks (cli.knn --mesh "
        "data=2)")
    t = time.perf_counter()
    from vqa_counterexamples_tpu_torch.data.features import FeatureStore
    from vqa_counterexamples_tpu_torch.data.vqacx import coco_num_to_name

    n, knn_ref = refs["knn"]["idx"].shape[0], refs["knn"]
    with tempfile.TemporaryDirectory() as tmp:
        feats = np.random.default_rng(SEED).standard_normal(
            (n, 2048), dtype=np.float32)
        prefix = os.path.join(tmp, "trainset")
        FeatureStore(feats, [coco_num_to_name(i) for i in range(n)]).save(
            prefix)
        del feats
        got, secs = spawn_ranks(rank_cli, (
            "vqa_counterexamples_tpu_torch.cli.knn",
            ["--path_features", prefix, "-k", "25", "--json-out",
             os.path.join(tmp, "knn.json"), "--mesh", "data=2"],
            {"data": 2}, ("knn",)), 2)
        with open(os.path.join(tmp, "knn.json")) as f:
            text = f.read()
    dist, idx = got["out"]
    equal = (np.array_equal(dist, knn_ref["dist"])
             and np.array_equal(idx, knn_ref["idx"])
             and text == knn_ref["json"])
    log("  %d x 2048 over two ranks (%d and %d rows): indices, distances "
        "and the json %s phase 9's one-rank build; launches by rank %s; "
        "%.2f s in the ranks (one rank, phase 9: %.2f s), %.1f s with "
        "their start-up (%s)"
        % (n, -(-n // 2), n // 2, "bit-equal to" if equal else
           "DIFFERENT from", got["counts"].tolist(), got["seconds"],
           knn_ref["seconds"], secs, card))
    if not equal:
        raise AssertionError("the sharded kNN build differs from one "
                             "rank's: %d indices, %d distances"
                             % ((idx != knn_ref["idx"]).sum(),
                                (dist != knn_ref["dist"]).sum()))
    seconds["15d"] = round(time.perf_counter() - t, 1)

    # --- (e) extraction over two ranks ---
    log("== phase 15e: extraction over two ranks (cli.extract --mesh "
        "data=2)")
    t = time.perf_counter()
    from vqa_counterexamples_tpu_torch.cli import extract

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "160", "-b", "80"]
        one = extract.main(argv + ["--device", str(dev), "--dir_data",
                                   os.path.join(tmp, "one")])
        got, secs = spawn_ranks(rank_cli, (
            "vqa_counterexamples_tpu_torch.cli.extract",
            argv + ["--dir_data", os.path.join(tmp, "two"), "--mesh",
                    "data=2"], {"data": 2}, ()), 2)
        two = got["out"]
        import filecmp

        same = {suffix: filecmp.cmp(one + suffix, two + suffix,
                                    shallow=False)
                for suffix in (".npy", ".att.npy", ".txt")}
    log("  ResNet-152 at 448, 160 synthetic images in batches of 80 (one "
        "a rank): files byte-equal to one rank's: %s; %.1f s in the ranks, "
        "%.1f s with their start-up (%s)"
        % (same, got["seconds"], secs, card))
    if not all(same.values()):
        raise AssertionError("extraction over two ranks changed %s"
                             % [k for k, v in same.items() if not v])
    seconds["15e"] = round(time.perf_counter() - t, 1)
    log("  phase 15: %.1f s (%s)" % (time.perf_counter() - t_phase,
                                     seconds))


# ---------------------------------------------------------------- phase 16

def tree_bits_equal(what, got, want):
    """Two checkpoint trees (numpy / None leaves, nested dicts): the same
    keys and every leaf bit-equal."""
    from vqa_counterexamples_tpu_torch.core.checkpoint import check_tree

    check_tree(got, want, what)
    differ = []

    def walk(a, b, path):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], "%s/%s" % (path, k))
        elif b is not None:
            a, b = np.asarray(a), np.asarray(b)
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                differ.append(path)

    walk(got, want, "")
    n = [0]

    def count(t):
        if isinstance(t, dict):
            for v in t.values():
                count(v)
        elif t is not None:
            n[0] += 1

    count(want)
    log("  %s: %d leaves, %s" % (what, n[0], "bit-equal" if not differ
                                else "DIFFERENT: %s" % differ[:8]))
    if differ:
        raise AssertionError("%s: not bit-equal" % what)


@contextlib.contextmanager
def spied(module, name, after):
    """``module.name`` wrapped: ``after(result, *args, **kwargs)`` runs
    after each call."""
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        after(out, *args, **kwargs)
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, orig)


def want_counts(**counts):
    return {k: counts.get(k, 0) for k in SOURCES}


def require_launches(what, want):
    got = read_counters()
    log("  %s: launches %s" % (what, got))
    if got != want:
        raise AssertionError("%s: launch counts %s, expected %s"
                             % (what, got, want))


def phase_repair(dev, card):
    """16a: with an NCCL group alive, captures with no mesh (the CX step
    at the flagship width and a serving bucket) against eager."""
    from vqa_counterexamples_tpu_torch import parallel
    from vqa_counterexamples_tpu_torch.core import graphs
    from vqa_counterexamples_tpu_torch.data import synthetic
    from vqa_counterexamples_tpu_torch.serve import demo_server

    log("== phase 16a: captures with no mesh in a process with an NCCL "
        "group")
    t = time.perf_counter()
    with torchrun_env(), parallel.mesh_from_env({"data": 1}, dev) as mesh:
        if mesh.backend != "nccl" or graphs.capture_kwargs() != {
                "capture_error_mode": "thread_local"}:
            raise AssertionError("no NCCL group, or global capture mode")
        cap = cx_epoch(dev, None)
        eag = cx_epoch(dev, None, capture=False)
        if not cap["step"].graphed.capture or eag["step"].graphed.capture:
            raise AssertionError("the steps' capture modes are wrong")
        hold_equal("CX train with no mesh beside an NCCL group, captured "
                   "vs eager",
                   (cap["rows"], cap["model"], cap["state"].optimizer),
                   (eag["rows"], eag["model"], eag["state"].optimizer))
        if cap["eval"] != eag["eval"] or cap["counts"] != eag["counts"]:
            raise AssertionError("eval %s / launches %s vs eager %s / %s"
                                 % (cap["eval"], cap["counts"], eag["eval"],
                                    eag["counts"]))
        del cap, eag
        torch.cuda.empty_cache()
        server = demo_server.create_server(["--path_opt", NOATT_CONFIG,
                                            "--port", "0"])
        try:
            engine = server.engine
            options = config_options(NOATT_CONFIG)
            eager = demo_server.DemoEngine(
                options, engine.vqa_model, engine.cnn,
                *synthetic.synthetic_vocab(2000, options["vqa"]["nans"]),
                False, capture=False)
            rng = np.random.default_rng(SEED)
            images = rng.integers(0, 256, (2, 448, 448, 3), dtype=np.uint8)
            wids = rng.integers(1, 2001, (2, 26)).astype(np.int32)
            reset_counters()
            got = engine.predict_prepared(images, wids)
            counts = read_counters()
            want = eager.predict_prepared(images, wids)
            if engine.n_graphs != 2 or not all(
                    np.array_equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("the served bucket differs from eager")
            if counts != want_counts(gru=1, mutan=1):
                raise AssertionError("served bucket launches %s" % counts)
        finally:
            server.server_close()
    log("  serving bucket 2 (GraphedCall) beside the NCCL group: captured "
        "bit-equal to eager, launches %s; 16a %.1f s (%s)"
        % (counts, time.perf_counter() - t, card))
    torch.cuda.empty_cache()


def config_options(path):
    from vqa_counterexamples_tpu_torch.core import config as config_lib

    return config_lib.resolve_options({}, path, {})


def cx_cli_model(seed):
    """The CX CLI's model and data for ``--synthetic 2048`` at the default
    YAML (the flagship widths over the CLI's 100 answers)."""
    from types import SimpleNamespace

    from vqa_counterexamples_tpu_torch.cli import counterexamples
    from vqa_counterexamples_tpu_torch.engines import cx_engine
    from vqa_counterexamples_tpu_torch.models import factory

    data = counterexamples.load_synthetic_data(SimpleNamespace(seed=SEED),
                                               2048)
    trainset = data[0]
    model = factory.cx_from_options(
        "NeuralModel", config_options(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "configs", "cx",
            "counterexamples_default.yaml")), trainset["vocab_words"],
        trainset["vocab_answers"], knn_size=24)
    return cx_engine.init_cx_params(model, seed=seed), data


def phase_cx_resume(dev, card):
    """16b: the CX flagship CLI trains 2 epochs, then ``--resume`` runs
    epoch 3 from the msgpack ``ckpt/``: the loaded state bit-equal to the
    state saved, epoch 3 captured with exact launch counts."""
    from vqa_counterexamples_tpu_torch.cli import counterexamples
    from vqa_counterexamples_tpu_torch.core import checkpoint
    from vqa_counterexamples_tpu_torch.engines import cx_engine

    log("== phase 16b: the CX flagship CLI resumed from its msgpack "
        "checkpoint")
    saved, loaded, steps = [], [], []
    argv = ["--cx_model", "NeuralModel", "--synthetic", "2048", "--z_cache",
            "-b", "768", "--seed", str(SEED), "--device", str(dev),
            "--comment", "resume"]
    with tempfile.TemporaryDirectory() as tmp, \
            spied(checkpoint, "save_cx_checkpoint",
                  lambda _, state, *a, **k: saved.append(
                      checkpoint.cx_state_tree(state))), \
            spied(checkpoint, "load_cx_checkpoint",
                  lambda out, *a, **k: loaded.append(
                      checkpoint.cx_state_tree(out[0]))), \
            spied(cx_engine, "make_cx_train_step",
                  lambda step, *a, **k: steps.append(step)):
        t = time.perf_counter()
        reset_counters()
        counterexamples.main(argv + ["--epochs", "2", "--project_dir", tmp])
        require_launches("2 epochs (3 steps and 1 val batch each)",
                         want_counts(gru=2, vfeat=8, vfeat_bwd=6, mixture=8))
        (run,) = os.listdir(os.path.join(tmp, "logs", "cx"))
        files = sorted(os.listdir(os.path.join(tmp, "logs", "cx", run,
                                               "ckpt")))
        first_s = time.perf_counter() - t
        t = time.perf_counter()
        reset_counters()
        info = counterexamples.main(argv + ["--epochs", "3", "--resume",
                                            run, "--project_dir", tmp])
        require_launches("--resume, epoch 3", want_counts(
            gru=2, vfeat=4, vfeat_bwd=3, mixture=4))
        size = os.path.getsize(os.path.join(tmp, "logs", "cx", run, "ckpt",
                                            "model.ckpt"))
    if files != ["info.ckpt", "model.ckpt"] or len(info) != 3:
        raise AssertionError("run files %s, %d epochs" % (files, len(info)))
    if len(saved) != 3 or len(loaded) != 1 or len(steps) != 2:
        raise AssertionError("%d saves, %d loads, %d train steps"
                             % (len(saved), len(loaded), len(steps)))
    if steps[1].graphed.capture != (dev.type == "cuda") or (
            dev.type == "cuda" and steps[1].graphed.n_graphs < 1):
        raise AssertionError("epoch 3 did not run captured")
    tree_bits_equal("CX state loaded by --resume vs the state saved after "
                    "epoch 2 (params, Adam count / mu / nu, step)",
                    loaded[0], saved[1])
    if int(saved[1]["step"]) != 6 or int(
            saved[1]["opt_state"]["0"]["count"]) != 6:
        raise AssertionError("saved step %s" % saved[1]["step"])
    if not all(np.isfinite(e["loss"]) for e in info):
        raise AssertionError("non-finite val loss %s" % info)
    log("  epochs 1-2 %.1f s, epoch 3 resumed %.1f s (caches, capture, "
        "steps, eval, %.1f MB checkpoint); val %s (%s)"
        % (first_s, time.perf_counter() - t, size / 1e6, info[-1], card))


def vqa_state_trees(state):
    from vqa_counterexamples_tpu_torch.models import to_jax

    return {"model": to_jax.vqa_params(state.model),
            "optim": to_jax.adam_state(state.model, state.optimizer,
                                       to_jax.vqa_params),
            "step": np.asarray(state.step, np.int32)}


def write_vocab(root, words, answers):
    import pickle

    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "wid_to_word.pickle"), "wb") as f:
        pickle.dump({i + 1: w for i, w in enumerate(words)}, f)
    with open(os.path.join(root, "aid_to_ans.pickle"), "wb") as f:
        pickle.dump(list(answers), f)


def phase_vqa_resume(dev, card):
    """16c: MutanNoAtt (B 512) resumed from its msgpack triple (the loaded
    state bit-equal to the saved one); MutanAtt trained by ``cli.train``
    and served from its triple, answers bit-equal to an engine given the
    same weights in memory."""
    from vqa_counterexamples_tpu_torch.cli import train
    from vqa_counterexamples_tpu_torch.core import checkpoint
    from vqa_counterexamples_tpu_torch.data import synthetic
    from vqa_counterexamples_tpu_torch.serve import demo_server

    log("== phase 16c: the VQA triple: MutanNoAtt resumed, MutanAtt served")
    saved, loaded = [], []
    argv = ["--path_opt", NOATT_CONFIG, "--synthetic", "2048", "-b", "512",
            "--seed", str(SEED), "--device", str(dev)]
    with tempfile.TemporaryDirectory() as tmp, \
            spied(checkpoint, "save_vqa_checkpoint",
                  lambda _, info, state, *a, **k: saved.append(
                      vqa_state_trees(state))), \
            spied(checkpoint, "load_vqa_checkpoint",
                  lambda _, state, *a, **k: loaded.append(
                      vqa_state_trees(state))):
        t = time.perf_counter()
        train.main(argv + ["--epochs", "1", "--dir_logs", tmp])
        reset_counters()
        state = train.main(argv + ["--epochs", "2", "--resume", "ckpt",
                                   "--dir_logs", tmp])
        # 4 train steps (per-gate GRU, its backward, MUTAN each) and 4 val
        # batches (the GRU forward and MUTAN each)
        require_launches("MutanNoAtt --resume ckpt, epoch 2", want_counts(
            gru=4, gru_pg=4, gru_bwd=4, mutan=8))
        files = sorted(n for n in os.listdir(tmp) if n.startswith("ckpt_"))
    if files != ["ckpt_info.json", "ckpt_model.msgpack",
                 "ckpt_optim.msgpack"] or state.step != 8:
        raise AssertionError("files %s, step %d" % (files, state.step))
    tree_bits_equal("MutanNoAtt state loaded by --resume vs the state saved "
                    "after epoch 1 (params, Adam, step)", loaded[0],
                    saved[0])
    log("  MutanNoAtt: 2 CLI runs in %.1f s (%s)"
        % (time.perf_counter() - t, card))

    t = time.perf_counter()
    options = config_options(ATT_CONFIG)
    with tempfile.TemporaryDirectory() as tmp:
        state = train.main(["--path_opt", ATT_CONFIG, "--synthetic", "1024",
                            "--epochs", "1", "-b", "128", "--seed",
                            str(SEED), "--device", str(dev), "--dir_logs",
                            os.path.join(tmp, "run")])
        _, _, words, answers = synthetic.make_synthetic_vqa(
            1024, min(options["vqa"]["nans"], 50),
            options["vqa"]["maxlength"], dim_v=options["model"]["dim_v"],
            spatial=True, seed=SEED)
        write_vocab(os.path.join(tmp, "vocab"), words, answers)
        weights = {k: v.detach().clone()
                   for k, v in state.model.state_dict().items()}
        del state
        torch.cuda.empty_cache()
        served = demo_server.create_server([
            "--path_opt", ATT_CONFIG, "--port", "0", "--vocab_path",
            os.path.join(tmp, "vocab"), "--dir_logs",
            os.path.join(tmp, "run")])
        ref = demo_server.create_server([
            "--path_opt", ATT_CONFIG, "--port", "0", "--vocab_path",
            os.path.join(tmp, "vocab")])
        try:
            ref.engine.set_params(weights)
            rng = np.random.default_rng(SEED + 3)
            images = rng.integers(0, 256, (2, 448, 448, 3), dtype=np.uint8)
            wids = rng.integers(1, len(words) + 1, (2, 26)).astype(np.int32)
            reset_counters()
            got = served.engine.predict_prepared(images, wids)
            require_launches("MutanAtt served from the triple, bucket 2",
                             want_counts(gru=1, mutan=1, attmutan=1))
            want = ref.engine.predict_prepared(images, wids)
        finally:
            served.server_close()
            ref.server_close()
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("the served top-5 differ from the engine "
                             "holding the trained weights")
    log("  MutanAtt: cli.train's triple served, top-5 ids / values and "
        "maps of 2 items bit-equal to the engine holding the trained "
        "weights; %.1f s (%s)" % (time.perf_counter() - t, card))
    del served, ref
    torch.cuda.empty_cache()


def reference_names(state_dict):
    """A CX ``state_dict`` of this port with the question encoder in the
    reference's genuine ``BayesianGRUCell`` names (six per-gate Linears,
    the recurrent ones without bias)."""
    out = {}
    for key, value in state_dict.items():
        if ".seq2vec.gru_cell." not in key:
            out[key] = value
            continue
        head, leaf = key.split(".seq2vec.gru_cell.")
        cell = head + ".seq2vec.rnn.gru_cell.weight_"
        side = leaf.split("_")[1]
        gates = ("ir", "ii", "in") if side == "ih" else ("hr", "hi", "hn")
        for gate, part in zip(gates, value.chunk(3, 0)):
            if leaf.startswith("weight"):
                out[cell + gate + ".weight"] = part.clone()
            elif side == "ih":
                out[cell + gate + ".bias"] = part.clone()
            elif part.abs().max() != 0:
                raise AssertionError("the reference's cell has no bias_hh")
    return out


def phase_port_init(dev, card):
    """16d: ``port_checkpoint --kind cx`` on a reference-named state_dict,
    then ``counterexamples --init_params``: the CLI starts from those
    weights; a model loaded from the file scores as the same weights
    loaded directly.  Returns that model and the CLI's val data."""
    from vqa_counterexamples_tpu_torch.cli import (counterexamples,
                                                   port_checkpoint)
    from vqa_counterexamples_tpu_torch.core import checkpoint, msgpack_tree
    from vqa_counterexamples_tpu_torch.data import vqacx
    from vqa_counterexamples_tpu_torch.engines import cx_engine

    log("== phase 16d: port_checkpoint -> --init_params")
    t = time.perf_counter()
    source, data = cx_cli_model(SEED + 7)
    with torch.no_grad():
        source.vqa_model.seq2vec.gru_cell.bias_hh.zero_()
    ref_sd = reference_names(source.state_dict())
    started = []
    with tempfile.TemporaryDirectory() as tmp, \
            spied(checkpoint, "load_cx_params",
                  lambda _, model, *a, **k: started.append(
                      {n: p.detach().cpu().clone()
                       for n, p in model.named_parameters()})):
        torch.save(ref_sd, os.path.join(tmp, "model.ckpt"))
        params = os.path.join(tmp, "params.msgpack")
        port_checkpoint.main(["--src", os.path.join(tmp, "model.ckpt"),
                              "--kind", "cx", "--out", params])
        tree = msgpack_tree.load(params)
        reset_counters()
        counterexamples.main([
            "--cx_model", "NeuralModel", "--synthetic", "2048", "--z_cache",
            "--epochs", "0", "--test", "-b", "768", "--seed", str(SEED),
            "--device", str(dev), "--project_dir", tmp, "--init_params",
            params])
        # --epochs 0: the val and test caches (the GRU once each) and one
        # test batch of 512
        require_launches("--epochs 0 --test --init_params", want_counts(
            gru=2, vfeat=1, mixture=1))
        (run,) = os.listdir(os.path.join(tmp, "logs", "cx"))
        with open(os.path.join(tmp, "logs", "cx", run,
                               "final_results.txt")) as f:
            res = json.loads(f.read())
    (start,) = started
    differ = [n for n, p in source.named_parameters()
              if not torch.equal(start[n], p.detach())]
    if differ:
        raise AssertionError("--init_params started from other weights: %s"
                             % differ[:5])
    from_file, _ = cx_cli_model(SEED)
    checkpoint.load_cx_params(from_file, tree)
    direct = source.to(dev)
    from_file.to(dev)
    _, valset, _, _, f_val = data
    arrays = vqacx.CXArrays.from_examples(valset["examples_list"],
                                          f_val.name_to_index)
    feats = f_val.to_device(dev)
    scores = []
    for model in (from_file, direct):
        q, _, z, _ = cx_engine.build_frozen_caches(model, feats, arrays)
        step = cx_engine.make_cx_eval_step(model, use_z_cache=True,
                                           capture=False)
        scores.append(cx_engine.eval_model(step, feats, arrays, 768,
                                           q_table=q, z_table=z))
    if scores[0] != scores[1] or not np.isfinite(res["loss"]):
        raise AssertionError("scores from the ported file %s, from the "
                             "weights loaded directly %s" % tuple(scores))
    log("  the CLI started from the ported weights (%d tensors bit-equal); "
        "val eval from the file %s == loaded directly; final_results %s; "
        "%.1f s (%s)" % (len(start), scores[0], res,
                         time.perf_counter() - t, card))
    return from_file, arrays, feats, valset


def phase_viz(dev, card, model, arrays, feats, valset):
    """16e: ``rank_for_viz`` on the card against the eval step's sums on
    the same 200 examples; the render (or matplotlib's absence)."""
    from vqa_counterexamples_tpu_torch.data import vqacx
    from vqa_counterexamples_tpu_torch.data.image_fixtures import (
        FIXTURE_DIR, SHAPES)
    from vqa_counterexamples_tpu_torch.engines import cx_engine
    from vqa_counterexamples_tpu_torch.ops.metrics import nll, recall_at_k
    from vqa_counterexamples_tpu_torch.viz import grids

    log("== phase 16e: rank_for_viz and the grids")
    t = time.perf_counter()
    n = 200
    sub = vqacx.CXArrays(*(a[:n] for a in arrays))
    q, _, z, _ = cx_engine.build_frozen_caches(model, feats, sub)
    if not model.wants_table_features():
        raise AssertionError("the vfeat kernel's gate is off")
    reset_counters()
    ranking = grids.rank_for_viz(model, feats, sub, n, q_table=q, z_table=z)
    require_launches("rank_for_viz of %d examples" % n,
                     want_counts(vfeat=1, mixture=1))
    rows, _ = cx_engine.eval_sums(cx_engine.make_cx_eval_step(
        model, use_z_cache=True), feats, sub, n, dict(q_table=q, z_table=z))
    scores = torch.from_numpy(ranking["scores"]).to(dev)
    comp = torch.from_numpy(sub.comp_idxs).to(dev).long()
    mine = [torch.sum(nll(scores, comp)).item(),
            torch.sum(recall_at_k(scores, comp, k=5)).item(),
            torch.sum(recall_at_k(scores, comp, k=1)).item()]
    log("  rank_for_viz's scores: loss sum %.6f, recall@5 %d, recall@1 %d; "
        "the eval step's: %.6f, %d, %d"
        % (mine[0], mine[1], mine[2], *rows[0]))
    if (mine[1:] != [float(x) for x in rows[0][1:]]
            or abs(mine[0] - rows[0][0]) > 1e-5 * abs(rows[0][0])):
        raise AssertionError("rank_for_viz's scores disagree with the eval "
                             "step's")
    if (ranking["order"].shape != (n, 24)
            or ranking["top_aids"].shape != (n, 5, 3)
            or not np.all(np.diff(-np.take_along_axis(
                ranking["scores"], ranking["order"], 1), axis=1) >= 0)):
        raise AssertionError("bad ranking shapes or order")
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "raw")
        os.makedirs(raw)
        few = dict(valset, examples_list=valset["examples_list"][:2])
        for ex in few["examples_list"]:
            for name in [ex["image_name"], ex["comp"]["image_name"],
                         *ex["knns"]]:
                if not os.path.exists(os.path.join(raw, name)):
                    os.symlink(os.path.join(FIXTURE_DIR, SHAPES[0][0]),
                               os.path.join(raw, name))
        two = {k: (v[:2] if v is not None else None)
               for k, v in ranking.items()}
        try:
            import matplotlib  # noqa: F401
            has_mpl = True
        except ImportError:
            has_mpl = False
        try:
            grids.visualize_results(few, two, raw, tmp)
            written = sorted(f for f in os.listdir(tmp)
                             if f.endswith(".jpg"))
            if not has_mpl or written != ["viz_knns_0.jpg", "viz_knns_1.jpg",
                                          "viz_qa0.jpg", "viz_qa1.jpg"]:
                raise AssertionError("the render wrote %s" % written)
            what = "both grids of 2 examples written"
        except ImportError as exc:
            if has_mpl or "matplotlib" not in str(exc):
                raise
            what = "no matplotlib on this host: the render raised %r" % (
                str(exc)[:80],)
    log("  %s; 16e %.1f s (%s)" % (what, time.perf_counter() - t, card))


def phase_approx(dev, card, n=82783):
    """16f: ``--approx``'s route (the plain scores, the TPU's bins) at
    COCO-train scale against the kernel's exact route."""
    from vqa_counterexamples_tpu_torch.ops import topk

    log("== phase 16f: kNN --approx at %d x 2048, k 25" % n)
    feats = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (n, 2048), dtype=np.float32)).to(dev)
    out, secs = {}, {}
    for name, kw in (("kernel", dict(engine="cuda")),
                     ("approx", dict(engine="plain", approx=True)),
                     ("approx again", dict(engine="plain", approx=True))):
        torch.cuda.synchronize()
        reset_counters()
        t = time.perf_counter()
        out[name] = topk.knn(feats, k=25, device=dev, **kw)
        secs[name] = time.perf_counter() - t
        require_launches("kNN %s route" % name, want_counts(
            knn=-(-n // 1024) if name == "kernel" else 0))
    dist, idx = out["approx"]
    if any(a.tobytes() != b.tobytes()
           for a, b in zip(out["approx"], out["approx again"])):
        raise AssertionError("the approx route is not deterministic")
    exact = out["kernel"][1]
    hits = (idx[:, :, None] == exact[:, None, :]).any(2).sum(1)
    recall = hits.sum() / exact.size
    bins = topk.approx_reduction_size(n, 25)
    log("  recall against the kernel's exact result %.6f over %d queries "
        "(%d bins of %d); seconds: approx %.3f / %.3f, kernel %.3f (%s)"
        % (recall, n, bins[0], 1 << bins[1], secs["approx"],
           secs["approx again"], secs["kernel"], card))
    if recall < 0.99 or not (dist[:, 1:] >= dist[:, :-1]).all():
        raise AssertionError("approx recall %.4f" % recall)
    del feats
    torch.cuda.empty_cache()


def phase_ablations(dev, card):
    """16g: the 19-config grid through the CLI, 1 epoch on 512 examples,
    four CLIs at once: rc 0 and a finite val loss each."""
    from vqa_counterexamples_tpu_torch.scripts import run_ablations

    log("== phase 16g: the CX ablation grid (19 configs, 1 epoch, 512 "
        "examples)")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        rows = run_ablations.main(["--epochs", "1", "--synthetic", "512",
                                   "--jobs", "4", "--device", str(dev),
                                   "--timeout", "600", "--project_dir",
                                   tmp])
    for row in rows:
        log("  %s" % json.dumps(row))
    bad = [r["config"] for r in rows if not run_ablations.ok(r)]
    if len(rows) != 19 or bad:
        raise AssertionError("ablation grid: %d rows, failed %s"
                             % (len(rows), bad))
    log("  19 configs rc 0 with finite losses in %.1f s (%s)"
        % (time.perf_counter() - t, card))


def phase_bridge(dev, card):
    """Phase 16: the checkpoint bridge, viz, --approx and the grid."""
    t = time.perf_counter()
    phase_repair(dev, card)
    phase_cx_resume(dev, card)
    phase_vqa_resume(dev, card)
    model, arrays, feats, valset = phase_port_init(dev, card)
    phase_viz(dev, card, model, arrays, feats, valset)
    del model, feats
    torch.cuda.empty_cache()
    phase_approx(dev, card)
    phase_ablations(dev, card)
    log("  phase 16: %.1f s; %s" % (time.perf_counter() - t,
                                    memory_line(card)))


REP_QUESTIONS = 128        # questions an image (phase 17b's fixture)
REP_COMP = 8               # of them shared with the image's pair mate
REP_POOL = 2400            # answer and question words
REP_STAGES = ("preprocess,skipthoughts,extract,knn,train,answer_embedding,"
              "build_vqacx,counterexamples")


def learnable_questions(split, n_images, rng):
    """Phase 17b's VQA2-format records, in the layout of the runbook's
    ``_rehearsal_questions``: ``REP_QUESTIONS`` questions an image, the
    first ``REP_COMP`` shared with its pair mate (other answers), then by
    turns "is there a <word> ?", answered "yes", and "what is the <word>
    near the <word> ?", answered with a word of a pool of ``REP_POOL``:
    each train answer a new word (more than 2,000 answers, so nans 2000
    cuts the tail), each val answer a random one.  The "yes" questions are
    what an epoch learns (the answer follows from the question's first
    word, and from the prior): val acc@1 leaves 0 and the runbook's
    ``best_*`` checkpoint is written."""
    pool = ["w%04d" % i for i in range(REP_POOL)]
    fresh = iter(rng.permutation(REP_POOL))
    questions, annotations, comp_pairs = [], [], []

    def word():
        return pool[int(rng.integers(REP_POOL))]

    def what():
        return pool[int(next(fresh))] if split == "train" else word()

    def add(qid, image_id, text, answer):
        questions.append({"question_id": qid, "image_id": image_id,
                          "question": text})
        occurrence = [{"answer": answer}] * 8 + [{"answer": word()}] * 2
        annotations.append({"question_id": qid,
                            "multiple_choice_answer": answer,
                            "answers": occurrence})

    for a in range(1, n_images, 2):
        for q in range(REP_COMP):
            text = "what is the %s near the %s ?" % (word(), word())
            add(a * 1000 + q, a, text, what())
            add((a + 1) * 1000 + q, a + 1, text, what())
            comp_pairs.append([a * 1000 + q, (a + 1) * 1000 + q])
    for i in range(1, n_images + 1):
        for q in range(REP_COMP, REP_QUESTIONS):
            if q % 2:
                add(i * 1000 + q, i, "is there a %s ?" % word(), "yes")
            else:
                add(i * 1000 + q, i, "what is the %s near the %s ?"
                    % (word(), word()), what())
    return questions, annotations, comp_pairs


def rehearsal_kernel_rows(dev, card):
    """The kernels at the shapes the runbook's ``--rehearsal`` gives them
    (GRU hidden 64 at the VQA batch 16 and the answer embedding's 10
    answers, MUTAN 32 / 32 -> 32 at R 2, the CX head over B 16 x K 24
    candidates at dz 32 and 10 answers, kNN over 32 and 28 rows, k 25),
    each against its plain version (logged, outside the kernels line)."""
    from vqa_counterexamples_tpu_torch.ops.cuda import (
        gru_kernel, knn_kernel, mixture_kernel)

    log("== phase 17: the kernels at the rehearsal's widths")
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    T, B, H = 26, 16, 64
    xp, w_hh = randn(T, B, 3 * H), randn(3 * H, H, scale=H ** -0.5)
    b_hh = randn(3 * H, scale=0.1, dtype=torch.float32)
    keep = torch.rand(3, B, H, generator=gen, device=dev) < 0.75
    mask = (keep * (256.0 / 192)).to(torch.bfloat16)
    rows = {"gru_pg H64": gru_fwd_row("gru_pg H64", xp, w_hh, b_hh, mask,
                                      True),
            "gru H64": gru_fwd_row("gru H64", xp, w_hh, b_hh, None, False),
            "gru H64 B10": gru_fwd_row("gru H64 B10",
                                       xp[:, :10].contiguous(), w_hh, b_hh,
                                       None, False)}
    s1, h1 = gru_kernel.gru_recurrence(xp, w_hh, b_hh, mask, want_hproj=True)
    rows["gru_bwd H64"] = gru_bwd_row("gru_bwd H64", randn, xp, w_hh, mask,
                                      s1, h1)
    rows["mutan R2"] = mutan_row("mutan R2", randn, B, 32, 32, 2, 32)
    M, DZ, A = B * 24, 32, 10
    z, w_cls, b_cls = randn(M, DZ), randn(A, DZ, scale=DZ ** -0.5), randn(A)
    first = mixture_kernel.classify_softmax(z, w_cls, b_cls)
    rows["mixture A10"] = dict(
        max_abs_err=check_close(
            "mixture A10", first,
            mixture_kernel.classify_softmax_plain(z, w_cls, b_cls),
            TOL["mixture"]),
        ms=time_ms(lambda: mixture_kernel.classify_softmax(z, w_cls, b_cls),
                   reps=20),
        plain_ms=time_ms(lambda: mixture_kernel.classify_softmax_plain(
            z, w_cls, b_cls), reps=20),
        work=(2 * M * DZ * A, (M * DZ + A * DZ + A + M * A) * 2))
    check_rerun("mixture A10", first,
                mixture_kernel.classify_softmax(z, w_cls, b_cls))
    for n in (32, 28):
        corpus = torch.randn(n, 2048, generator=gen, device=dev)
        csq = (corpus * corpus).sum(1)
        dist, idx = knn_kernel.knn_chunk(corpus, corpus, 25, csq)
        ref_d, ref_i = knn_kernel.knn_chunk_plain(corpus, corpus, 26, csq)
        name = "knn N%d" % n
        rows[name] = dict(
            max_abs_err=check_knn(name, dist, idx, ref_d, ref_i,
                                  self_idx=torch.arange(n, device=dev),
                                  qnorm=csq.sqrt()),
            ms=time_ms(lambda: knn_kernel.knn_chunk(corpus, corpus, 25,
                                                    csq)),
            plain_ms=time_ms(lambda: knn_kernel.knn_chunk_plain(
                corpus, corpus, 25, csq)),
            work=(3 * 2 * n * n * 2048 + 3 * n * n,
                  (2 * n * 2048 + 2 * n) * 4 + n * 25 * 8,
                  PEAK_TF32_FLOPS))
        check_rerun(name, idx,
                    knn_kernel.knn_chunk(corpus, corpus, 25, csq)[1])
    log_rows(rows, card)
    log("  the rehearsal's shapes: every kernel agrees (%s)" % card)


@contextlib.contextmanager
def quiet():
    """Capture stdout; on an exception, write its tail to the real
    stdout."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            yield out
    except BaseException:
        sys.__stdout__.write(out.getvalue()[-6000:] + "\n")
        raise


def runbook_seconds(out):
    """The stage seconds a runbook run prints (``  <stage>: <s> s``)."""
    import re

    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^  (\w+): ([0-9.]+) s$", out, re.M)}


def phase_rehearsal(dev, card):
    """Phase 17a: the runbook's ``--rehearsal`` as a user runs it, then
    again over its directory."""
    log("== phase 17a: replicate_reference --rehearsal on the card")
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m",
               "vqa_counterexamples_tpu_torch.scripts.replicate_reference",
               "--project_dir", os.path.join(tmp, "proj"), "--rehearsal"]
        for run in ("first run", "rerun"):
            t = time.perf_counter()
            proc = subprocess.run(
                cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=900)
            seconds = time.perf_counter() - t
            ran = [line for line in proc.stdout.splitlines()
                   if line.startswith("+ ")]
            ok = (proc.returncode == 0 and proc.stdout.rstrip().endswith(
                "replication complete") and (run == "first run") == bool(
                    ran))
            log("  %s: rc %d, %d CLIs, %.1f s; stages %s%s (%s)"
                % (run, proc.returncode, len(ran), seconds,
                   runbook_seconds(proc.stdout),
                   "".join("; " + line for line in proc.stdout.splitlines()
                           if line.startswith("FINAL:")), card))
            if not ok:
                log(proc.stdout[-6000:])
                log(proc.stderr[-6000:])
                raise AssertionError("replicate_reference --rehearsal: %s "
                                     "failed" % run)


def phase_runbook_full_width(dev, card):
    """Phase 17b: the runbook's stages at the published widths, in this
    process, each CLI's launches counted."""
    import importlib
    import pickle
    import threading

    from vqa_counterexamples_tpu_torch.scripts import (
        replicate_reference as rr)

    log("== phase 17b: the runbook at full width, in-process")
    torch.cuda.reset_peak_memory_stats()
    calls = []

    def run_cli(module, args):
        main = importlib.import_module(
            "vqa_counterexamples_tpu_torch.cli." + module).main
        # the threads the CLI starts (the train CLI's eval_res scoring),
        # not those earlier phases left running (the servers' batchers)
        before = set(threading.enumerate())
        reset_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with quiet():
            main(args)
            for thread in set(threading.enumerate()) - before:
                thread.join(timeout=300)
        torch.cuda.synchronize()
        calls.append((module, args, time.perf_counter() - t,
                      read_counters()))

    # the full-scale knobs but 32 / 28 images, 1 epoch each and the
    # rehearsal's thresholds
    knob = dict(n_train_images=32, n_val_images=28, vqa_epochs=1,
                cx_epochs=1, min_vqa_acc=0.0, min_r1=0.0, min_r5=0.0,
                min_train_examples=3000,
                max_train_examples=32 * REP_QUESTIONS,
                min_cx_examples=4, max_cx_examples=1000)
    with tempfile.TemporaryDirectory() as root:
        P = rr.knobs(root, **knob)
        t = time.perf_counter()
        with quiet():
            rr.write_fixtures(P, questions=learnable_questions)
        log("  fixture (32 / 28 images, %d questions each, skip-thoughts "
            "at %d, the fake fbresnet152): %.1f s"
            % (REP_QUESTIONS, P.dim_q, time.perf_counter() - t))
        argv = ["--project_dir", root, "--stages", REP_STAGES]
        with quiet() as out:
            P = rr.main(argv, run_cli=run_cli, overrides=knob)
        text = out.getvalue()
        if not text.rstrip().endswith("replication complete"):
            raise AssertionError("the runbook did not complete")

        def count(name):
            with open(name, "rb") as f:
                return len(pickle.load(f))

        n_train = count(os.path.join(P.processed, "trainset.pickle"))
        n_val = count(os.path.join(P.processed, "valset.pickle"))
        with open(os.path.join(P.processed, "aid_to_ans.pickle"), "rb") as f:
            answers = pickle.load(f)
        with open(os.path.join(P.processed, "wid_to_word.pickle"),
                  "rb") as f:
            vocab = set(pickle.load(f).values())
        covered = sum(all(w in vocab for w in a.split()) for a in answers)
        n_cx = {}
        for split in ("train", "val"):
            with open(os.path.join(P.cx_data, "%sset_augmented.pickle"
                                   % split), "rb") as f:
                n_cx[split] = len(pickle.load(f)["examples_list"])
        steps, val_batches = n_train // P.vqa_batch, n_val // P.vqa_batch
        cx_batch = config_options(os.path.join(
            root, "cx_replication.yaml"))["optim"]["batch_size"]
        cx_steps = -(-n_cx["train"] // cx_batch)
        want = {
            "knn": {"knn": 1},
            "train": {"gru_pg": steps, "gru_bwd": steps,
                      "mutan": steps + val_batches, "gru": val_batches},
            "build_answer_embedding": {"gru": -(-covered // 128)},
            # q caches for train, val and the test pass; the fused head
            # once a train step and an eval batch (val and test)
            "counterexamples": {"gru": 3, "mixture": cx_steps + 2 * -(
                -n_cx["val"] // cx_batch)}}
        bad = []
        for module, args, seconds, launches in calls:
            expect = {k: want.get(module, {}).get(k, 0) for k in SOURCES}
            split = [args[i + 1] for i, a in enumerate(args)
                     if a in ("--split", "--data_split")]
            log("  %-22s %6.2f s; launches %s"
                % (" ".join([module] + split), seconds,
                   {k: n for k, n in launches.items() if n}))
            if launches != expect:
                bad.append((module, launches, expect))
        with open(os.path.join(P.dir_logs_vqa, "logger.json")) as f:
            acc = json.load(f)["logged"]["val"]["acc1"]
        log("  %d answers, %d of %d train questions kept, %d val; %d "
            "answers covered; %d VQA steps, %d val batches, val acc@1 %s; "
            "augmented %d train / %d val, %d CX steps; %s"
            % (len(answers), n_train, 32 * REP_QUESTIONS, n_val, covered,
               steps, val_batches, acc, n_cx["train"], n_cx["val"],
               cx_steps, [line for line in text.splitlines()
                          if line.startswith("FINAL:")]))
        log("  stage seconds: %s (%s)" % (runbook_seconds(text), card))
        log("  phase 17b: " + memory_line(card))
        if bad:
            raise AssertionError("runbook launch counts (got, expected): %s"
                                 % bad)
        launched = {k for _, _, _, c in calls for k, n in c.items() if n}
        missing = {"gru", "gru_pg", "gru_bwd", "mutan", "knn",
                   "mixture"} - launched
        if missing or not os.path.isfile(os.path.join(
                P.dir_logs_vqa, "best_model.msgpack")):
            raise AssertionError("runbook: %s never launched, or no "
                                 "best_model.msgpack" % sorted(missing))
        # the rerun: every stage skipped, the final results verified again
        calls.clear()
        with quiet() as out:
            rr.main(argv, run_cli=run_cli, overrides=knob)
        if calls or "FINAL:" not in out.getvalue():
            raise AssertionError("the runbook's rerun ran %s"
                                 % [c[0] for c in calls])
        log("  rerun over the same directory: no CLI ran, the final "
            "results verified again")


def phase_replicate(dev, card):
    """Phase 17: the replication runbook on the card."""
    t = time.perf_counter()
    rehearsal_kernel_rows(dev, card)
    phase_rehearsal(dev, card)
    phase_runbook_full_width(dev, card)
    log("  phase 17: %.1f s (%s)" % (time.perf_counter() - t, card))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log("card: %s; torch %s, CUDA %s" % (card, torch.__version__,
                                          torch.version.cuda))
    t0 = time.perf_counter()
    rows = phase_kernels(dev, card)
    _, ctx = phase_slice(dev, card)
    launches = phase_train(dev, card, ctx)
    refs = {"cli": phase_cli(dev, card)}
    del ctx
    launches_pre = phase_pretrain(dev, card)
    refs["train_cli"] = phase_train_cli(dev)
    launches_att = phase_att_pretrain(dev, card)
    refs["att_cli"] = phase_att_cli(dev)
    launches_knn, refs["knn"] = phase_knn(dev, card)
    phase_trainable(dev, card)
    phase_zoo(dev, card)
    phase_realdata(dev, card)
    phase_serve(dev, card)
    phase_mlb(dev, card)
    phase_parallel(dev, card, refs)
    phase_bridge(dev, card)
    phase_replicate(dev, card)
    log("total %.1f s" % (time.perf_counter() - t0))
    # launches: each kernel's path; the CX training path (phase 3) runs
    # gru, vfeat, vfeat_bwd and mixture, MutanNoAtt pretraining (phase 5)
    # gru_pg, gru_bwd and mutan, MutanAtt pretraining (phase 7) the folded
    # MUTAN kernels, the kNN builder (phase 9) knn
    path = dict(gru_pg=launches_pre, gru_bwd=launches_pre,
                mutan=launches_pre, attmutan=launches_att,
                attmutan_bwd=launches_att, knn=launches_knn)
    on_path = {k: path.get(k, launches)[k] for k in SOURCES}
    # library_ms: the one PyTorch call that computes the same function,
    # where there is one (mixture's linear + softmax), the vfeat rows'
    # cuBLAS products on pre-gathered operands (their yardstick), else null
    kernels = [dict(name=name, route="cuda",
                    source="vqa_counterexamples_tpu_torch/csrc/%s.cu"
                    % SOURCES[name], replaces=REPLACES[name],
                    launches=on_path[name],
                    library_ms=rows[name].pop("library_ms", None),
                    **rows[name])
               for name in SOURCES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
