"""Where the time of the NeuralCX train step and eval goes, on one card.

    python -m vqa_counterexamples_tpu_torch.cli.profile_cx \\
        [--epochs 3] [--path_opt configs/cx/neuralcx_trainable_vqa.yaml] \\
        [--out logs/profile_cx.json]

Builds the flagship configuration (``models.factory.flagship_cx``; 2048
synthetic examples over 1024 images, 2000 answers, B 768, random weights
from ``--seed``) under the bf16 policy, the q/z caches bf16-resident, and
warms up.  With ``--path_opt`` the NeuralCX model is the YAML's, built
through ``core/config`` and the factory as the CX CLI builds it (with
``cx_model.trainable_vqa`` no cache: the backbone trains in the step).
Then it times ``--epochs`` passes of ``train_epoch`` (dropout 0.25, Adam
at 1e-4) and of ``eval_model`` over the 2048 examples on the host clock
(synchronised at both ends), runs them again under ``torch.profiler``, and
reports per batch (3 batches a pass), for the steps the CLI runs (captured
CUDA graphs: ``train_step``, ``eval_batch``) and beside them for the same
steps run eagerly (``train_step_eager``, ``eval_batch_eager``, each from
its own copy of the starting state):

- wall ms (unprofiled); of it, the host's ms until the last call returns
  (per batch) and the ms the card then still needs to drain its queue
  (once): a drain near 0 means the host, not the card, sets the pace;
- the profiled wall ms;
- device-busy ms: the union of the kernels' intervals;
- the device's idle share of the profiled wall time;
- kernel launches on the device, and the host's launch calls (kernel
  launches, graph launches and copies issued through the CUDA runtime),
  by name;
- device time by kernel group (the port's CUDA kernels by name, GEMMs,
  Adam, the rest) and by the top kernels;
- ``torch.cuda.max_memory_allocated`` over the run.

Needs a card: it refuses to run without one.  The JSON report goes to
``--out``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import time

import numpy as np
import torch

GROUPS = (("vfeat_bwd", ("vfeat_bwd",)), ("vfeat_fwd", ("vfeat_fwd",)),
          ("mixture", ("mixture",)), ("gru_bwd", ("gru_bwd",)),
          ("gru", ("gru_",)), ("mutan", ("mutan",)),
          ("conv", ("fprop", "cudnn", "conv2d", "implicit_convolve")),
          ("gemm", ("gemm", "cutlass", "xmma", "cublas", "sm90_", "sm80_")),
          ("adam", ("adam", "foreach", "multi_tensor")),
          ("memcpy/memset", ("memcpy", "memset")))


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise/reduce/other"


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms (us input)."""
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


# the host's calls that put work on the card's queue
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")


def profile_calls(fn, calls: int, per_call: int) -> dict:
    """Time ``calls`` calls of ``fn`` unprofiled, then profile as many;
    numbers per batch (``per_call`` batches a call)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    steps = calls * per_call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t_host = time.perf_counter()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    timing = {"wall_ms": (t_end - t0) / steps * 1e3,
              "host_ms": (t_host - t0) / steps * 1e3,
              "drain_ms": (t_end - t_host) * 1e3}
    # the tracer starts on a one-kernel warm-up step whose records are
    # discarded: a window opened on the calls themselves lost the record of
    # one of their first kernels (an H100, the CX step's vfeat forward)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) / steps * 1e3
    # device events, less the ranges the profiler mirrors onto the device
    # timeline for annotations (e.g. Optimizer.step): kernels and copies
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = _busy_ms((e.time_range.start, e.time_range.end)
                    for e in kernels) / steps
    by_group, by_name, launches = {}, {}, {}
    for e in kernels:
        launches[e.name] = launches.get(e.name, 0) + 1
        ms = (e.time_range.end - e.time_range.start) / 1e3 / steps
        by_group[_group(e.name)] = by_group.get(_group(e.name), 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    host = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name.split("_v")[0] in HOST_LAUNCHES):
            name = e.name.split("_v")[0]
            host[name] = host.get(name, 0) + 1
    return {**timing, "wall_ms_profiled": wall_prof,
            "device_busy_ms": busy,
            "idle_share_profiled": 1.0 - busy / wall_prof,
            "launches": len(kernels) / steps,
            "kernel_launches": launches,
            "host_launches": sum(host.values()) / steps,
            "host_launches_by_call": {k: v / steps for k, v in
                                      sorted(host.items())},
            "device_ms_by_group": dict(sorted(by_group.items(),
                                              key=lambda kv: -kv[1])),
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--path_opt", default=None,
                        help="a CX options YAML whose NeuralCX to profile "
                             "(default: the flagship configuration)")
    parser.add_argument("--out", default="logs/profile_cx.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_cx: no CUDA device visible")
    os.environ["VQACX_COMPUTE_DTYPE"] = "bfloat16"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ..core import config
    from ..data import synthetic, vqacx
    from ..engines import cx_engine
    from ..models import factory

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    batch_size = 768
    dataset, store = synthetic.make_synthetic_cx(
        n_examples=2048, n_images=1024, dim_v=2048, knn_size=24,
        n_answers=2000, seed=args.seed)
    arrays = vqacx.CXArrays.from_examples(dataset["examples_list"],
                                          dataset["name_to_index"])
    words, answers = dataset["vocab_words"], dataset["vocab_answers"]
    if args.path_opt:
        model = factory.cx_from_options(
            "NeuralModel", config.resolve_options({}, args.path_opt), words,
            answers)
    else:
        model = factory.flagship_cx(words, answers)
    model = cx_engine.init_cx_params(model, seed=args.seed).to(dev)
    features = store.to_device(dev)
    use_z = not model.trainable_vqa
    feats, q, z = features, None, None
    if use_z:
        q, _, z, _ = cx_engine.build_frozen_caches(model, features, arrays)
        feats, q, _, z = cx_engine.make_tables_bf16_resident(features, q,
                                                             None, z)
    per_pass = -(-arrays.size // batch_size)
    report = {"card": card, "batch_size": batch_size,
              "examples": arrays.size, "passes": args.epochs,
              "path_opt": args.path_opt,
              "trainable_vqa": model.trainable_vqa}
    torch.cuda.reset_peak_memory_stats()
    for suffix, capture in (("", None), ("_eager", False)):
        m = copy.deepcopy(model)
        state = cx_engine.init_cx_state(m, lr=1e-4)
        train_step = cx_engine.make_cx_train_step(
            m, state.optimizer, base_seed=args.seed, use_z_cache=use_z,
            capture=capture)
        eval_step = cx_engine.make_cx_eval_step(m, use_z_cache=use_z,
                                                capture=capture)
        rng = np.random.default_rng(args.seed)

        def train_pass():
            cx_engine.train_epoch(train_step, state, feats, arrays,
                                  batch_size, rng=rng, q_table=q, z_table=z)

        def eval_pass():
            cx_engine.eval_model(eval_step, feats, arrays, batch_size,
                                 q_table=q, z_table=z)

        for fn in (train_pass, eval_pass):
            fn()
        report["train_step" + suffix] = profile_calls(train_pass,
                                                      args.epochs, per_pass)
        report["eval_batch" + suffix] = profile_calls(eval_pass,
                                                      args.epochs, per_pass)
    report["max_memory_allocated_mib"] = (torch.cuda.max_memory_allocated()
                                          / 2 ** 20)
    out = json.dumps(report, indent=1)
    print(out)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(out + "\n")
    return report


if __name__ == "__main__":
    main()
